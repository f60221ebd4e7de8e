"""VGG feature extractor and its weights."""
