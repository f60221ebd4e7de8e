"""Image I/O, logging and timing."""
