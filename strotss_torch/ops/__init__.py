"""Ops of the PyTorch port: image, losses, sampling, and the CUDA kernels."""
