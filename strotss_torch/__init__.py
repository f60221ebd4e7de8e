"""PyTorch/CUDA port of STROTSS style transfer.

The JAX package ``strotss_tpu`` is the reference; this package holds its
counterpart module by module and runs the default stylization on an
NVIDIA H100, with hand-written CUDA kernels (``csrc/``) for REMD, the
self-similarity loss and VGG block1. See README.md, section "PyTorch/CUDA port".
"""

from strotss_torch.api import stylize
from strotss_torch.config import StrotssConfig

__all__ = ["StrotssConfig", "stylize"]
