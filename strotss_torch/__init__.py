"""PyTorch/CUDA port of STROTSS style transfer.

The JAX package ``strotss_tpu`` is the reference; this package holds its
counterpart module by module and runs the default stylization on an
NVIDIA H100, with hand-written CUDA kernels (``csrc/``) for REMD, the
self-similarity loss, VGG block1 and the streamed Sinkhorn pass. Batched
pairs are ``strotss_torch.parallel.stylize_batch`` and the serving loop
``python -m strotss_torch.serve``. See README.md, section "PyTorch/CUDA
port".
"""

from strotss_torch.api import stylize
from strotss_torch.config import StrotssConfig

__all__ = ["StrotssConfig", "stylize"]
