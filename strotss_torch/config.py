"""Configuration of one stylization run.

The port's own copy of ``strotss_tpu/config.py``'s ``StrotssConfig``, with
the same fields and defaults (a test holds them equal). Importing the JAX
package's module would import JAX, so the port keeps this copy.
``shard_samples`` splits the transport losses' style samples, REMD's or
Sinkhorn's, over a mesh's 'sample' axis; ``shard_spatial`` splits one
stylization's VGG stack by image height over its 'spatial' axis
(:mod:`strotss_torch.parallel.spatial`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StrotssConfig:
    """All knobs for one stylization run (see ``strotss_tpu.StrotssConfig``).

    Reference-parity fields: ``lr`` (RMSprop learning rate), ``levels``
    (coarse-to-fine scales), ``max_iter`` (steps per scale), ``alpha``
    (content weight, scaled x16 internally), ``max_size`` (cap on the long
    edge), ``use_keras_weight`` (Keras ImageNet weights and caffe
    preprocessing).
    """

    # --- reference CLI surface -------------------------------------------
    lr: float = 2e-3
    levels: int = 4
    max_iter: int = 200
    alpha: float = 1.0
    max_size: Optional[int] = None
    use_keras_weight: bool = False

    # --- model -----------------------------------------------------------
    vgg_type: str = "16"
    #: VGG tap layers; None = the 9 STROTSS defaults.
    taps: Optional[tuple] = None
    sample_size: int = 1024
    pyramid_levels: int = 5

    # --- knobs beyond the reference ----------------------------------------
    #: skip the coarsest ``start_level`` scales (alpha still halves on
    #: each); with an ``init_image``, a refinement pass
    start_level: int = 0
    #: recompute VGG activations in the backward pass
    #: (``torch.utils.checkpoint``): less memory, one more forward a step
    remat: bool = False
    #: dtype for the VGG conv path; losses always run in float32.
    compute_dtype: str = "bfloat16"
    #: steps between progress reports (the JAX package's scan chunk size)
    log_every: int = 200
    #: base seed of the sampling generators
    seed: int = 0
    #: the JAX package's AOT precompile switch; nothing to compile ahead
    #: here, so the port ignores it
    precompile: bool = True
    #: run the hand-written kernels ('auto' on CUDA tensors); False takes
    #: the plain PyTorch versions
    use_pallas: bool = True
    #: VGG block1 route: 'auto' (the fused CUDA kernel K3 on a card under
    #: the bf16 policy and use_pallas, F.conv2d otherwise), 'pallas' (fused;
    #: its plain version on the CPU) or 'xla' (F.conv2d)
    block1_impl: str = "auto"
    #: torch.profiler trace directory (the CLI traces the run into it)
    profile_dir: Optional[str] = None
    #: dump intermediate stylized images every N steps (0 = off)
    save_every: int = 0
    #: checkpoint directory: the state is saved after every chunk, and a
    #: run of the same configuration resumes from it
    checkpoint_dir: Optional[str] = None
    #: Sinkhorn transport instead of REMD
    use_sinkhorn: bool = False
    sinkhorn_lambda: float = 10.0
    sinkhorn_iters: int = 30
    #: split REMD's style samples over the mesh's 'sample' axis (needs
    #: ``mesh=``)
    shard_samples: bool = False
    #: split the VGG stack (forward and backward) by image height over the
    #: mesh's 'spatial' axis, with halo exchanges (needs ``mesh=``; single
    #: pairs only, ``stylize``); composes with ``shard_samples`` on a 2-D
    #: ('spatial', 'sample') mesh
    shard_spatial: bool = False

    def scale_sizes(self) -> list:
        """The coarse-to-fine long-edge schedule: 64, 128, 256, 512, ..."""
        return [2 << (5 + i) for i in range(self.levels)]

    def initial_alpha(self) -> float:
        """alpha * 16, x3500 in keras-weight mode."""
        return self.alpha * 16.0 * (3500.0 if self.use_keras_weight else 1.0)
