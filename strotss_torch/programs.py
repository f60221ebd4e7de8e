"""One optimization step and its pieces, the counterpart of
``strotss_tpu/programs.py`` (lines 48-136, 200-235, 505-539, 605-675).

A step folds the Laplacian pyramid into the image, runs VGG with the
STROTSS taps, samples content and prediction rows of the hypercolumn at
shared strided-grid coordinates, computes the content loss
(self-similarity) and the style loss (moments against the hoisted target
statistics, a transport term on cosine distance and one with the 'both'
distance on YUV: REMD, or Sinkhorn under ``use_sinkhorn``), takes the
gradient back to the pyramid and applies RMSprop. Under region masks the
losses are computed per region, each with its own coordinates and style
targets, and averaged. PyTorch runs eagerly, so the JAX package's
per-scale compiled programs become a Python loop over steps (and over
regions).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch

from strotss_torch.config import StrotssConfig
from strotss_torch.models.vgg import STROTSS_DEFAULT_TAPS, VGG
from strotss_torch.ops.image import (
    fold_laplacian_pyramid,
    make_laplacian,
    make_laplacian_pyramid,
    resize_bilinear,
)
from strotss_torch.ops.losses import content_loss, style_loss
from strotss_torch.ops.sampling import sample_paired


class StepSpec(NamedTuple):
    """Static configuration of one optimization step.

    ``remd_impl`` and ``selfsim_impl`` select the loss implementations:
    ``'auto'`` (the CUDA kernels on a CUDA device, the plain versions on
    the CPU), ``'plain'`` or ``'kernel'``; under ``use_sinkhorn``
    ``remd_impl`` is the Sinkhorn route (``'auto'``: the memory gate;
    ``'plain'``: materialized at every size). ``block1_impl`` is VGG
    block1's route for the run's device, ``'pallas'`` (fused, kernel K3)
    or ``'xla'`` (``F.conv2d``).
    """

    sample_size: int
    vgg_type: str
    taps: tuple
    preprocess_mode: str
    compute_dtype: str
    use_sinkhorn: bool
    sinkhorn_lambda: float
    sinkhorn_iters: int
    remd_impl: str
    selfsim_impl: str
    block1_impl: str


def _block1_route(cfg: StrotssConfig, device) -> str:
    """VGG block1's route for a run on ``device``: 'pallas' or 'xla'.

    As in the JAX package (``strotss_tpu/programs.py:98-101``), the fused
    route needs the bf16 policy. The port's own rule for ``'auto'``: the
    fused kernel on a CUDA device with ``use_pallas`` set, ``F.conv2d`` on
    the CPU and under ``use_pallas=False``. ``'pallas'`` forces the fused
    route (on the CPU, its plain version) and ``'xla'`` forces
    ``F.conv2d``.
    """
    b1 = cfg.block1_impl
    if b1 not in ("auto", "xla", "pallas"):
        raise ValueError("block1_impl must be 'auto', 'xla' or 'pallas', "
                         f"got {b1!r}")
    if cfg.compute_dtype != "bfloat16":
        return "xla"
    if b1 == "auto":
        cuda = torch.device(device).type == "cuda"
        return "pallas" if (cuda and cfg.use_pallas) else "xla"
    return b1


def spec_from_config(cfg: StrotssConfig, device="cpu",
                     masked: bool = False) -> StepSpec:
    """The step's static configuration for a run on ``device``.

    A masked Sinkhorn run takes the materialized Sinkhorn with its
    unrolled gradient at every size, as the JAX package's masked path does
    (``strotss_tpu/programs.py:88``): crossing the memory gate would
    change the gradient estimator and so the result. A Sinkhorn step runs
    no REMD, so ``remd_impl`` carries that route; self-similarity, and
    REMD on a masked run without Sinkhorn, keep their kernels, since any
    route computes the same function.
    """
    impl = "auto" if cfg.use_pallas else "plain"
    return StepSpec(
        sample_size=cfg.sample_size,
        vgg_type=cfg.vgg_type,
        taps=tuple(cfg.taps or STROTSS_DEFAULT_TAPS),
        preprocess_mode="keras" if cfg.use_keras_weight else "norm",
        compute_dtype=cfg.compute_dtype,
        use_sinkhorn=cfg.use_sinkhorn,
        sinkhorn_lambda=cfg.sinkhorn_lambda,
        sinkhorn_iters=cfg.sinkhorn_iters,
        remd_impl="plain" if masked and cfg.use_sinkhorn else impl,
        selfsim_impl=impl,
        block1_impl=_block1_route(cfg, device),
    )


def set_precision(spec: StepSpec) -> None:
    """Float32 matmuls in full float32 everywhere: no TF32 on the card and
    no bf16 or TF32 through oneDNN on the CPU ('highest' pins both).
    Convolutions in full float32 under ``compute_dtype='float32'`` (the JAX
    package's HIGHEST); under the bf16 policy block1's float32 convolutions
    on the 'xla' route may use TF32, the counterpart of the JAX package's
    DEFAULT precision there (the fused route rounds its operands to bf16
    itself). These are process-wide PyTorch switches."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = spec.compute_dtype == "bfloat16"


class RMSprop:
    """Keras/optax RMSprop: ``v <- rho v + (1-rho) g^2``,
    ``p <- p - lr * g / sqrt(v + eps)`` with eps INSIDE the square root
    (``torch.optim.RMSprop`` computes ``sqrt(v) + eps``). Slots start at
    zero; the solver makes a new one each scale, as the reference does.
    Updates the parameters in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 rho: float = 0.99, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.rho, self.eps = lr, rho, eps
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g, nu in zip(self.params, grads, self.nu):
            nu.copy_((1 - self.rho) * (g * g) + self.rho * nu)
            p.add_((g * torch.rsqrt(nu + self.eps)) * (-self.lr))


def extract_hypercolumn(vgg: VGG, img: torch.Tensor) -> List[torch.Tensor]:
    """Image -> hypercolumn list [image, tap1..tapK]."""
    return [img] + vgg(img)


def scale_seed(mode: str, chw, shw, levels: int, content, style, prev):
    """Per-scale init: resize the inputs, build the Laplacian seed, split
    it into pyramid variables. ``mode`` is 'first' (content Laplacian plus
    the style's mean colour), 'mid' (resized previous result plus content
    Laplacian) or 'last' (resized previous result)."""
    scl_c = resize_bilinear(content, chw)
    scl_s = resize_bilinear(style, shw)
    lap = make_laplacian(scl_c)
    if mode == "first":
        sty = lap + torch.mean(scl_s, dim=(1, 2), keepdim=True)
    elif mode == "mid":
        sty = resize_bilinear(prev, chw) + lap
    else:
        sty = resize_bilinear(prev, chw)
    return scl_c, scl_s, make_laplacian_pyramid(sty, levels)


def step_losses(spec: StepSpec, content_feats, pred, style_targets,
                style_moments, alpha: float, coords: torch.Tensor):
    """(loss, loss_c, loss_s) of one step at the given sample coords.

    One entry a region: (K, n, 2) ``coords``, (K, n, C) ``style_targets``
    and K ``style_moments`` (K = 1 without masks). ``loss_c`` and
    ``loss_s`` are the regions' means, and the loss
    sum_k (alpha lc_k + ls_k) / (K denom)
    (``strotss_tpu/programs.py:663-675``).
    """
    denom = 2.0 + alpha + 1.0 / max(alpha, 1.0)
    k = coords.shape[0]
    lc = ls = 0.0
    for xy, target, tmom in zip(coords, style_targets, style_moments):
        c_feat, p_feat = sample_paired(xy, content_feats, pred)
        lc = lc + content_loss(c_feat, p_feat, impl=spec.selfsim_impl) / k
        ls = ls + style_loss(target, p_feat, alpha,
                             use_sinkhorn=spec.use_sinkhorn,
                             sinkhorn_lambda=spec.sinkhorn_lambda,
                             sinkhorn_iters=spec.sinkhorn_iters,
                             remd_impl=spec.remd_impl,
                             target_moments=tmom) / k
    return (alpha * lc + ls) / denom, lc, ls


def optimization_steps(spec: StepSpec, n_steps: int, vgg: VGG, content_feats,
                       style_targets, style_moments, alpha: float, pyramid,
                       opt: RMSprop, coords_fn: Callable[[int], torch.Tensor]):
    """``n_steps`` (>= 1) of sample -> VGG -> losses -> grad -> RMSprop.

    ``pyramid`` (a list of leaf tensors) is updated in place; the per-step
    (loss, loss_c, loss_s) rows come back as one (n_steps, 3) tensor on the
    run's device, so the loop never waits for the card. ``style_moments``
    are the targets' :func:`moment_stats`, hoisted out of the loop; the
    targets, moments and ``coords_fn``'s coordinates have one entry per
    region (:func:`step_losses`).
    """
    rows = []
    for t in range(n_steps):
        coords = coords_fn(t)
        leaves = [p.requires_grad_(True) for p in pyramid]
        img = fold_laplacian_pyramid(leaves)
        pred = extract_hypercolumn(vgg, img)
        loss, lc, ls = step_losses(spec, content_feats, pred, style_targets,
                                   style_moments, alpha, coords)
        grads = torch.autograd.grad(loss, leaves)
        opt.step(grads)
        rows.append(torch.stack([loss, lc, ls]).detach())
    return torch.stack(rows)
