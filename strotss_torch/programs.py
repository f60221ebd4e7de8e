"""One optimization step and its pieces, the counterpart of
``strotss_tpu/programs.py`` (lines 48-136, 159-236, 287-317, 505-539,
605-675).

A step folds the Laplacian pyramid into the image, runs VGG with the
STROTSS taps, samples content and prediction rows of the hypercolumn at
shared strided-grid coordinates, computes the content loss
(self-similarity) and the style loss (moments against the hoisted target
statistics, a transport term on cosine distance and one with the 'both'
distance on YUV: REMD, or Sinkhorn under ``use_sinkhorn``), takes the
gradient back to the pyramid and applies RMSprop. Under region masks the
losses are computed per region, each with its own coordinates and style
targets, and averaged. A batched step (:func:`batch_steps`) runs VGG once
on B pairs' images and sums the pairs' losses. PyTorch runs eagerly, so
the JAX package's per-scale compiled programs become a Python loop over
steps (and over regions and pairs).

Under ``shard_samples`` both transport terms, REMD or Sinkhorn, split
their samples over the mesh's 'sample' ranks
(:mod:`strotss_torch.parallel.transport`): REMD the prediction's rows,
K1 running on each rank's shard as (targets, prediction shard), the
unsharded step's operand order, so that each rank's distances and
argmins are the unsharded K1's columns bit for bit; Sinkhorn the style
targets' rows, the materialized cost matrix's rows on each rank; the
content loss (K2a, K2b) and the moments stay whole on every rank, since
K2a has no row-range interface. The JAX package forces its plain XLA
losses under sharding (``strotss_tpu/programs.py:111-118``); the port
keeps its REMD and self-similarity kernels, which run on one rank's
tensors and compute the same function, and takes the materialized
Sinkhorn, whose gradient is the reference's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from strotss_torch import graphs
from strotss_torch.config import StrotssConfig
from strotss_torch.models.vgg import STROTSS_DEFAULT_TAPS, VGG
from strotss_torch.ops.image import (
    fold_laplacian_pyramid,
    make_laplacian,
    make_laplacian_pyramid,
    resize_bilinear,
    resize_max_hw,
)
from strotss_torch.ops.losses import content_loss, style_loss
from strotss_torch.ops.sampling import sample_paired
from strotss_torch.utils.timing import span


class StepSpec(NamedTuple):
    """Static configuration of one optimization step.

    ``remd_impl`` and ``selfsim_impl`` select the loss implementations:
    ``'auto'`` (the CUDA kernels on a CUDA device, the plain versions on
    the CPU), ``'plain'`` or ``'kernel'``; under ``use_sinkhorn``
    ``remd_impl`` is the Sinkhorn route (``'auto'``: the memory gate;
    ``'plain'``: materialized at every size). ``block1_impl`` is VGG
    block1's route for the run's device, ``'pallas'`` (fused, kernel K3)
    or ``'xla'`` (``F.conv2d``). ``shard_samples``: both transport terms
    split the style samples over the mesh's 'sample' axis
    (:mod:`strotss_torch.parallel.transport`); the process group comes to
    :func:`step_losses` as an argument. ``shard_spatial``: VGG runs on
    each rank's rows of the image over the mesh's 'spatial' axis
    (:mod:`strotss_torch.parallel.spatial`), which comes to
    :func:`optimization_steps` as an argument. ``sample_impl`` is the
    hypercolumn gathers' route (:mod:`strotss_torch.ops.sampling`):
    ``'auto'`` (kernel K5 on a CUDA device), ``'plain'`` or ``'kernel'``.
    ``step_impl`` is the step's route (:func:`step_route`): ``'auto'``
    (a replayed CUDA graph where the call allows one,
    :mod:`strotss_torch.graphs`) or ``'eager'``. ``moments_impl`` is the
    moment term's route, the style targets' statistics included
    (:mod:`strotss_torch.ops.kernels.moments`): ``'auto'`` (kernel K6 on
    a CUDA device), ``'plain'`` or ``'kernel'``.
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
    remat: bool = False
    shard_samples: bool = False
    shard_spatial: bool = False
    sample_impl: str = "plain"
    step_impl: str = "eager"
    moments_impl: str = "plain"


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
                     masked: bool = False, batched: bool = False) -> StepSpec:
    """The step's static configuration for a run on ``device``.

    A masked, batched, ``shard_samples`` or ``shard_spatial`` Sinkhorn
    run takes the materialized Sinkhorn with its unrolled gradient at
    every size, as the JAX package's masked and batched paths
    (``strotss_tpu/programs.py:88``) and its sharded ones (line 115, the
    materialized solve that GSPMD partitions) do: crossing the memory gate
    would change the gradient estimator and so the result. A Sinkhorn step
    runs no REMD, so ``remd_impl`` carries that route; self-similarity,
    and REMD on such a run without Sinkhorn, keep their kernels, since any
    route computes the same function.

    ``step_impl`` is ``'auto'`` on the kernels' route of a run without
    masks, Sinkhorn, sharding, ``remat`` or checkpoints (which a run may
    resume from), and ``'eager'`` on every other.
    """
    impl = "auto" if cfg.use_pallas else "plain"
    graphable = cfg.use_pallas and not (
        masked or cfg.use_sinkhorn or cfg.shard_samples or cfg.shard_spatial
        or cfg.remat or cfg.checkpoint_dir)
    return StepSpec(
        sample_size=cfg.sample_size,
        vgg_type=cfg.vgg_type,
        taps=tuple(cfg.taps or STROTSS_DEFAULT_TAPS),
        preprocess_mode="keras" if cfg.use_keras_weight else "norm",
        compute_dtype=cfg.compute_dtype,
        use_sinkhorn=cfg.use_sinkhorn,
        sinkhorn_lambda=cfg.sinkhorn_lambda,
        sinkhorn_iters=cfg.sinkhorn_iters,
        remd_impl=("plain" if (masked or batched or cfg.shard_samples
                                or cfg.shard_spatial) and cfg.use_sinkhorn
                   else impl),
        selfsim_impl=impl,
        block1_impl=_block1_route(cfg, device),
        remat=cfg.remat,
        shard_samples=cfg.shard_samples,
        shard_spatial=cfg.shard_spatial,
        sample_impl=impl,
        step_impl="auto" if graphable else "eager",
        moments_impl=impl,
    )


def step_route(spec: StepSpec, device, step_gens, sample_group=None,
               spatial=None) -> str:
    """The step's route, ``'graph'`` (a replayed CUDA graph,
    :mod:`strotss_torch.graphs`) or ``'eager'``: the graph where the
    spec allows one (``step_impl`` ``'auto'``, which
    :func:`spec_from_config` sets on the runs whose step a graph can hold)
    and the call is on a CUDA ``device``, names the generators its
    coordinates come from (``step_gens``; a caller names them only where
    the coordinates are their draws alone, on one device) and has no
    process group and no spatial split."""
    if spec.step_impl not in ("auto", "eager"):
        raise ValueError("step_impl must be 'auto' or 'eager', got "
                         f"{spec.step_impl!r}")
    ok = (spec.step_impl == "auto" and torch.device(device).type == "cuda"
          and step_gens is not None and sample_group is None
          and spatial is None)
    return "graph" if ok else "eager"


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


@contextlib.contextmanager
def precision(spec: StepSpec, deterministic: bool = False):
    """:func:`set_precision` for the body of the ``with``, then every
    switch it sets back as it was: the float32 matmul precision, oneDNN's
    and cuBLAS's fp32 modes and cuDNN's TF32 flag, so a run leaves the
    process's numerics as it found them.

    ``deterministic``: PyTorch's deterministic algorithms too, for ranks
    that hold replicas of one computation (``stylize_single`` under a
    mesh, a batch's 'sample' groups). On the card some backward passes add
    with atomics in an order that changes from run to run (``index_add_``
    in K1's VJP, for one), so replicas on two ranks would drift apart;
    with these switches every rank computes the same bits, and
    ``solve.check_replicas`` fails the run if they do not. Off, the
    caller's setting stands. Uninitialized memory is left unfilled: every
    kernel writes all of its outputs."""
    b = torch.backends
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the backends were set apart: no common value
        legacy = None
    saved = (b.mkldnn.matmul.fp32_precision, b.cuda.matmul.fp32_precision,
             b.cudnn.allow_tf32)
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    set_precision(spec)
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        b.mkldnn.matmul.fp32_precision = saved[0]
        b.cuda.matmul.fp32_precision = saved[1]
        b.cudnn.allow_tf32 = saved[2]
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
        torch.utils.deterministic.fill_uninitialized_memory = det[2]


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


def _columns(vgg: VGG, img: torch.Tensor, taps, slab):
    """[image, tap1..tapK], or under a ``slab`` the split hypercolumn of
    this rank's rows of the taps."""
    if slab is None:
        return [img] + taps
    from strotss_torch.parallel.spatial import SlabColumns, tap_level

    return SlabColumns(img, taps, [tap_level(t) for t in vgg.taps], slab)


def extract_hypercolumn(vgg: VGG, img: torch.Tensor, spatial=None):
    """Image -> hypercolumn list [image, tap1..tapK]. Under ``spatial``
    (:class:`strotss_torch.parallel.spatial.Spatial`) VGG runs on this
    rank's rows of the image only, and the hypercolumn is a
    :class:`strotss_torch.parallel.spatial.SlabColumns` that samples like
    the list."""
    slab = None if spatial is None else spatial.slab(img.shape[1])
    return _columns(vgg, img, vgg(img, slab), slab)


def extract_for_grad(spec: StepSpec, vgg: VGG, img: torch.Tensor,
                     spatial=None):
    """The loss path's extraction: :func:`extract_hypercolumn`, with the
    VGG forward under ``torch.utils.checkpoint`` when ``spec.remat`` is
    set, so the backward pass recomputes the activations instead of
    keeping them (``strotss_tpu/programs.py:159-172``). The recompute
    runs block1's forward again, so kernel K3a launches twice a step, and
    under ``spatial`` the whole forward's halo exchanges again, in the
    same order on every rank (the checkpoint's early stop, which ends a
    recompute once it has what the backward reads, is off there). The
    per-scale content and style extractions run without gradients and
    keep nothing either way."""
    if not spec.remat:
        return extract_hypercolumn(vgg, img, spatial)
    slab = None if spatial is None else spatial.slab(img.shape[1])
    with (contextlib.nullcontext() if slab is None else
          torch.utils.checkpoint.set_checkpoint_early_stop(False)):
        taps = torch.utils.checkpoint.checkpoint(vgg, img, slab,
                                                 use_reentrant=False)
    return _columns(vgg, img, taps, slab)


def warm_init_hw(content_h: int, content_w: int,
                 cfg: StrotssConfig) -> Tuple[int, int]:
    """The (h, w) a warm-start ``init_image`` is resized to: the first
    executed scale's (``cfg.start_level``'s) resolution. One direct
    resize to it is the resample a full run's scale handoff makes, so a
    refine seeded with ``info["stylized"]`` reproduces a full run's tail
    (``strotss_tpu/programs.py:183-198``)."""
    return resize_max_hw(content_h, content_w,
                         cfg.scale_sizes()[cfg.start_level])


def style_sample_counts(style_weights, sample_size: int) -> Tuple[int, ...]:
    """Largest-remainder apportionment of ``sample_size`` style samples
    among blended styles, on the host (``strotss_tpu/programs.py:
    287-317``): floor each ``w_i * n``, then hand the remaining samples to
    the largest fractional remainders, earlier styles first on ties."""
    w = np.asarray(style_weights, np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError(
            f"style_weights must be a 1-D sequence, got shape {w.shape}")
    if not np.all(np.isfinite(w)) or np.any(w < 0) or w.sum() <= 0:
        raise ValueError(
            "style_weights must be finite, >= 0, with a positive sum, got "
            f"{list(map(float, w))}")
    raw = w / w.sum() * sample_size
    base = np.floor(raw).astype(np.int64)
    short = sample_size - int(base.sum())
    order = np.argsort(-(raw - base), kind="stable")
    base[order[:short]] += 1
    return tuple(int(b) for b in base)


def scale_seed(mode: str, chw, shw, levels: int, content, style, prev,
               style_weights=None):
    """Per-scale init: resize the inputs, build the Laplacian seed, split
    it into pyramid variables. ``mode`` is 'first' (content Laplacian plus
    the style's mean colour), 'mid' (resized previous result plus content
    Laplacian) or 'last' (resized previous result).

    Blending: ``style`` is a tuple of images with a tuple ``shw`` of their
    shapes and ``style_weights`` one weight each; 'first' then adds the
    weight-blended mean colour, and ``scl_s`` is the tuple of resized
    styles."""
    scl_c = resize_bilinear(content, chw)
    if isinstance(style, tuple):
        scl_s = tuple(resize_bilinear(s, hw) for s, hw in zip(style, shw))
    else:
        scl_s = resize_bilinear(style, shw)
    lap = make_laplacian(scl_c)
    if mode == "first":
        if isinstance(scl_s, tuple):
            w = torch.tensor(style_weights, dtype=torch.float32,
                             device=scl_c.device)
            w = w / torch.sum(w)
            mean_color = sum(w[i] * torch.mean(s, dim=(1, 2), keepdim=True)
                             for i, s in enumerate(scl_s))
        else:
            mean_color = torch.mean(scl_s, dim=(1, 2), keepdim=True)
        sty = lap + mean_color
    elif mode == "mid":
        sty = resize_bilinear(prev, chw) + lap
    else:
        sty = resize_bilinear(prev, chw)
    return scl_c, scl_s, make_laplacian_pyramid(sty, levels)


def step_losses(spec: StepSpec, content_feats, pred, style_targets,
                style_moments, alpha: float, coords: torch.Tensor,
                weights=None, sample_group=None, pair: int = 0):
    """(loss, loss_c, loss_s) of one step at the given sample coords.

    One entry a region: (K, n, 2) ``coords``, (K, n, C) ``style_targets``
    and K ``style_moments`` (K = 1 without masks). ``loss_c`` and
    ``loss_s`` are the regions' means, and the loss
    sum_k (alpha lc_k + ls_k) / (K denom)
    (``strotss_tpu/programs.py:663-675``). ``weights``: K floats that
    replace the 1/K of the mean (a batch's ``region_valid`` weights).
    ``pair``: the pair's index in a batch, for the spans only.

    Under ``spec.shard_samples`` both transport terms split their samples
    over ``sample_group`` (the mesh's 'sample' process group): REMD the
    prediction's rows, with K1 running on (targets, this rank's shard),
    Sinkhorn the targets' rows, each rank's rows of the materialized cost
    matrix. The content loss (K2a,
    K2b) and the moments stay whole on every rank: K2a has no row-range
    interface, and at N = 1024 the pair takes 0.491 ms of device time a
    step on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table, K2
    row), the most a split could save.
    """
    denom = 2.0 + alpha + 1.0 / max(alpha, 1.0)
    remd = sinkhorn = None
    if spec.shard_samples:
        from strotss_torch.parallel.transport import (
            remd_over_group,
            sinkhorn_over_group,
        )

        # K1 takes (target, prediction) as unsharded: a near-tie of two
        # distances is then rounded the same on a rank, and picks the same
        # argmin, as in the unsharded step
        def remd(target, p_feat, distance):
            return remd_over_group(target, p_feat, sample_group, distance,
                                   spec.remd_impl)

        def sinkhorn(target, p_feat, distance):
            return sinkhorn_over_group(target, p_feat, sample_group,
                                       distance, spec.sinkhorn_lambda,
                                       spec.sinkhorn_iters)
    k = coords.shape[0]
    lc = ls = 0.0
    for r, (xy, target, tmom) in enumerate(zip(coords, style_targets,
                                               style_moments)):
        with span("loss.sample", region=r, pair=pair):
            c_feat, p_feat = sample_paired(xy, content_feats, pred,
                                           spec.sample_impl)
        with span("loss.content", region=r, pair=pair):
            lc_r = content_loss(c_feat, p_feat, impl=spec.selfsim_impl)
        with span("loss.style", region=r, pair=pair):
            ls_r = style_loss(target, p_feat, alpha,
                              use_sinkhorn=spec.use_sinkhorn,
                              sinkhorn_lambda=spec.sinkhorn_lambda,
                              sinkhorn_iters=spec.sinkhorn_iters,
                              remd_impl=spec.remd_impl, target_moments=tmom,
                              remd=remd, sinkhorn=sinkhorn,
                              moments_impl=spec.moments_impl)
        if weights is None:
            lc, ls = lc + lc_r / k, ls + ls_r / k
        else:
            lc, ls = lc + lc_r * weights[r], ls + ls_r * weights[r]
    return (alpha * lc + ls) / denom, lc, ls


def _step(spec: StepSpec, vgg: VGG, content_feats, style_targets,
          style_moments, alpha: float, pyramid, opt: RMSprop, draw,
          sample_group=None, spatial=None) -> torch.Tensor:
    """One step of :func:`optimization_steps` at the coordinates ``draw()``
    returns; its (loss, loss_c, loss_s) row."""
    leaves = [p.requires_grad_(True) for p in pyramid]
    with span("step.fold"):
        img = fold_laplacian_pyramid(leaves)
    with span("step.vgg"):
        pred = extract_for_grad(spec, vgg, img, spatial)
    with span("step.losses"):
        # the draw is the sampling layer's: its own generator, so its
        # place in the step changes no value
        coords = draw()
        loss, lc, ls = step_losses(spec, content_feats, pred, style_targets,
                                   style_moments, alpha, coords,
                                   sample_group=sample_group)
    # under remat nothing else holds the taps: the backward recomputes
    # them instead of keeping these alive beside the recomputed ones
    del pred
    with span("step.backward"):
        grads = torch.autograd.grad(loss, leaves)
    with span("step.update"):
        opt.step(grads)
    return torch.stack([loss, lc, ls]).detach()


def optimization_steps(spec: StepSpec, n_steps: int, vgg: VGG, content_feats,
                       style_targets, style_moments, alpha: float, pyramid,
                       opt: RMSprop, coords_fn: Callable[[int], torch.Tensor],
                       sample_group=None, spatial=None, step_gens=None):
    """``n_steps`` (>= 1) of sample -> VGG -> losses -> grad -> RMSprop.

    ``pyramid`` (a list of leaf tensors) is updated in place; the per-step
    (loss, loss_c, loss_s) rows come back as one (n_steps, 3) tensor on the
    run's device, so the loop never waits for the card. ``style_moments``
    are the targets' :func:`moment_stats`, hoisted out of the loop; the
    targets, moments and ``coords_fn``'s coordinates have one entry per
    region (:func:`step_losses`, which takes ``sample_group``). Under
    ``spatial`` (:class:`strotss_torch.parallel.spatial.Spatial`) the
    content features are split by height too, VGG runs on this rank's rows
    of the image, and the gradient of the VGG path is summed over the
    'spatial' group into the image's, the same on every rank.

    ``step_gens``: the generators ``coords_fn`` draws from, given only
    where its coordinates are one draw a step from them in step order and
    depend on nothing else (no ``coords_source``, no masks). The steps
    may then run as replays of one captured CUDA graph
    (:func:`step_route`, :mod:`strotss_torch.graphs`), which leave the
    pyramid, ``opt.nu`` and the generators as the eager steps would.
    """
    if step_route(spec, pyramid[0].device, step_gens, sample_group,
                  spatial) == "graph":
        def step(t, vgg, inputs, pyramid, opt):
            return _step(spec, vgg, *inputs, alpha, pyramid, opt,
                         lambda: coords_fn(t))

        return graphs.replayed(("single", spec, alpha), n_steps, step, vgg,
                               [content_feats, style_targets, style_moments],
                               pyramid, opt, step_gens)
    rows = []
    for t in range(n_steps):
        with span("step"):
            rows.append(_step(spec, vgg, content_feats, style_targets,
                              style_moments, alpha, pyramid, opt,
                              lambda: coords_fn(t), sample_group, spatial))
    return torch.stack(rows)


class PairTerms(NamedTuple):
    """What pair b of a batch brings to the batched step: its style
    targets (K_b, n, C) and their moments, one entry a region it runs
    (K_b = 1 without masks), its alpha, and its region weights (``None``:
    the mean over its K_b regions, as :func:`step_losses` takes it)."""

    targets: torch.Tensor
    moments: list
    alpha: float
    weights: object = None


def _batch_step(spec: StepSpec, vgg: VGG, content, pairs, pyramid,
                opt: RMSprop, draw, sample_group=None) -> torch.Tensor:
    """One step of :func:`batch_steps` at the coordinates ``draw(b)`` returns
    for pair b; its (B, 3) rows. ``content``: the content features unbound
    by pair."""
    leaves = [p.requires_grad_(True) for p in pyramid]
    with span("step.fold"):
        img = fold_laplacian_pyramid(leaves)
    with span("step.vgg"):
        # unbind: one gradient buffer for all pairs in the backward
        pred = [f.unbind(0) for f in extract_for_grad(spec, vgg, img)]
    total, per = None, []
    with span("step.losses"):
        coords = [draw(b) for b in range(len(pairs))]
        for b, pair in enumerate(pairs):
            if coords[b].shape[0] == 0:
                per.append(torch.zeros(3, device=img.device))
                continue
            loss, lc, ls = step_losses(
                spec, [f[b] for f in content], [f[b] for f in pred],
                pair.targets, pair.moments, pair.alpha, coords[b],
                pair.weights, sample_group, pair=b)
            total = loss if total is None else total + loss
            per.append(torch.stack([loss, lc, ls]).detach())
    del pred
    with span("step.backward"):
        grads = ([torch.zeros_like(p) for p in leaves] if total is None
                 else torch.autograd.grad(total, leaves))
    with span("step.update"):
        opt.step(grads)
    return torch.stack(per)


def batch_steps(spec: StepSpec, n_steps: int, vgg: VGG, content_feats,
                pairs: Sequence[PairTerms], pyramid, opt: RMSprop,
                coords_fn: Callable[[int, int], torch.Tensor],
                sample_group=None, step_gens=None):
    """``n_steps`` (>= 1) of the batched step for B pairs: the (B, ...)
    pyramid folds into B images, VGG runs once on all of them, and pair b
    takes :func:`step_losses` at its own coordinates ``coords_fn(b, t)``
    ((K_b, n, 2)), targets, moments, alpha and region weights.

    The loss is the SUM over pairs, not their mean: pairs share no term,
    so each pair's gradient is its single run's, and RMSprop (elementwise,
    its eps inside the square root) then moves each pair exactly as its
    single run would; a mean would scale the gradients by 1/B
    (``strotss_tpu/parallel/batch.py:172-180``). A pair with no region to
    run adds nothing and rows zeros. ``pyramid`` is updated in place; the
    per-step (loss, loss_c, loss_s) rows come back as one (n_steps, B, 3)
    tensor on the run's device, so the loop never waits for the card.
    ``sample_group``: as in :func:`step_losses`. ``step_gens``: the B
    generators ``coords_fn`` draws from, pair b's from the b-th, as
    :func:`optimization_steps` takes them.
    """
    if step_route(spec, pyramid[0].device, step_gens,
                  sample_group) == "graph":
        def step(t, vgg, inputs, pyramid, opt):
            content, pairs = inputs
            return _batch_step(spec, vgg, [f.unbind(0) for f in content],
                               pairs, pyramid, opt,
                               lambda b: coords_fn(b, t))

        return graphs.replayed(("batch", spec), n_steps, step, vgg,
                               [content_feats, list(pairs)], pyramid, opt,
                               step_gens)
    content = [f.unbind(0) for f in content_feats]
    rows = []
    for t in range(n_steps):
        with span("step"):
            rows.append(_batch_step(spec, vgg, content, pairs, pyramid, opt,
                                    lambda b: coords_fn(b, t),
                                    sample_group))
    return torch.stack(rows)
