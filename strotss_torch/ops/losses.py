"""STROTSS losses: distances, relaxed EMD, self-similarity, moments,
Sinkhorn.

Counterpart of ``strotss_tpu/ops/losses.py`` (lines 35-343), all in
float32:

- ``cosine_distance``: rows l2-normalized with floor 1e-12, ``1 - x^ y^T``.
- ``l2_distance``: squared-expansion pairwise distance, floored at 1e-6,
  divided by the channel count, then sqrt.
- ``self_similarity``: column-sum-normalized self-cosine matrices (floor
  1e-12), MAE between them times the row count.
- ``moment_matching``: MAE of means + MAE of biased covariances.
- ``relaxed_emd``: ``max(mean(row-min C), mean(col-min C))``.
- ``sinkhorn``: log-domain entropic OT ``<T, C>``.

``impl`` selects between the hand-written CUDA kernel and its plain
PyTorch version (``'auto'``: the kernel on a CUDA tensor, the plain version
on a CPU tensor; ``'plain'``; ``'kernel'``, which raises on the CPU).
``sinkhorn``'s ``impl`` is a choice of algorithm instead, see there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from strotss_torch.ops.image import rgb_to_yuv
from strotss_torch.ops.kernels.common import _L2DIST_EPS, _L2NORM_EPS


def mae(x, y):
    return torch.mean(torch.abs(x - y))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def reshape_2d(x: torch.Tensor) -> torch.Tensor:
    """Flatten any tensor to (N, C) with C the last axis."""
    if x.ndim == 2:
        return x
    x = torch.squeeze(x)
    if x.ndim == 2:
        return x
    return x.reshape(-1, x.shape[-1])


def l2_normalize_rows(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=_L2NORM_EPS))


def cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine distance matrix ``1 - x^ y^T`` of shape (N, M)."""
    x, y = _f32(x), _f32(y)
    return 1.0 - l2_normalize_rows(x) @ l2_normalize_rows(y).T


def l2_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Channel-normalized pairwise L2 distance matrix of shape (N, M)."""
    x, y = _f32(x), _f32(y)
    x_sq = torch.sum(x * x, dim=1)[:, None]
    y_sq = torch.sum(y * y, dim=1)[None, :]
    m = x_sq + y_sq - 2.0 * (x @ y.T)
    return torch.sqrt(torch.clamp(m, min=_L2DIST_EPS) / x.shape[1])


def both_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return cosine_distance(x, y) + l2_distance(x, y)


dist_metrics = {
    "cosine": cosine_distance,
    "l2": l2_distance,
    "both": both_distance,
}


def moment_stats(x: torch.Tensor, impl: str = "auto"):
    """(mean (1,C), biased covariance (C,C)) of the rows of ``x``; on the
    kernel's route (:mod:`strotss_torch.ops.kernels.moments`, K6) the
    covariance is exactly symmetric. ``'auto'`` takes K6 on a CUDA tensor
    that wants no gradient, the plain formula otherwise."""
    from strotss_torch.ops.kernels.moments import moment_stats as _ms

    return _ms(x, impl)


def moment_matching_from_stats(stats, y: torch.Tensor,
                               impl: str = "auto") -> torch.Tensor:
    """:func:`moment_matching` with the x-side stats precomputed;
    ``'auto'`` takes K6 on CUDA tensors unless a gradient is wanted
    through ``stats``, which K6 does not give."""
    from strotss_torch.ops.kernels.moments import (
        moment_matching_from_stats as _mm,
    )

    return _mm(stats, y, impl)


def moment_matching(x: torch.Tensor, y: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """MAE(mean_x, mean_y) + MAE(cov_x, cov_y) with biased covariance."""
    return moment_matching_from_stats(moment_stats(x, impl), y, impl)


def self_similarity(x: torch.Tensor, y: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """STROTSS content loss: compare column-normalized self-cosine matrices.

    Called with (prediction, content-target). The kernel
    (:mod:`strotss_torch.ops.kernels.selfsim`) needs ``x.shape ==
    y.shape``, as the Pallas one does.
    """
    from strotss_torch.ops.kernels.selfsim import self_similarity as _ss

    x, y = reshape_2d(_f32(x)), reshape_2d(_f32(y))
    return _ss(x, y, impl)


def relaxed_emd(x: torch.Tensor, y: torch.Tensor, distance: str = "cosine",
                impl: str = "auto") -> torch.Tensor:
    """Relaxed earth mover's distance: max of the two one-sided matching
    costs, from the row and column minima of the distance matrix."""
    from strotss_torch.ops.kernels.remd import remd_mins

    x, y = reshape_2d(_f32(x)), reshape_2d(_f32(y))
    rowmin, colmin = remd_mins(x, y, distance, impl)
    return torch.maximum(torch.mean(rowmin), torch.mean(colmin))


#: The JAX package's memory gate (``strotss_tpu/ops/losses.py:256-260``):
#: 'auto' streams once N * M > 2**30. Crossing it switches the gradient
#: estimator from the unrolled one to the converged-plan (Danskin) one, so
#: the port keeps the same gate, and the same result for the same config,
#: although an 80 GB card would fit the materialized path further up.
SINKHORN_STREAM_ABOVE = 2 ** 30


def sinkhorn_route(n: int, m: int, impl: str = "auto") -> str:
    """'plain' or 'kernel' for an N x M Sinkhorn under ``impl``."""
    if impl == "auto":
        return "kernel" if n * m > SINKHORN_STREAM_ABOVE else "plain"
    if impl in ("plain", "kernel"):
        return impl
    raise ValueError(f"impl must be 'auto', 'plain' or 'kernel', got {impl!r}")


def _sinkhorn_plain(x, y, distance: str, lam: float, n_iter: int):
    m = dist_metrics[distance](x, y)
    n, mm = m.shape
    log_k = -lam * m
    log_p = torch.full((n,), -math.log(n), dtype=m.dtype, device=m.device)
    log_q = torch.full((mm,), -math.log(mm), dtype=m.dtype, device=m.device)

    def body(log_u, log_v):
        log_u = log_p - torch.logsumexp(log_k + log_v[None, :], dim=1)
        log_v = log_q - torch.logsumexp(log_k + log_u[:, None], dim=0)
        return log_u, log_v

    log_u, log_v = m.new_zeros(n), m.new_zeros(mm)
    for _ in range(n_iter):
        # recompute each iteration in the backward pass (the JAX package's
        # jax.checkpoint): otherwise autograd keeps two N x M logsumexp
        # residuals per iteration
        log_u, log_v = checkpoint(body, log_u, log_v, use_reentrant=False)
    log_t = log_u[:, None] + log_k + log_v[None, :]
    return torch.sum(torch.exp(log_t) * m)


def sinkhorn(x: torch.Tensor, y: torch.Tensor, distance: str = "cosine",
             lam: float = 10.0, n_iter: int = 30,
             impl: str = "auto") -> torch.Tensor:
    """Entropic OT cost ``<T, C>`` by ``n_iter`` log-domain Sinkhorn
    iterations (uniform marginals, kernel ``exp(-lam C)``).

    ``impl='plain'`` materializes the N x M log-kernel and differentiates
    through the unrolled iterations. ``'kernel'`` streams every
    half-update (:mod:`strotss_torch.ops.kernels.sinkhorn`: kernel K4 on
    CUDA tensors, its plain version on CPU tensors) and returns the
    converged-plan (Danskin) gradient. ``'auto'`` takes ``'kernel'`` only
    above the memory gate :data:`SINKHORN_STREAM_ABOVE`.
    """
    x, y = reshape_2d(_f32(x)), reshape_2d(_f32(y))
    if sinkhorn_route(x.shape[0], y.shape[0], impl) == "kernel":
        from strotss_torch.ops.kernels.sinkhorn import sinkhorn_streamed

        return sinkhorn_streamed(x, y, distance, lam, n_iter)
    return _sinkhorn_plain(x, y, distance, lam, n_iter)


def _unsharded_transport(use_sinkhorn: bool, lam: float, n_iter: int,
                         impl: str):
    """The transport term ``(target, prediction, distance) -> value`` of
    an unsharded step: :func:`sinkhorn` or :func:`relaxed_emd`."""
    if use_sinkhorn:
        return lambda x, y, distance: sinkhorn(x, y, distance, lam, n_iter,
                                               impl=impl)
    return lambda x, y, distance: relaxed_emd(x, y, distance, impl=impl)


def style_loss(
    target: torch.Tensor,
    prediction: torch.Tensor,
    alpha,
    use_sinkhorn: bool = False,
    sinkhorn_lambda: float = 10.0,
    sinkhorn_iters: int = 30,
    remd_impl: str = "auto",
    target_moments: Optional[tuple] = None,
    remd=None,
    sinkhorn=None,
    moments_impl: str = "auto",
) -> torch.Tensor:
    """``moments + T(cosine) + (1/max(alpha,1)) * T(YUV, 'both')``, with
    the transport term T REMD, or Sinkhorn under ``use_sinkhorn``.

    ``remd_impl`` also picks the Sinkhorn implementation ('auto': the
    memory gate; 'plain': the materialized path at every size), as the
    JAX package passes its ``remd_impl`` on.
    ``target_moments``: optional precomputed :func:`moment_stats` of
    ``target`` (the solver hoists them out of the step loop). ``remd``:
    the REMD function ``(target, prediction, distance) -> value`` in
    place of :func:`relaxed_emd`, and ``sinkhorn``: the Sinkhorn function
    of the same signature in place of :func:`sinkhorn` (the
    sample-sharded ones under ``shard_samples``). ``moments_impl``: the
    moments' route (``'auto'``: kernel K6 on a CUDA tensor).
    """
    inv_alpha = 1.0 / max(float(alpha), 1.0)
    if target_moments is None:
        target_moments = moment_stats(target, moments_impl)
    l_m = moment_matching_from_stats(target_moments, prediction,
                                     moments_impl)
    yuv_t, yuv_p = rgb_to_yuv(_f32(target)), rgb_to_yuv(_f32(prediction))
    transport = sinkhorn if use_sinkhorn else remd
    if transport is None:
        transport = _unsharded_transport(use_sinkhorn, sinkhorn_lambda,
                                         sinkhorn_iters, remd_impl)
    l_t = transport(target, prediction, "cosine")
    l_p = transport(yuv_t, yuv_p, "both")
    return l_m + l_t + inv_alpha * l_p


def content_loss(target: torch.Tensor, prediction: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """Reference ``ContentLoss``: self-similarity of (prediction, target)."""
    return self_similarity(prediction, target, impl=impl)
