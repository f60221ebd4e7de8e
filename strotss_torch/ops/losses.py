"""STROTSS losses: distances, relaxed EMD, self-similarity, moments.

Counterpart of ``strotss_tpu/ops/losses.py`` (lines 35-206 and 288-343),
all in float32:

- ``cosine_distance``: rows l2-normalized with floor 1e-12, ``1 - x^ y^T``.
- ``l2_distance``: squared-expansion pairwise distance, floored at 1e-6,
  divided by the channel count, then sqrt.
- ``self_similarity``: column-sum-normalized self-cosine matrices (floor
  1e-12), MAE between them times the row count.
- ``moment_matching``: MAE of means + MAE of biased covariances.
- ``relaxed_emd``: ``max(mean(row-min C), mean(col-min C))``.

``impl`` selects between the hand-written CUDA kernel and its plain
PyTorch version (``'auto'``: the kernel on a CUDA tensor, the plain version
on a CPU tensor; ``'plain'``; ``'kernel'``, which raises on the CPU). The
Sinkhorn transport of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

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


def moment_stats(x: torch.Tensor):
    """(mean (1,C), biased covariance (C,C)) of the rows of ``x``."""
    x = reshape_2d(_f32(x))
    xm = torch.mean(x, dim=0, keepdim=True)
    cx = x - xm
    return xm, (cx.T @ cx) / x.shape[0]


def moment_matching_from_stats(stats, y: torch.Tensor) -> torch.Tensor:
    """:func:`moment_matching` with the x-side stats precomputed."""
    xm, xv = stats
    ym, yv = moment_stats(y)
    return mae(xv, yv) + mae(xm, ym)


def moment_matching(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MAE(mean_x, mean_y) + MAE(cov_x, cov_y) with biased covariance."""
    return moment_matching_from_stats(moment_stats(x), y)


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


def style_loss(
    target: torch.Tensor,
    prediction: torch.Tensor,
    alpha,
    use_sinkhorn: bool = False,
    remd_impl: str = "auto",
    target_moments: Optional[tuple] = None,
) -> torch.Tensor:
    """``moments + REMD(cosine) + (1/max(alpha,1)) * REMD(YUV, 'both')``.

    ``target_moments``: optional precomputed :func:`moment_stats` of
    ``target`` (the solver hoists them out of the step loop).
    """
    if use_sinkhorn:
        raise NotImplementedError(
            "Sinkhorn transport is not ported to strotss_torch yet "
            "(ROADMAP.md Queue 1 item 12)"
        )
    inv_alpha = 1.0 / max(float(alpha), 1.0)
    if target_moments is None:
        target_moments = moment_stats(target)
    l_m = moment_matching_from_stats(target_moments, prediction)
    l_t = relaxed_emd(target, prediction, "cosine", impl=remd_impl)
    l_p = relaxed_emd(rgb_to_yuv(_f32(target)), rgb_to_yuv(_f32(prediction)),
                      "both", impl=remd_impl)
    return l_m + l_t + inv_alpha * l_p


def content_loss(target: torch.Tensor, prediction: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """Reference ``ContentLoss``: self-similarity of (prediction, target)."""
    return self_similarity(prediction, target, impl=impl)
