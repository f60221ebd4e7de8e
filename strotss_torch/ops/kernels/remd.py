"""REMD row and column minima: CUDA kernel K1, its plain version, its VJP.

Counterpart of ``strotss_tpu/ops/kernels/remd.py``. The kernel
(``csrc/remd.cu``, whose header states its bound and design) returns the
row and column minima of the cosine / L2 / 'both' distance matrix with
their first argmins, without writing the N x M matrix. The gradient is the
JAX package's ``_mins_bwd`` / ``_pair_grads``: the incoming cotangents are
scattered onto the argmin pairs through the analytic distance derivatives,
in O((N + M) C).

``mins`` is the wrapper: on a CUDA tensor it launches the kernel (and
counts the launch in ``mins.launches``), on a CPU tensor it computes the
same function with :func:`mins_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import (
    _DIST_CODE,
    _L2DIST_EPS,
    check_cuda_f32,
    normalize_rows,
    resolve_impl,
)
from strotss_torch.ops.losses import dist_metrics

_TILE = 64  # csrc/tile.cuh TILE


def mins_plain(x: torch.Tensor, y: torch.Tensor, distance: str):
    """(rowmin, colmin, rowarg, colarg) from the materialized matrix."""
    c = dist_metrics[distance](x, y)
    rowmin, rowarg = torch.min(c, dim=1)
    colmin, colarg = torch.min(c, dim=0)
    return rowmin, colmin, rowarg.int(), colarg.int()


def mins(x: torch.Tensor, y: torch.Tensor, distance: str):
    """(rowmin, colmin, rowarg, colarg): kernel K1 on CUDA tensors."""
    if distance not in _DIST_CODE:
        raise ValueError(f"unknown distance {distance!r}")
    if not x.is_cuda:
        return mins_plain(x, y, distance)
    n, c = x.shape
    m = y.shape[0]
    check_cuda_f32("x", x, (n, c))
    check_cuda_f32("y", y, (m, c))
    if y.device != x.device:
        raise ValueError("x and y must lie on the same device")
    ntn, ntm = -(-n // _TILE), -(-m // _TILE)
    f32 = dict(dtype=torch.float32, device=x.device)
    i32 = dict(dtype=torch.int32, device=x.device)
    rowpart_v = torch.empty(ntm * n, **f32)
    rowpart_i = torch.empty(ntm * n, **i32)
    colpart_v = torch.empty(ntn * m, **f32)
    colpart_i = torch.empty(ntn * m, **i32)
    rowmin, rowarg = torch.empty(n, **f32), torch.empty(n, **i32)
    colmin, colarg = torch.empty(m, **f32), torch.empty(m, **i32)
    with torch.cuda.device(x.device):
        build.launch(
            "remd_mins", x.data_ptr(), y.data_ptr(), n, m, c,
            _DIST_CODE[distance], rowpart_v.data_ptr(), rowpart_i.data_ptr(),
            colpart_v.data_ptr(), colpart_i.data_ptr(), rowmin.data_ptr(),
            rowarg.data_ptr(), colmin.data_ptr(), colarg.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    mins.launches += 1
    return rowmin, colmin, rowarg, colarg


mins.launches = 0


def _pair_grads(x, y, ii, jj, w, cvals, distance: str, channels: int):
    """Gradients of sum_k w_k * C[ii_k, jj_k] with respect to x and y.

    ``cvals`` are the saved distances C[ii, jj] (the minima). All gathers
    are O(K) rows; no N x M tensor appears.
    """
    ii, jj = ii.long(), jj.long()
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(y)
    if distance in ("cosine", "both"):
        xn, xinv = normalize_rows(x)
        yn, yinv = normalize_rows(y)
        xng, yng = xn[ii], yn[jj]
        # dC = -(dx^ . y^ + x^ . dy^), pulled back through the row
        # normalization: dx = (dxh - (dxh . x^) x^) * inv
        dxh = -w[:, None] * yng
        dyh = -w[:, None] * xng
        dot_x = torch.sum(dxh * xng, dim=1, keepdim=True)
        dot_y = torch.sum(dyh * yng, dim=1, keepdim=True)
        dx.index_add_(0, ii, (dxh - dot_x * xng) * xinv[ii])
        dy.index_add_(0, jj, (dyh - dot_y * yng) * yinv[jj])
    if distance in ("l2", "both"):
        if distance == "both":
            # the l2 part of C at the matched pairs
            cos_c = 1.0 - torch.sum(xng * yng, dim=1)
            l2_c = cvals - cos_c
        else:
            l2_c = cvals
        diff = x[ii] - y[jj]
        msq = torch.sum(diff * diff, dim=1)
        active = (msq > _L2DIST_EPS).to(x.dtype)
        coef = w * active / (torch.clamp(l2_c, min=1e-30) * channels)
        dx.index_add_(0, ii, coef[:, None] * diff)
        dy.index_add_(0, jj, -coef[:, None] * diff)
    return dx, dy


class RemdMins(torch.autograd.Function):
    """(rowmin, colmin) through :func:`mins`, with the argmin-pair VJP."""

    @staticmethod
    def forward(ctx, x, y, distance: str):
        rowmin, colmin, rowarg, colarg = mins(x, y, distance)
        ctx.distance = distance
        ctx.save_for_backward(x, y, rowmin, colmin, rowarg, colarg)
        return rowmin, colmin

    @staticmethod
    def backward(ctx, g_row, g_col):
        x, y, rowmin, colmin, rowarg, colarg = ctx.saved_tensors
        n, c = x.shape
        m = y.shape[0]
        if g_row is None:
            g_row = torch.zeros_like(rowmin)
        if g_col is None:
            g_col = torch.zeros_like(colmin)
        rows = torch.arange(n, device=x.device)
        cols = torch.arange(m, device=x.device)
        dx1, dy1 = _pair_grads(x, y, rows, rowarg, g_row, rowmin,
                               ctx.distance, c)
        dx2, dy2 = _pair_grads(x, y, colarg, cols, g_col, colmin,
                               ctx.distance, c)
        return dx1 + dx2, dy1 + dy2, None


def remd_mins(x: torch.Tensor, y: torch.Tensor, distance: str = "cosine",
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (row-min, col-min) of the pairwise distance matrix.

    ``impl``: ``'kernel'`` (K1 and its VJP), ``'plain'`` (the materialized
    matrix under autograd) or ``'auto'`` (the kernel on CUDA tensors).
    """
    if resolve_impl(impl, x) == "plain":
        rowmin, colmin, _, _ = mins_plain(x, y, distance)
        return rowmin, colmin
    return RemdMins.apply(x.contiguous(), y.contiguous(), distance)
