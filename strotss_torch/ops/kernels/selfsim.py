"""Self-similarity loss: CUDA kernels K2a (forward) and K2b (backward).

Counterpart of ``strotss_tpu/ops/kernels/selfsim.py``. With x^, y^ the
row-normalized samples, D_x = 1 - x^ x^T, c_x its column sums (closed form
``N - (sum_i x^_i) . x^_j``, floored at 1e-12) and A = D_x / c_x:

    loss = sum |A - B| / N
    t_j  = sum_i sign(A - B)_ij D_ij               (for x and for y)
    G_ij = (s_ij / c_j - t_j / c_j^2) / N           (dloss / dD_x)
    dloss / dx^ = -(G + G^T) x^

``selfsim_fwd`` returns (loss, t_x, t_y) and ``selfsim_bwd`` returns
((G_x + G_x^T) x^, (G_y + G_y^T) y^). On CUDA tensors they launch the
kernels of ``csrc/selfsim.cu`` (whose header states their bound and design)
and count the launches; on CPU tensors they compute the same with the
materialized plain versions below. The normalization, the column sums and
the pull-back through the normalization stay in PyTorch, as the JAX
package keeps them outside its kernels.
"""

from __future__ import annotations

import torch

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import (
    _COLSUM_EPS,
    check_cuda_f32,
    normalize_rows,
    resolve_impl,
)
from strotss_torch.ops.losses import cosine_distance, mae

_TILE = 64  # csrc/tile.cuh TILE


def self_similarity_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The materialized formula (``strotss_tpu/ops/losses.py:172-176``)."""
    x_dist = cosine_distance(x, x)
    x_dist = x_dist / torch.clamp(torch.sum(x_dist, dim=0), min=_COLSUM_EPS)
    y_dist = cosine_distance(y, y)
    y_dist = y_dist / torch.clamp(torch.sum(y_dist, dim=0), min=_COLSUM_EPS)
    return mae(x_dist, y_dist) * y.shape[0]


def _prep(x: torch.Tensor, y: torch.Tensor):
    """Normalized rows, inverse norms and closed-form column sums."""
    n = x.shape[0]
    xh, xinv = normalize_rows(x)
    yh, yinv = normalize_rows(y)
    cx = torch.clamp(n - xh @ torch.sum(xh, dim=0), min=_COLSUM_EPS)
    cy = torch.clamp(n - yh @ torch.sum(yh, dim=0), min=_COLSUM_EPS)
    return xh, yh, xinv, yinv, cx, cy


def _sign_matrix(xh, yh, cx, cy):
    dx = 1.0 - xh @ xh.T
    dy = 1.0 - yh @ yh.T
    return dx, dy, torch.sign(dx / cx[None, :] - dy / cy[None, :])


def selfsim_fwd_plain(xh, yh, cx, cy):
    """(loss, t_x, t_y) with the N x N matrices materialized."""
    n = xh.shape[0]
    dx, dy, s = _sign_matrix(xh, yh, cx, cy)
    total = torch.sum(torch.abs(dx / cx[None, :] - dy / cy[None, :]))
    return total / n, torch.sum(s * dx, dim=0), torch.sum(s * dy, dim=0)


def selfsim_bwd_plain(xh, yh, cx, cy, tx, ty):
    """((G_x + G_x^T) x^, (G_y + G_y^T) y^) with G materialized."""
    n = xh.shape[0]
    _, _, s = _sign_matrix(xh, yh, cx, cy)
    gx = (s / cx[None, :] - (tx / (cx * cx))[None, :]) / n
    gy = (-s / cy[None, :] + (ty / (cy * cy))[None, :]) / n
    return (gx + gx.T) @ xh, (gy + gy.T) @ yh


def _check(xh, yh, cx, cy, *more):
    n, c = xh.shape
    check_cuda_f32("xh", xh, (n, c))
    check_cuda_f32("yh", yh, (n, c))
    for name, t in zip(("cx", "cy", "tx", "ty"), (cx, cy) + more):
        check_cuda_f32(name, t, (n,))
    return n, c


def selfsim_fwd(xh, yh, cx, cy):
    """(loss, t_x, t_y): kernel K2a on CUDA tensors."""
    if not xh.is_cuda:
        return selfsim_fwd_plain(xh, yh, cx, cy)
    n, c = _check(xh, yh, cx, cy)
    nt = -(-n // _TILE)
    f32 = dict(dtype=torch.float32, device=xh.device)
    total_part = torch.empty(nt * nt, **f32)
    tx_part = torch.empty(nt * n, **f32)
    ty_part = torch.empty(nt * n, **f32)
    loss = torch.empty((), **f32)
    tx, ty = torch.empty(n, **f32), torch.empty(n, **f32)
    with torch.cuda.device(xh.device):
        build.launch(
            "selfsim_fwd", xh.data_ptr(), yh.data_ptr(), cx.data_ptr(),
            cy.data_ptr(), n, c, total_part.data_ptr(), tx_part.data_ptr(),
            ty_part.data_ptr(), loss.data_ptr(), tx.data_ptr(), ty.data_ptr(),
            torch.cuda.current_stream(xh.device).cuda_stream,
        )
    selfsim_fwd.launches += 1
    return loss, tx, ty


selfsim_fwd.launches = 0


def selfsim_bwd(xh, yh, cx, cy, tx, ty):
    """((G_x + G_x^T) x^, (G_y + G_y^T) y^): kernel K2b on CUDA tensors."""
    if not xh.is_cuda:
        return selfsim_bwd_plain(xh, yh, cx, cy, tx, ty)
    n, c = _check(xh, yh, cx, cy, tx, ty)
    f32 = dict(dtype=torch.float32, device=xh.device)
    gmx = torch.empty(n * n, **f32)
    gmy = torch.empty(n * n, **f32)
    ux = torch.empty((n, c), **f32)
    uy = torch.empty((n, c), **f32)
    with torch.cuda.device(xh.device):
        build.launch(
            "selfsim_bwd", xh.data_ptr(), yh.data_ptr(), cx.data_ptr(),
            cy.data_ptr(), tx.data_ptr(), ty.data_ptr(), n, c,
            gmx.data_ptr(), gmy.data_ptr(), ux.data_ptr(), uy.data_ptr(),
            torch.cuda.current_stream(xh.device).cuda_stream,
        )
    selfsim_bwd.launches += 1
    return ux, uy


selfsim_bwd.launches = 0


class SelfSimilarity(torch.autograd.Function):
    """Loss through :func:`selfsim_fwd`, gradients through
    :func:`selfsim_bwd` and the pull-back through the normalization."""

    @staticmethod
    def forward(ctx, x, y):
        if x.shape != y.shape:
            raise ValueError("self-similarity compares equal sample counts, "
                             f"got {tuple(x.shape)} and {tuple(y.shape)}")
        xh, yh, xinv, yinv, cx, cy = _prep(x, y)
        loss, tx, ty = selfsim_fwd(xh, yh, cx, cy)
        ctx.save_for_backward(xh, yh, xinv, yinv, cx, cy, tx, ty)
        return loss

    @staticmethod
    def backward(ctx, g):
        xh, yh, xinv, yinv, cx, cy, tx, ty = ctx.saved_tensors
        ux, uy = selfsim_bwd(xh, yh, cx, cy, tx, ty)
        dxh, dyh = -ux, -uy
        # pull back through row normalization: dx = (dx^ - (dx^.x^)x^)*inv
        dx = (dxh - torch.sum(dxh * xh, dim=1, keepdim=True) * xh) * xinv
        dy = (dyh - torch.sum(dyh * yh, dim=1, keepdim=True) * yh) * yinv
        return g * dx, g * dy


def self_similarity(x: torch.Tensor, y: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Self-similarity loss of (x, y) by ``impl`` ('auto', 'plain' or
    'kernel'; 'auto' takes the kernels on CUDA tensors)."""
    if resolve_impl(impl, x) == "plain":
        return self_similarity_plain(x, y)
    return SelfSimilarity.apply(x.contiguous(), y.contiguous())
