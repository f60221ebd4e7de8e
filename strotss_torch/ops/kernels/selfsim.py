"""Self-similarity loss: CUDA kernels K2a (forward) and K2b (backward).

Counterpart of ``strotss_tpu/ops/kernels/selfsim.py``. With x^, y^ the
row-normalized samples, D_x = 1 - x^ x^T, c_x its column sums (closed form
``N - (sum_i x^_i) . x^_j``, floored at 1e-12) and A = D_x / c_x:

    loss = sum |A - B| / N
    s    = sign(A - B)
    t_j  = sum_i s_ij D_ij                          (for x and for y)
    G_ij = (s_ij / c_j - t_j / c_j^2) / N           (dloss / dD_x)
    dloss / dx^ = -(G + G^T) x^

``selfsim_fwd`` returns (loss, t_x, t_y, signs), the signs as int8 in
{-1, 0, +1}; ``selfsim_bwd`` takes them and returns
((G_x + G_x^T) x^, (G_y + G_y^T) y^), so the backward uses exactly the
signs t was summed over. On CUDA tensors they launch the kernels of
``csrc/selfsim.cu`` (whose header states their bound and design) and count
the launches; on CPU tensors they compute the same with the materialized
plain versions below. The normalization, the column sums and the pull-back
through the normalization stay in PyTorch, as the JAX package keeps them
outside its kernels.

On the card the signs are an (N, N) view of an (N, sp) buffer whose row
pitch sp is a multiple of ``SIGN_PITCH`` bytes. The ``bwd_*`` maps state
K2b's thread, fragment and shared-memory layouts in Python, for the CPU
tests.
"""

from __future__ import annotations

import torch

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import (
    _COLSUM_EPS,
    check_cuda_f32,
    launch_on,
    normalize_rows,
    resolve_impl,
    round_up,
    stream_scratch,
)
from strotss_torch.ops.kernels.remd import frag_a, frag_b, frag_c
from strotss_torch.ops.losses import cosine_distance, mae

_TILE = 64  # csrc/tile.cuh TILE
#: csrc/selfsim.cu SB_PITCH: the signs' row pitch in bytes is a multiple
SIGN_PITCH = 64
#: csrc/selfsim.cu, K2b: a block's output rows (SB_BM) and channels (SB_BN),
#: the samples of a stage (SB_KC), the floats between x^ rows of a stage
#: (SB_LDX), the (big, small) pairs between H rows (SB_LDH), the bytes
#: between rows of the s[o, r] and s[r, o] tiles (SB_S1, SB_S2), the warps
#: (2 x 4) and threads
SB_BM, SB_BN, SB_KC, SB_LDX, SB_LDH, SB_S1, SB_S2 = 64, 128, 32, 136, 36, 48, 80
_SB_WARPS_N, SB_THREADS = 4, 256


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


def selfsim_fwd_plain(xh, yh, cx, cy):
    """(loss, t_x, t_y, signs) with the N x N matrices materialized; the
    signs are ``torch.sign(A - B)`` as int8."""
    n = xh.shape[0]
    dx = 1.0 - xh @ xh.T
    dy = 1.0 - yh @ yh.T
    diff = dx / cx[None, :] - dy / cy[None, :]
    s = torch.sign(diff)
    return (torch.sum(torch.abs(diff)) / n, torch.sum(s * dx, dim=0),
            torch.sum(s * dy, dim=0), s.to(torch.int8))


def selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs):
    """((G_x + G_x^T) x^, (G_y + G_y^T) y^) with G materialized from the
    given signs."""
    n = xh.shape[0]
    s = signs.to(xh.dtype)
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


def _fwd_scratch(device: torch.device, n: int, stream: int):
    """Pointers to total_part, tx_part, ty_part in one buffer kept per
    (device, n) and stream (``common.stream_scratch``)."""
    nt = -(-n // _TILE)
    total = stream_scratch(("selfsim_fwd", device.index, n), stream,
                           nt * nt + 2 * nt * n, torch.float32,
                           device).data_ptr()
    return total, total + 4 * nt * nt, total + 4 * (nt * nt + nt * n)


def selfsim_fwd(xh, yh, cx, cy):
    """(loss, t_x, t_y, signs): kernel K2a on CUDA tensors."""
    if not xh.is_cuda:
        return selfsim_fwd_plain(xh, yh, cx, cy)
    n, c = _check(xh, yh, cx, cy)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    parts = _fwd_scratch(xh.device, n, stream)
    out = torch.empty(1 + 2 * n, dtype=torch.float32, device=xh.device)
    loss, tx, ty = out[0], out[1:n + 1], out[n + 1:]
    sp = round_up(n, SIGN_PITCH)
    signs = torch.empty((n, sp), dtype=torch.int8, device=xh.device)
    launch_on(xh.device, "selfsim_fwd", xh.data_ptr(), yh.data_ptr(),
              cx.data_ptr(), cy.data_ptr(), n, c, *parts, loss.data_ptr(),
              tx.data_ptr(), ty.data_ptr(), signs.data_ptr(), sp, stream)
    selfsim_fwd.launches += 1
    return loss, tx, ty, signs[:, :n]


selfsim_fwd.launches = 0


def _check_signs(signs: torch.Tensor, n: int, device) -> None:
    """Raise unless ``signs`` is laid out as K2a writes them: (n, n) int8
    on ``device``, rows ``SIGN_PITCH``-aligned, 16-byte aligned."""
    if signs.dtype != torch.int8 or tuple(signs.shape) != (n, n):
        raise ValueError(f"signs must be int8 of shape {(n, n)}, got "
                         f"{signs.dtype} {tuple(signs.shape)}")
    if signs.device != device:
        raise ValueError("signs must lie on the samples' device")
    if (signs.stride(1) != 1 or signs.stride(0) % SIGN_PITCH
            or signs.data_ptr() % 16):
        raise ValueError("signs must be laid out as selfsim_fwd returns "
                         f"them: rows a multiple of {SIGN_PITCH} bytes apart,"
                         " 16-byte aligned")


def bwd_setups() -> int:
    """How many times K2b's C entry has set its kernel's shared-memory
    limit in this process: once per device."""
    return build.library("selfsim").selfsim_bwd_setups()


def selfsim_bwd(xh, yh, cx, cy, tx, ty, signs):
    """((G_x + G_x^T) x^, (G_y + G_y^T) y^) from the forward's signs:
    kernel K2b on CUDA tensors."""
    if not xh.is_cuda:
        return selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)
    n, c = _check(xh, yh, cx, cy, tx, ty)
    _check_signs(signs, n, xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    u = torch.empty((2, n, c), dtype=torch.float32, device=xh.device)
    launch_on(xh.device, "selfsim_bwd", xh.data_ptr(), yh.data_ptr(),
              cx.data_ptr(), cy.data_ptr(), tx.data_ptr(), ty.data_ptr(),
              signs.data_ptr(), signs.stride(0), n, c, u[0].data_ptr(),
              u[1].data_ptr(), stream)
    selfsim_bwd.launches += 1
    return u[0], u[1]


selfsim_bwd.launches = 0


class SelfSimilarity(torch.autograd.Function):
    """Loss through :func:`selfsim_fwd`, gradients through
    :func:`selfsim_bwd` on the forward's signs and the pull-back through
    the normalization."""

    @staticmethod
    def forward(ctx, x, y):
        if x.shape != y.shape:
            raise ValueError("self-similarity compares equal sample counts, "
                             f"got {tuple(x.shape)} and {tuple(y.shape)}")
        xh, yh, xinv, yinv, cx, cy = _prep(x, y)
        loss, tx, ty, signs = selfsim_fwd(xh, yh, cx, cy)
        ctx.save_for_backward(xh, yh, xinv, yinv, cx, cy, tx, ty, signs)
        return loss

    @staticmethod
    def backward(ctx, g):
        xh, yh, xinv, yinv, cx, cy, tx, ty, signs = ctx.saved_tensors
        ux, uy = selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
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


# ---- K2b's layouts (csrc/selfsim.cu), for the CPU tests -------------------


def bwd_tile_rc(warp: int, lane: int, mb: int, nb: int, i: int):
    """(row o, channel) in a block's SB_BM x SB_BN tile of accumulator
    ``acc[mb][nb][i]`` of ``lane`` in ``warp`` (warps 2 x 4, each 32 x 32)."""
    wm, wn = divmod(warp, _SB_WARPS_N)
    r, col = frag_c(lane, i)
    return wm * 32 + 16 * mb + r, wn * 32 + 8 * nb + col


def bwd_smem_a(warp: int, lane: int, mb: int, i: int, kk: int):
    """(big, small) pair index in an H buffer that A register ``i`` of
    fragment ``mb`` reads at k8 step ``kk``: H row o, sample column r."""
    row, k = frag_a(lane, i)
    wm = warp // _SB_WARPS_N
    return (wm * 32 + 16 * mb + row) * SB_LDH + kk + k


def bwd_smem_b(warp: int, lane: int, nb: int, i: int, kk: int):
    """Float offset in a stage's x^ tile of B register ``i`` of fragment
    ``nb`` at k8 step ``kk``: sample row kk + k, channel column."""
    k, col = frag_b(lane, i)
    wn = warp % _SB_WARPS_N
    return (kk + k) * SB_LDX + wn * 32 + 8 * nb + col


def bwd_h_build(warp: int, lane: int, j: int):
    """What thread (warp, lane) builds as its ``j``-th H element of a
    stage: (o, r, pair index written, byte of s[o, r] in its tile, first
    byte of the 8-byte read of s[r, o .. o + 7] in its tile)."""
    o, r = 8 * warp + j, lane
    return o, r, o * SB_LDH + r, o * SB_S1 + r, r * SB_S2 + 8 * warp


def bwd_x_copy(tid: int, q: int):
    """(sample row k, channel) of a stage's x^ tile that thread ``tid``'s
    ``q``-th 4-byte copy fills, and its float offset in the tile."""
    k, ch = tid // SB_BN + 2 * q, tid % SB_BN
    return k, ch, k * SB_LDX + ch


def bwd_sign_copy(tid: int):
    """The 16-byte chunk of a stage's sign tiles that thread ``tid``
    copies: (tile 1 for s[o, r] or 2 for s[r, o], tile row, first tile
    column, byte offset in the tile)."""
    if tid < 2 * SB_BM:
        i, h = divmod(tid, 2)
        return 1, i, 16 * h, i * SB_S1 + 16 * h
    k, h = divmod(tid - 2 * SB_BM, 4)
    return 2, k, 16 * h, k * SB_S2 + 16 * h
