"""REMD row and column minima: CUDA kernel K1, its plain version, its VJP.

Counterpart of ``strotss_tpu/ops/kernels/remd.py``. The kernel
(``csrc/remd.cu``, whose header states its bound and design) returns the
row and column minima of the cosine / L2 / 'both' distance matrix with
their first argmins, without writing the N x M matrix. Its C entry takes
one of two routes by the channel count: from ``tc_min_c()`` channels up the
tensor cores with f32 values split into TF32 parts ("3xTF32"), below that
f32 FMAs on the CUDA cores. The gradient is the JAX package's
``_mins_bwd`` / ``_pair_grads``: the incoming cotangents are scattered
onto the argmin pairs through the analytic distance derivatives, in
O((N + M) C).

``mins`` is the wrapper: on a CUDA tensor it launches the kernel (and
counts the launch in ``launch.remd_mins``, a counter of
:mod:`strotss_torch.utils.timing`), on a CPU tensor it computes the same
function with :func:`mins_plain`. ``tf32_round``, ``tf32_split`` and
the ``frag_*`` / ``tc_tile_*`` maps state the tensor-core route's
arithmetic and layouts in Python, for the CPU tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import (
    _DIST_CODE,
    _L2DIST_EPS,
    check_cuda_f32,
    launch_on,
    normalize_rows,
    resolve_impl,
    stream_scratch,
)
from strotss_torch.ops.losses import dist_metrics
from strotss_torch.utils.timing import count

_TILE = 64  # csrc/tile.cuh TILE; also the tensor-core route's column tile
#: csrc/remd.cu: the tensor-core route's tile (TC_BM x TC_BN), the channels
#: of a shared-memory stage (TC_KC), the floats between its rows (TC_LD),
#: and the warps (4 x 2)
TC_BM, TC_BN, TC_KC, TC_LD = 128, 64, 32, 36
_TC_WARPS_M, _TC_WARPS_N = 4, 2
#: the C entry's routes, by their code in csrc/remd.cu
ROUTES = ("cuda_cores", "tensor_cores")


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 ``v`` rounded to 10 mantissa bits,
    to nearest with ties away from zero (the low 13 bits become 0);
    infinities and NaNs pass unchanged."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    return torch.where(mag >= 0x7F800000, bits, rounded).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """(big, small): the TF32 parts the tensor-core route multiplies, big =
    tf32_round(v) and small = tf32_round(v - big)."""
    big = tf32_round(v)
    return big, tf32_round(v.to(torch.float32) - big)


def frag_a(lane: int, i: int):
    """(row, k) of register ``i`` of lane ``lane`` in the 16 x 8 A fragment
    of ``mma.m16n8k8`` with TF32 operands (PTX ISA)."""
    g, t = divmod(lane, 4)
    return g + 8 * (i & 1), t + 4 * (i >> 1)


def frag_b(lane: int, i: int):
    """(k, col) of register ``i`` of lane ``lane`` in the 8 x 8 B fragment."""
    g, t = divmod(lane, 4)
    return t + 4 * i, g


def frag_c(lane: int, i: int):
    """(row, col) of f32 accumulator ``i`` of lane ``lane`` (16 x 8)."""
    g, t = divmod(lane, 4)
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def tc_tile_rc(warp: int, lane: int, mb: int, nb: int, i: int):
    """(row, col) in a block's TC_BM x TC_BN tile of accumulator
    ``acc[mb][nb][i]`` of ``lane`` in ``warp``: fragment row g + 8 h is tile
    row 4 g + 2 mb + h of the warp's 32, fragment column n tile column
    4 n + nb (csrc/remd.cu, above ``TcFrag``)."""
    wm, wn = divmod(warp, _TC_WARPS_N)
    r, c = frag_c(lane, i)
    g, h = r % 8, r // 8
    return wm * 32 + 4 * g + 2 * mb + h, wn * 32 + 4 * c + nb


def tc_smem_row(r: int) -> int:
    """Shared-memory row of tile row ``r`` (x rows, then y rows): the rows
    of a 32-row slab that share r % 4 are 8 consecutive rows."""
    return (r & ~31) | ((r & 3) << 3) | ((r & 31) >> 2)


def tc_shift(r: int, c: int) -> int:
    """Column of channel 0 of global row ``r`` in a stage (16-byte path):
    the row's misalignment in device memory, (r * C) % 4 floats."""
    return (r * c) % 4


def tc_smem_a(warp: int, lane: int, mb: int, i: int, kk: int, c: int,
              row0: int = 0) -> int:
    """Float offset in a stage of the x value that A register ``i`` of
    fragment ``mb`` reads at k8 step ``kk`` (x tile starting at ``row0``)."""
    r, k = frag_a(lane, i)
    wm = warp // _TC_WARPS_N
    row = wm * 32 + 4 * (r % 8) + 2 * mb + r // 8
    return tc_smem_row(row) * TC_LD + tc_shift(row0 + row, c) + kk + k


def tc_smem_b(warp: int, lane: int, nb: int, i: int, kk: int, c: int,
              col0: int = 0) -> int:
    """Float offset in a stage of the y value that B register ``i`` of
    fragment ``nb`` reads (the y rows follow the TC_BM x rows)."""
    k, n = frag_b(lane, i)
    col = warp % _TC_WARPS_N * 32 + 4 * n + nb
    return (tc_smem_row(TC_BM + col) * TC_LD + tc_shift(col0 + col, c) + kk
            + k)


def tc_chunks(shift: int):
    """The 16-byte chunks a row's stage comes in: (first column in the
    stage, first channel), channel k landing at column ``shift`` + k; a
    ninth chunk only where the row is misaligned."""
    return [(4 * j, 4 * j - shift) for j in range(TC_KC // 4 + (shift > 0))]


def route(c: int) -> str:
    """The route K1's C entry takes for ``c`` channels (builds the kernels
    at first use)."""
    return ROUTES[build.library("remd").remd_route(c)]


def tc_min_c() -> int:
    """The channel count from which K1 takes the tensor-core route."""
    return build.library("remd").remd_tc_min_c()


def tc_setups() -> int:
    """How many times K1's C entry has set the tensor-core kernel's
    shared-memory limit in this process: once per device."""
    return build.library("remd").remd_tc_setups()


def mins_plain(x: torch.Tensor, y: torch.Tensor, distance: str):
    """(rowmin, colmin, rowarg, colarg) from the materialized matrix."""
    c = dist_metrics[distance](x, y)
    rowmin, rowarg = torch.min(c, dim=1)
    colmin, colarg = torch.min(c, dim=0)
    return rowmin, colmin, rowarg.int(), colarg.int()


def _scratch_ptrs(device: torch.device, n: int, m: int, stream: int):
    """Pointers to rowpart_v, rowpart_i, colpart_v, colpart_i in one
    buffer kept per (device, n, m) and stream (``common.stream_scratch``)."""
    ntm, ntn = -(-m // _TILE), -(-n // _TILE)
    rv = stream_scratch(("remd", device.index, n, m), stream,
                        2 * (ntm * n + ntn * m), torch.int32,
                        device).data_ptr()
    ri = rv + 4 * ntm * n
    cv = ri + 4 * ntm * n
    return rv, ri, cv, cv + 4 * ntn * m


def mins(x: torch.Tensor, y: torch.Tensor, distance: str,
         route: Optional[str] = None):
    """(rowmin, colmin, rowarg, colarg): kernel K1 on CUDA tensors.

    ``route`` None lets the C entry choose by the channel count; one of
    ``ROUTES`` forces it (measurements and tests).
    """
    if distance not in _DIST_CODE:
        raise ValueError(f"unknown distance {distance!r}")
    if not x.is_cuda:
        return mins_plain(x, y, distance)
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be None or one of {ROUTES}, got "
                         f"{route!r}")
    n, c = x.shape
    m = y.shape[0]
    check_cuda_f32("x", x, (n, c))
    check_cuda_f32("y", y, (m, c))
    if y.device != x.device:
        raise ValueError("x and y must lie on the same device")
    # the tensor-core route reads 16-byte aligned windows of the rows: a
    # view that starts elsewhere (a slice of rows) is copied
    if x.data_ptr() % 16:
        x = x.clone()
    if y.data_ptr() % 16:
        y = y.clone()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    parts = _scratch_ptrs(x.device, n, m, stream)
    # the four outputs in one allocation: rowmin, colmin, rowarg, colarg
    out = torch.empty(2 * (n + m), dtype=torch.int32, device=x.device)
    rowmin = out[:n].view(torch.float32)
    colmin = out[n:n + m].view(torch.float32)
    rowarg, colarg = out[n + m:2 * n + m], out[2 * n + m:]
    launch_on(x.device, "remd_mins", x.data_ptr(), y.data_ptr(), n, m, c,
              _DIST_CODE[distance], -1 if route is None
              else ROUTES.index(route), *parts, rowmin.data_ptr(),
              rowarg.data_ptr(), colmin.data_ptr(), colarg.data_ptr(),
              stream)
    count("launch.remd_mins")
    return rowmin, colmin, rowarg, colarg


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
