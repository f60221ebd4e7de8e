"""Streamed Sinkhorn: CUDA kernel K4 (one LSE half-update), its plain
version, the transport read-out and the Danskin gradient.

Counterpart of ``strotss_tpu/ops/kernels/sinkhorn.py``. The materialized
Sinkhorn (:func:`strotss_torch.ops.losses.sinkhorn`, ``impl='plain'``)
keeps the N x M log-kernel and differentiates through the unrolled
iterations. Above the memory gate the port, like the JAX package, runs
every half-update as one streamed pass over the feature rows instead:

    lse_pass(x, y, logv)_i = LSE_j(-lam * d(x_i, y_j) + logv_j)

which kernel K4 (``csrc/sinkhorn.cu``, whose header states its bound and
design) computes without forming N x M. The iterations run in the JAX
package's Gauss-Seidel order (u from v, then v from the new u), and the
loss is the read-out ``sum_ij T_ij d_ij`` of the plan
``T = exp(log_u_i - lam * d_ij + log_v_j)``, in row blocks.

The operands of a solve are prepared once (:func:`prepare`, one launch for
x and y, counted in ``launch.sinkhorn_prep``): rows padded to a multiple of
``ROW_PAD``, channels to ``prep_channels(C)``, each value split into its
TF32 parts where the tensor cores take it (C >= ``TC_MIN_C``), and each
row's squared norm and its floored inverse square root.
:func:`prepare_plain` states the same layout in torch.

Gradient: the converged-plan (Danskin) gradient ``dL/dd_ij = T_ij``, the
gradient of the read-out with the plan held fixed. It costs one block-
streamed pass instead of differentiating through 2 * n_iter passes, and it
is not the unrolled gradient of the plain path (cosine ~0.9 with it at 30
iterations).

``lse_pass`` is the wrapper: on a CUDA tensor it launches K4 (and counts
the launch in ``launch.sinkhorn_lse``), on a CPU tensor it computes the same
function with :func:`lse_pass_plain`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import (
    _DIST_CODE,
    _L2NORM_EPS,
    check_cuda_f32,
    launch_on,
    round_up,
    stream_scratch,
)
from strotss_torch.ops.kernels.remd import tf32_split
from strotss_torch.ops.losses import dist_metrics
from strotss_torch.utils.timing import count

#: csrc/sinkhorn.cu: the channel count from which the tensor cores are
#: taken (SK_TC_MIN_C), the prepared rows' multiple (SK_ROW_PAD) and the
#: tensor-core route's channel multiple (SK_TC_CPAD); its x rows a block
#: (SK_BM), y columns a tile (SK_BN) and the 16-channel stages summed on
#: the tensor cores before their sums are added into f32 registers
#: (SK_PERIOD); the CUDA-core route's rows a block (SK_CC_ROWS x
#: SK_CC_TILE) and columns a tile (SK_CC_TILE)
TC_MIN_C, ROW_PAD, TC_CPAD = 32, 256, 32
TC_BM, TC_BN, TC_PERIOD = 128, 192, 8
CC_BM, CC_BN = 1024, 256
#: the routes, by their code in csrc/sinkhorn.cu
ROUTES = ("cuda_cores", "tensor_cores")
#: blocks an SM holds at once: one of the tensor-core route's (206 KB of
#: shared memory), four of the CUDA-core route's
_SLOTS = {"tensor_cores": 1, "cuda_cores": 4}
#: the cost of a split whose chunks differ in length against one whose
#: chunks are equal, by route: on the tensor cores such splits ran 1.2 to
#: 1.4 times as long at 32769 samples on an H100 (tools/k4_ablation.py;
#: the mechanism is not measured); on the CUDA cores no such effect showed
UNEVEN_COST = {"tensor_cores": 1.3, "cuda_cores": 1.0}
MAX_SPLIT = 16


def route(c: int) -> str:
    """The route K4 takes for ``c`` channels (by C alone)."""
    return ROUTES[int(c >= TC_MIN_C)]


def prep_channels(c: int) -> int:
    """The channels of a prepared row: C rounded up to 32 (128-byte rows,
    which TMA addresses) on the tensor-core route, to 4 (float4 rows)
    on the CUDA-core route."""
    return round_up(c, TC_CPAD if c >= TC_MIN_C else 4)


def tile_shape(c: int) -> Tuple[int, int]:
    """(rows, columns) of the work one block does a column tile."""
    return (TC_BM, TC_BN) if c >= TC_MIN_C else (CC_BM, CC_BN)


def chunk_tiles(q: int, tiles: int, split: int) -> range:
    """The column tiles of chunk ``q`` when a strip's ``tiles`` are split
    over ``split`` chunks (csrc/sinkhorn.cu ``sk_chunk``)."""
    return range(q * tiles // split, (q + 1) * tiles // split)


def lse_split(n: int, m: int, c: int, sms: int) -> int:
    """The chunks S each strip's column tiles are split over, at ``sms``
    SMs (:func:`split_for` of the strips, the column tiles and the blocks
    the card holds at once)."""
    bm, bn = tile_shape(c)
    return split_for(-(-n // bm), -(-m // bn), sms * _SLOTS[route(c)],
                     UNEVEN_COST[route(c)])


def split_for(strips: int, tiles: int, slots: int, uneven: float) -> int:
    """S from 1 to min(tiles, MAX_SPLIT) with the fewest tile times on the
    busiest slot: rounds of blocks ceil(strips S / slots) times the tiles
    of a chunk ceil(tiles / S), times ``uneven`` where S does not divide
    the tiles. Ties go to the fewest slots left idle in the last round,
    then to the smaller S."""
    def key(s):
        rounds = -(-strips * s // slots)
        cost = rounds * -(-tiles // s) * (uneven if tiles % s else 1.0)
        return cost, rounds * slots - strips * s, s

    return min(range(1, min(tiles, MAX_SPLIT) + 1), key=key)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class PreparedRows(NamedTuple):
    """One operand of K4 in its prepared layout."""

    #: tensor-core route: (2, rows, C') TF32 parts, big then small;
    #: CUDA-core route: (rows, C') float32 values; zero past n and C
    parts: torch.Tensor
    #: (2, rows): |row|^2 and 1 / sqrt(max(|row|^2, 1e-12))
    norms: torch.Tensor
    n: int  # the real rows
    c: int  # the real channels


def prepare_plain(x: torch.Tensor) -> PreparedRows:
    """K4's prepared layout of ``x`` (N, C) in torch (the norms summed in
    torch's order, not the kernel's)."""
    n, c = x.shape
    rows, cp = round_up(n, ROW_PAD), prep_channels(c)
    v = x.new_zeros((rows, cp), dtype=torch.float32)
    v[:n, :c] = x
    sq = torch.sum(v * v, dim=1)
    norms = torch.stack([sq, 1.0 / torch.sqrt(torch.clamp(sq,
                                                          min=_L2NORM_EPS))])
    parts = torch.stack(tf32_split(v)) if c >= TC_MIN_C else v
    return PreparedRows(parts, norms, n, c)


def prepare(x: torch.Tensor, y: torch.Tensor
            ) -> Optional[Tuple[PreparedRows, PreparedRows]]:
    """(x, y) prepared for K4 by one kernel launch (counted in
    ``launch.sinkhorn_prep``), in one allocation; None for CPU tensors, whose
    passes take the plain version."""
    if not x.is_cuda:
        return None
    n, c = x.shape
    m = y.shape[0]
    check_cuda_f32("x", x, (n, c))
    check_cuda_f32("y", y, (m, c))
    if y.device != x.device:
        raise ValueError("x and y must lie on the same device")
    cp, k = prep_channels(c), 2 if c >= TC_MIN_C else 1
    rx, ry = round_up(n, ROW_PAD), round_up(m, ROW_PAD)
    buf = torch.empty(k * (rx + ry) * cp + 2 * (rx + ry),
                      dtype=torch.float32, device=x.device)
    shape = (k, -1, cp) if k == 2 else (-1, cp)
    px = buf[:k * rx * cp].view(shape)
    py = buf[k * rx * cp:k * (rx + ry) * cp].view(shape)
    nx = buf[k * (rx + ry) * cp:][:2 * rx].view(2, rx)
    ny = buf[k * (rx + ry) * cp + 2 * rx:].view(2, ry)
    launch_on(x.device, "sinkhorn_prep", x.data_ptr(), n, y.data_ptr(), m,
              c, px.data_ptr(), nx.data_ptr(), rx, py.data_ptr(),
              ny.data_ptr(), ry,
              torch.cuda.current_stream(x.device).cuda_stream)
    count("launch.sinkhorn_prep")
    return PreparedRows(px, nx, n, c), PreparedRows(py, ny, m, c)


def tc_setups() -> int:
    """How many times K4's C entry has set a tensor-core kernel's
    shared-memory limit in this process: once per device and kernel."""
    return build.library("sinkhorn").sinkhorn_setups()


def lse_pass_plain(x: torch.Tensor, y: torch.Tensor, logv: torch.Tensor,
                   lam: float, distance: str) -> torch.Tensor:
    """(N,) ``LSE_j(-lam * dist(x, y)_ij + logv_j)`` from the materialized
    N x M distance matrix."""
    d = dist_metrics[distance](x, y)
    return torch.logsumexp(-lam * d + logv[None, :], dim=1)


def lse_pass(x: torch.Tensor, y: torch.Tensor, logv: torch.Tensor,
             lam: float, distance: str,
             prep: Optional[Tuple[PreparedRows, PreparedRows]] = None,
             split: Optional[int] = None) -> torch.Tensor:
    """(N,) ``LSE_j(-lam * dist(x, y)_ij + logv_j)``: kernel K4 on CUDA
    tensors. The LSE over rows is the same call with x and y swapped.

    ``prep`` is :func:`prepare` ``(x, y)`` (swapped with x and y); None
    prepares them here, one launch more. ``split`` None takes
    :func:`lse_split`'s chunks. With ``prep`` the call allocates its
    output only; the chunks' partial results live in a scratch kept per
    shape and stream.
    """
    if distance not in _DIST_CODE:
        raise ValueError(f"unknown distance {distance!r}")
    if not x.is_cuda:
        return lse_pass_plain(x, y, logv, lam, distance)
    n, c = x.shape
    m = y.shape[0]
    check_cuda_f32("logv", logv, (m,))
    if logv.device != x.device:
        raise ValueError("x, y and logv must lie on the same device")
    if prep is None:
        prep = prepare(x, y)
    px, py = prep
    if (px.n, py.n, px.c, py.c) != (n, m, c, c) or (
            px.parts.device != x.device or py.parts.device != x.device):
        raise ValueError("prep does not hold x and y in this order")
    if split is None:
        split = lse_split(n, m, c, _sms(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = stream_scratch(("sinkhorn", x.device.index, n, split), stream,
                          2 * split * n, torch.float32, x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    launch_on(x.device, "sinkhorn_lse", px.parts.data_ptr(),
              px.norms.data_ptr(), px.norms.shape[1], py.parts.data_ptr(),
              py.norms.data_ptr(), py.norms.shape[1], logv.data_ptr(), n, m,
              c, _DIST_CODE[distance], float(lam), split, part.data_ptr(),
              out.data_ptr(), stream)
    count("launch.sinkhorn_lse")
    return out


def transport_readout(x: torch.Tensor, y: torch.Tensor, log_u: torch.Tensor,
                      log_v: torch.Tensor, lam: float, distance: str,
                      block: int = 512, freeze_plan: bool = False):
    """``sum_ij exp(log_u_i - lam * d_ij + log_v_j) * d_ij`` in blocks of
    ``block`` rows (peak memory O(block * M)).

    The JAX package pads the last block with rows of log_u = -3.4e38,
    whose plan mass is exactly 0; a ragged last block sums the same terms.
    ``freeze_plan=True`` detaches the plan T, so that autograd sees only
    the explicit ``sum T * d`` dependence: the Danskin gradient.
    """
    m_dist = dist_metrics[distance]
    total = x.new_zeros(())
    for i in range(0, x.shape[0], block):
        d = m_dist(x[i:i + block], y)
        t = torch.exp(log_u[i:i + block, None] - lam * d + log_v[None, :])
        if freeze_plan:
            t = t.detach()
        total = total + torch.sum(t * d)
    return total


class SinkhornStreamed(torch.autograd.Function):
    """Entropic OT cost through streamed passes, with the Danskin VJP."""

    @staticmethod
    def forward(ctx, x, y, distance: str, lam: float, n_iter: int):
        """``n_iter`` Gauss-Seidel iterations from zero potentials and
        uniform marginals, then the read-out."""
        n, m = x.shape[0], y.shape[0]
        f32 = dict(dtype=torch.float32, device=x.device)
        log_p = torch.full((n,), -math.log(n), **f32)
        log_q = torch.full((m,), -math.log(m), **f32)
        log_u, log_v = torch.zeros(n, **f32), torch.zeros(m, **f32)
        prep = prepare(x, y)
        swapped = None if prep is None else prep[::-1]
        for _ in range(n_iter):
            log_u = log_p - lse_pass(x, y, log_v, lam, distance, prep)
            log_v = log_q - lse_pass(y, x, log_u, lam, distance, swapped)
        del prep, swapped
        ctx.save_for_backward(x, y, log_u, log_v)
        ctx.distance, ctx.lam = distance, lam
        return transport_readout(x, y, log_u, log_v, lam, distance)

    @staticmethod
    def backward(ctx, g):
        """``g`` times the gradient of the frozen-plan read-out, one row
        block at a time (each block's graph is freed before the next)."""
        x, y, log_u, log_v = ctx.saved_tensors
        need_x, need_y = ctx.needs_input_grad[:2]
        dx = torch.zeros_like(x) if need_x else None
        dy = torch.zeros_like(y) if need_y else None
        yl = y.detach().requires_grad_(need_y)
        block = 512
        with torch.enable_grad():
            for i in range(0, x.shape[0], block):
                xb = x[i:i + block].detach().requires_grad_(need_x)
                part = transport_readout(xb, yl, log_u[i:i + block], log_v,
                                         ctx.lam, ctx.distance, block,
                                         freeze_plan=True)
                leaves = [t for t, need in ((xb, need_x), (yl, need_y))
                          if need]
                grads = list(torch.autograd.grad(part, leaves))
                if need_x:
                    dx[i:i + block] = grads.pop(0)
                if need_y:
                    dy += grads.pop(0)
        return (g * dx if need_x else None, g * dy if need_y else None,
                None, None, None)


def sinkhorn_streamed(x: torch.Tensor, y: torch.Tensor,
                      distance: str = "cosine", lam: float = 10.0,
                      n_iter: int = 30) -> torch.Tensor:
    """Entropic OT cost ``<T, d>`` without an N x M buffer in the
    iterations; the gradient is the converged-plan (Danskin) one."""
    return SinkhornStreamed.apply(x.float().contiguous(),
                                  y.float().contiguous(), distance,
                                  float(lam), int(n_iter))
