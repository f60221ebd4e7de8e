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
the launches (``launch.selfsim_fwd``, ``launch.selfsim_bwd``); on CPU
tensors they compute the same with the materialized plain versions below.
The normalization, the column sums and the pull-back through the
normalization stay in PyTorch, as the JAX package keeps them outside its
kernels.

On the card the signs are an (N, N) view of an (N, sp) buffer whose row
pitch sp is a multiple of ``SIGN_PITCH`` bytes. The ``fwd_*`` maps state
K2a's tile schedule, partial slots, stage and fragment layouts and sign
stores in Python, and the ``bwd_*`` maps K2b's thread, fragment and
shared-memory layouts, for the CPU tests.
"""

from __future__ import annotations

import functools

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
from strotss_torch.ops.kernels.remd import (
    TC_KC,
    TC_LD,
    frag_a,
    frag_b,
    frag_c,
    tc_shift,
    tc_smem_row,
)
from strotss_torch.ops.losses import cosine_distance, mae
from strotss_torch.utils.timing import count

#: csrc/selfsim.cu SB_PITCH: the signs' row pitch in bytes is a multiple
SIGN_PITCH = 64
#: csrc/selfsim.cu, K2a: the rows of a tile I or J (SF_TILE), the tile
#: columns of a band of the schedule (SF_BAND), the floats between rows of
#: the epilogue's P and Q tiles (SF_LDE), the threads
SF_TILE, SF_BAND, SF_LDE, SF_THREADS = 64, 16, 65, 256
#: the blocks a tile pair K2a's C entry takes (a cluster of that many
#: blocks, each a share of the channels)
FWD_SPLITS = (1, 2, 4)
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


def _fwd_scratch(device: torch.device, n: int, ks: int, stream: int):
    """Pointers to total_part (one float a block), tx_part and ty_part (a
    row group of 64 / ks rows by n each) in one buffer kept per (device,
    n, ks) and stream (``common.stream_scratch``). Every slot is written by
    every call."""
    nt = -(-n // SF_TILE)
    blocks = ks * fwd_blocks(nt)
    total = stream_scratch(("selfsim_fwd", device.index, n, ks), stream,
                           blocks + 2 * ks * nt * n, torch.float32,
                           device).data_ptr()
    return total, total + 4 * blocks, total + 4 * (blocks + ks * nt * n)


def fwd_setups() -> int:
    """How many times K2a's C entry has set its kernels' shared-memory
    limits in this process: once per device."""
    return build.library("selfsim").selfsim_fwd_setups()


def fwd_split(n: int, sms: int) -> int:
    """The blocks a tile pair (1, 2 or 4) K2a takes at ``n`` samples on a
    card with ``sms`` SMs: the fewest rounds of blocks on the busiest SM,
    ceil(pairs ks / sms), a round of ks blocks a pair costing 1 / ks of a
    whole pair's and 10% more for each block beyond the first (the added
    loads, sums and epilogue); ties to fewer blocks: 4 at N = 1000 and
    1024, 2 at 1500, 1 at 2048 and up on an H100 (132 SMs). There
    ``tools/k2a_ablation.py``'s sweep over N = 512 to 8192 found it the
    fastest split at 8 of 12 sizes and within 8% at the others (512, 960,
    1280, 2500; PERF.md)."""
    nt = -(-n // SF_TILE)
    pairs = fwd_blocks(nt)
    cost = {ks: -(-pairs * ks // sms) * (9 + ks) * (4 // ks)
            for ks in FWD_SPLITS}
    return min(FWD_SPLITS, key=lambda ks: (cost[ks], ks))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def selfsim_fwd(xh, yh, cx, cy, split=None):
    """(loss, t_x, t_y, signs): kernel K2a on CUDA tensors. ``split`` None
    takes :func:`fwd_split`'s blocks a tile pair; one of ``FWD_SPLITS``
    forces it (measurements and tests)."""
    if not xh.is_cuda:
        return selfsim_fwd_plain(xh, yh, cx, cy)
    n, c = _check(xh, yh, cx, cy)
    if split is not None and split not in FWD_SPLITS:
        raise ValueError(f"split must be None or one of {FWD_SPLITS}, got "
                         f"{split!r}")
    ks = fwd_split(n, _sms(xh.device.index)) if split is None else split
    # the kernel reads 16-byte aligned windows of the rows: a view that
    # starts elsewhere (a slice of rows) is copied
    if xh.data_ptr() % 16:
        xh = xh.clone()
    if yh.data_ptr() % 16:
        yh = yh.clone()
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    parts = _fwd_scratch(xh.device, n, ks, stream)
    out = torch.empty(1 + 2 * n, dtype=torch.float32, device=xh.device)
    loss, tx, ty = out[0], out[1:n + 1], out[n + 1:]
    sp = round_up(n, SIGN_PITCH)
    signs = torch.empty((n, sp), dtype=torch.int8, device=xh.device)
    launch_on(xh.device, "selfsim_fwd", xh.data_ptr(), yh.data_ptr(),
              cx.data_ptr(), cy.data_ptr(), n, c, *parts, loss.data_ptr(),
              tx.data_ptr(), ty.data_ptr(), signs.data_ptr(), sp, ks,
              stream)
    count("launch.selfsim_fwd")
    return loss, tx, ty, signs[:, :n]


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
    count("launch.selfsim_bwd")
    return u[0], u[1]


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


# ---- K2a's layouts (csrc/selfsim.cu), for the CPU tests -------------------


def fwd_blocks(nt: int) -> int:
    """K2a's blocks for ``nt`` row tiles: the tile pairs (I, J), I <= J."""
    return nt * (nt + 1) // 2


def fwd_tile(b: int, nt: int):
    """(I, J) of K2a's block ``b`` (csrc/selfsim.cu ``fwd_tile``): the
    triangle walked in bands of SF_BAND tile columns; in a band rows I from
    0 up, in each row the band's columns J >= I."""
    k0, w = 0, min(SF_BAND, nt)
    while b >= k0 * w + w * (w + 1) // 2:
        b -= k0 * w + w * (w + 1) // 2
        k0 += w
        w = min(SF_BAND, nt - k0)
    if b < k0 * w:
        return b // w, k0 + b % w
    b -= k0 * w
    i = 0
    while b >= w - i:
        b -= w - i
        i += 1
    return k0 + i, k0 + i + b


def fwd_t_slot(tid: int, ti: int, tj: int, n: int, ks: int = 1,
               q: int = 0):
    """The t partial that thread ``tid`` of block ``q`` of pair (I, J)
    writes: ('tx' or 'ty', row group G of 64 / ks rows, column), or None.
    Threads 0..127 take t_x and t_y of the direct orientation (G = the
    block's rows of I, columns of J), threads 128..255 those of the
    transposed one (G one of J's ks row groups, columns the block's rows of
    I; not on the diagonal)."""
    r = SF_TILE // ks
    if tid < 2 * SF_TILE:
        gc = tj * SF_TILE + tid % SF_TILE
        return (("ty" if tid >= SF_TILE else "tx"), ks * ti + q, gc) \
            if gc < n else None
    if ti == tj:
        return None
    u = tid - 2 * SF_TILE
    grp, ci = (u % SF_TILE) // r, u % r
    gc = ti * SF_TILE + q * r + ci
    return (("ty" if u >= SF_TILE else "tx"), ks * tj + grp, gc) \
        if gc < n else None


def fwd_total_slot(b: int, ks: int = 1, q: int = 0) -> int:
    """The loss partial block ``q`` of pair ``b`` writes (its blockIdx);
    the reduction reads slots 0 .. ks * fwd_blocks(nt) - 1 in order."""
    return ks * b + q


def fwd_tile_rc(warp: int, lane: int, mb: int, nb: int, i: int):
    """(Gram 0 for P or 1 for Q, row in I, column in J) of accumulator
    ``acc[mb][nb][i]`` of ``lane`` in ``warp`` (warps 0..3 P, 4..7 Q, each
    2 x 2 of 32 x 32; K1's fragment-to-tile map)."""
    gram, w = divmod(warp, 4)
    wm, wn = divmod(w, 2)
    r, c = frag_c(lane, i)
    return gram, 32 * wm + 4 * (r % 8) + 2 * mb + r // 8, 32 * wn + 4 * c + nb


def _fwd_stage_offset(row: int, k: int, c: int) -> int:
    # stage rows: x^_I 0..63, x^_J 64..127, y^_I 128..191, y^_J 192..255
    return tc_smem_row(row) * TC_LD + tc_shift(row, c) + k


def fwd_smem_a(warp: int, lane: int, mb: int, i: int, kk: int, c: int):
    """Float offset in a stage of the value A register ``i`` of fragment
    ``mb`` reads at k8 step ``kk``: an I row of x^ (warps 0..3) or y^."""
    r, k = frag_a(lane, i)
    gram, w = divmod(warp, 4)
    row = 128 * gram + 32 * (w // 2) + 4 * (r % 8) + 2 * mb + r // 8
    return _fwd_stage_offset(row, kk + k, c)


def fwd_smem_b(warp: int, lane: int, nb: int, i: int, kk: int, c: int,
               diag: bool = False):
    """Float offset in a stage of the value B register ``i`` of fragment
    ``nb`` reads: a J row, or on a diagonal tile the same I row."""
    k, col = frag_b(lane, i)
    gram, w = divmod(warp, 4)
    row = (128 * gram + (0 if diag else SF_TILE) + 32 * (w % 2) + 4 * col
           + nb)
    return _fwd_stage_offset(row, kk + k, c)


def fwd_copies(tid: int, c: int):
    """The 16-byte copies thread ``tid`` issues for a stage: (stage row,
    first column in the row, float offset in the stage). Chunk tid % 8 of
    rows tid / 8 + 32 q of each 128-row half (x^ rows, then y^ rows), and
    chunk 8 of row tid % 128 of its own half where that row is misaligned
    (threads 0..127 the x^ half, 128..255 the y^ half)."""
    lr, ch = divmod(tid, 8)
    out = []
    for half in (0, 128):
        for q in range(4):
            row = half + lr + 32 * q
            out.append((row, 4 * ch, tc_smem_row(row) * TC_LD + 4 * ch))
    r8 = (tid & 127) + (tid & 128)
    if tc_shift(r8, c):
        out.append((r8, TC_KC, tc_smem_row(r8) * TC_LD + TC_KC))
    return out


def fwd_epilogue(tid: int, k: int, transposed: bool, ks: int = 1):
    """Element ``k`` of thread ``tid`` in one orientation of a block with
    ``ks`` blocks a pair (R = 64 / ks rows of I each): (row i among the
    block's R, column j in J) of the P and Q element it reads, its float
    offset in the block's P rows, its byte in the staged sign tile (rows
    64 bytes apart, transposed R), and the element (row, column) it stands
    for, relative to (the block's first row, j0) directly and to (j0, the
    block's first row) transposed."""
    r = SF_TILE // ks
    nk = r // 4
    if transposed:
        ci, rj = tid % r, tid // r
        i, j = ci, rj * nk + k
        return i, j, i * SF_LDE + j, j * r + ci, (j, i)
    col, rg = tid % SF_TILE, tid // SF_TILE
    i, j = rg * nk + k, col
    return i, j, i * SF_LDE + j, i * SF_TILE + j, (i, j)


def fwd_sign_stores(u: int, ks: int = 1):
    """The 16-byte chunk ``u`` (0 .. 4 R - 1, R = 64 / ks) of each staged
    sign tile: (tile row, first tile column, byte offset in the staged
    tile) of s[rows of I, J] and of s[J, rows of I]."""
    r = SF_TILE // ks
    row, h = divmod(u, 4)
    j, hj = divmod(u, r // 16)
    return ((row, 16 * h, row * SF_TILE + 16 * h),
            (j, 16 * hj, j * r + 16 * hj))
