"""One stylization's VGG stack split by image height over ranks, the
counterpart of ``strotss_tpu/programs.py:586-602``
(``_shard_spatial_constraint``) and of the mesh's 'spatial' axis
(``strotss_tpu/parallel/mesh.py:11-14``).

The JAX package puts one GSPMD sharding constraint on each image's
height, and XLA splits every convolution and pooling, forward and
backward, with halo exchanges. The port runs one process a device, so it
writes them here. Every rank of the 'spatial' group holds the whole
image, the whole pyramid and the whole (n, C) sample rows; only the VGG
activations are split.

**The slab plan** (:func:`slab_bounds`). Rank r owns image rows
``[s_r, e_r)``. Every boundary is a multiple of ``2^k``, k the number of
poolings before the deepest tap (4 for block5_conv3, 0 for
block1_conv1), so every pooling splits cleanly: the rows' units of
``2^k`` are balanced as ``torch.tensor_split`` balances them, the ragged
last unit goes to the last rank that has rows, and ranks without rows
come last. After j poolings rank r owns ``[s_r >> j, e_r >> j)``; those
heights add up to the image's pooled height ``H >> j``. A rank with rows
at the image's resolution may have none at a deep level (43 rows on 3
ranks: 16/16/11, 1/1/0 after four poolings); the ranks that have rows at
a level are always the first ones.

**Block1 on a slab, K3a and K3b unchanged.** Each rank takes its rows of
the replicated image with up to 4 extra rows a side, clipped to the
image (``img[max(0, s-4) : min(H, e+4)]``), runs block1 on that as on a
whole image (kernel K3a on the card, or two ``F.conv2d``) and crops both
taps to ``[s, e)``. Tap1 on ``[s-1, e+1)`` needs image rows
``[s-2, e+2)``, all present, and tap2 on ``[s, e)`` needs tap1 on
``[s-1, e+1)``: the cropped taps are the whole image's. At a true image
edge the kernel's own SAME padding is the image's; at an interior edge
the zeros it pads lie out of reach of every kept value. The JAX Pallas
kernel does the same with strips and halo rows
(``strotss_tpu/ops/kernels/block1.py:33-43``).

In the backward of the ``F.conv2d`` route (float32) the crop's
cotangents, zero outside ``[s, e)``, go back through both convolutions on
the extended slab. They reach tap1's rows ``[s-1, e+1)`` and the image
rows ``[s-2, e+2)`` only, all inside the slab, so the slab's dx is this
rank's share of the whole image's dx, its extra rows included. On the
fused route K3b rounds dy1 to bf16, and two ranks' shares of a boundary
row rounded apart are not the whole row rounded once (2e-3 of max|dx|
on the CPU's plain version). So there each rank fetches the cotangents
of the 2 rows a side it lacks from their owners and K3b computes dx on
its own rows from the whole image's cotangents (:class:`_FusedBlock1`);
it drops dx on the extra rows. Either way the slice puts dx into a zero
image gradient, and one all-reduce of that (H, W, 3) gradient over the
group gives every rank the same whole gradient
(:class:`strotss_torch.parallel.transport._Replicated`): the RMSprop
update and the pyramid stay bit for bit equal across ranks.

**Blocks 2-5** (:class:`_HaloConv`). Each convolution receives its
neighbours' boundary rows (zero rows at the image's edge and where the
neighbour has no rows) in one ``all_gather_into_tensor`` of every rank's
first and last row, and runs ``F.conv2d(..., padding=(0, 1))`` on the
slab between them: the whole image's SAME convolution on these rows. Its
backward is the transposed convolution onto the padded slab; each halo
row's gradient goes back to the rank that owns the row in a second
all-gather and is added to that row's gradient. The Function keeps only
the kernel: the transposed convolution needs no input. A convolution or
pooling on a slab without rows launches nothing, but the rank still
takes part in every exchange.

**Sampling** (:meth:`SlabColumns.sample`). The coordinate factors come
from the global map shapes, never a slab's (the factor axis depends on
whether a height is a power of two). Each sample has one owner, the rank
that owns its (clipped) row: the nearest row, or the bilinear corner
``x0``. Each tap map gets the next rank's first row
(:class:`_NextRow`), so the owner of ``x0`` also holds ``x1 = x0 + 1``
and blends the four corners in ``bilinear_gather``'s order; the other
ranks give zeros, and one all-reduce of the (n, C) tap rows sums them.
x + 0 is exact, so the rows are the unsharded rows bit for bit, given
the same maps. In the backward every rank holds the whole row gradient
(the all-reduce's backward is the identity: the loss is replicated, and
a sum would scale it by p), and scatters it into the rows it owns and
into the halo row, whose gradient goes back to its owner. The image
channels are replicated and sampled locally.

**Order of collectives.** Every rank runs the same autograd graph (a
rank without rows runs it on empty tensors), so the engine runs the
backward's exchanges in the same order on every rank; under ``remat`` the
recompute runs the whole forward again, its exchanges in the same order
(``torch.utils.checkpoint``'s early stop is switched off for it).
``torch.distributed.nn`` is not used (its all-gather's backward scales a
replicated loss's gradient by p). Exchanges move bytes, so any dtype
travels over gloo and NCCL alike.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.grad import conv2d_input

from strotss_torch.ops.kernels import block1 as _K3
from strotss_torch.ops.kernels.common import resolve_impl
from strotss_torch.ops.sampling import (
    bilinear_corners,
    coordinate_factors,
    sample_hypercolumn,
)
from strotss_torch.parallel.transport import _Replicated, _Summed


def slab_bounds(height: int, parts: int, depth: int) -> List[Tuple[int,
                                                                    int]]:
    """Each of ``parts`` ranks' image rows ``(start, stop)``: units of
    ``2^depth`` rows balanced as ``torch.tensor_split`` balances them, the
    ragged last unit on the last rank that has rows, empty ranks last."""
    unit = 1 << depth
    units = -(-height // unit)
    out, lo = [], 0
    for r in range(parts):
        hi = min(height, lo + (units // parts + (r < units % parts)) * unit)
        out.append((lo, hi))
        lo = hi
    return out


#: extra image rows a side of each rank's slab for block1 (the fused
#: route needs 4: :class:`_FusedBlock1`)
EXTRA = 4


def tap_level(tap: str) -> int:
    """Poolings before the tap ``block{b}_conv{c}``: b - 1."""
    return int(tap[5]) - 1


def depth_of(taps: Sequence[str]) -> int:
    """Poolings before the deepest of ``taps``: 4 for block5_conv3, 0 for
    block1 taps."""
    return max(tap_level(t) for t in taps)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(p, *t.shape): every rank's ``t``, moved as bytes."""
    p = dist.get_world_size(group)
    flat = t.contiguous().view(-1).view(torch.uint8)
    out = flat.new_empty((p * flat.numel(),))
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(t.dtype).view((p,) + tuple(t.shape))


class Slab:
    """This rank's rows of one image of height ``height`` split over the
    process group ``group`` for a VGG that pools ``depth`` times."""

    def __init__(self, height: int, group, depth: int):
        self.height, self.group = int(height), group
        self.rank = dist.get_rank(group)
        self.bounds = slab_bounds(self.height, dist.get_world_size(group),
                                  depth)

    def counts(self, level: int) -> List[int]:
        """Every rank's number of rows after ``level`` poolings."""
        return [(e >> level) - (s >> level) for s, e in self.bounds]

    def rows(self, level: int) -> Tuple[int, int]:
        """This rank's rows ``(start, stop)`` after ``level`` poolings."""
        s, e = self.bounds[self.rank]
        return s >> level, e >> level

    def _extent(self) -> Tuple[int, int]:
        """The rows of the extended slab: this rank's and up to
        :data:`EXTRA` more a side, clipped to the image (none without
        rows)."""
        s, e = self.rows(0)
        if e == s:
            return s, s
        return max(0, s - EXTRA), min(self.height, e + EXTRA)

    def extended(self, x: torch.Tensor) -> torch.Tensor:
        """The extended slab's rows of the replicated NHWC image ``x``; its
        gradient is summed over the group into the whole image's."""
        lo, hi = self._extent()
        return _Replicated.apply(x, self.group).narrow(1, lo, hi - lo)

    def block1(self, run, x: torch.Tensor, n_out: int, channels: int):
        """``run(x)``'s NCHW outputs (block1's ``F.conv2d`` convolutions on
        the extended slab ``x``, NCHW) cropped to this rank's rows;
        ``n_out`` empty outputs of ``channels`` without rows, and ``run``
        is not called."""
        s, e = self.rows(0)
        if e == s:
            shape = (x.shape[0], channels, 0, x.shape[3])
            return [_Empty.apply(x, shape) for _ in range(n_out)]
        lo = self._extent()[0]
        return [y.narrow(2, s - lo, e - s) for y in run(x)]

    def fused_block1(self, x: torch.Tensor, k1, b1, k2, b2,
                     impl: str = "auto"):
        """Fused block1 (kernel K3a forward, K3b backward, or their plain
        versions: :func:`strotss_torch.ops.kernels.block1.block1`'s
        ``impl``) of the extended slab ``x`` (NHWC): both taps on this
        rank's rows, (B, e - s, W, 64), and in the backward the image
        gradient of this rank's rows (:class:`_FusedBlock1`)."""
        use_kernel = resolve_impl(impl, x) == "kernel"
        return _FusedBlock1.apply(x.contiguous(), k1.contiguous(), b1,
                                  k2.contiguous(), b2, use_kernel, self)

    def conv(self, h: torch.Tensor, kernel: torch.Tensor,
             level: int) -> torch.Tensor:
        """SAME 3x3 convolution (no bias) of this rank's NCHW rows ``h``
        at ``level``, with the halo exchange."""
        return _HaloConv.apply(h, kernel, self.counts(level), self.rank,
                               self.group)

    @staticmethod
    def pool(h: torch.Tensor) -> torch.Tensor:
        """2x2 max pooling of this rank's rows (none below 2 rows)."""
        if h.shape[2] < 2:
            return h[:, :, :0, :h.shape[3] // 2]
        return F.max_pool2d(h, kernel_size=2, stride=2)

    def shape(self, level: int, width: int) -> Tuple[int, int]:
        """The whole map's (height, width) after ``level`` poolings."""
        for _ in range(level):
            width //= 2
        return self.height >> level, width


class _FusedBlock1(torch.autograd.Function):
    """Block1 through K3 on the extended slab, cropped to this rank's rows
    ``[s, e)``; the backward gives the whole image's gradient on those
    rows, bit for bit where K3b's sums do not depend on the tile.

    The forward's taps are right on ``[s - 2, e + 2)`` (the extended slab
    has 4 extra rows a side: tap2 there reads tap1 on ``[s - 3, e + 3)``,
    which reads the image on ``[s - 4, e + 4)``). The backward takes the
    cotangents of both taps on ``[s - 2, e + 2)``: its own rows, and 2
    rows a side from the ranks that own them, in one all-gather of every
    rank's first 2 and last 2 rows. With the ReLU masks right there, dz2
    is right on ``[s - 2, e + 2)``, dy1 on ``[s - 1, e + 1)`` and dx on
    ``[s, e)``, each rounded to bf16 where the whole image's is, from the
    same sums; dx outside ``[s, e)`` is dropped, so the slice's all-reduce
    adds rows of one rank each."""

    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2, use_kernel, slab):
        ctx.slab, ctx.use_kernel = slab, use_kernel
        s, e = slab.rows(0)
        if e == s:
            ctx.shape = x.shape
            empty = x.new_zeros((x.shape[0], 0, x.shape[2], 64))
            ctx.save_for_backward(empty, empty, k1, k2)
            return empty, empty.clone()
        fwd = _K3.block1_fwd if use_kernel else _K3.block1_plain
        tap1, tap2 = fwd(x, k1, b1, k2, b2)
        ctx.save_for_backward(tap1, tap2, k1, k2)
        lo = slab._extent()[0]
        return tap1.narrow(1, s - lo, e - s), tap2.narrow(1, s - lo, e - s)

    @staticmethod
    def backward(ctx, g1, g2):
        tap1, tap2, k1, k2 = ctx.saved_tensors
        slab = ctx.slab
        s, e = slab.rows(0)
        lo, hi = slab._extent()
        near = [j for j in range(max(0, s - 2), min(slab.height, e + 2))
                if not s <= j < e]
        rows = _rows_of_others(g1, g2, slab, near)
        zero = [None] * 6
        if e == s:
            return (torch.zeros(ctx.shape, dtype=g1.dtype,
                                device=g1.device), *zero)
        cot = []
        for i, g in enumerate((g1, g2)):
            full = g.new_zeros((g.shape[0], hi - lo) + tuple(g.shape[2:]))
            full[:, s - lo:e - lo] = g
            for j, row in zip(near, rows):
                full[:, j - lo] = row[..., 64 * i:64 * (i + 1)]
            cot.append(full)
        bwd = _K3.block1_bwd if ctx.use_kernel else _K3.block1_bwd_plain
        dx = bwd(tap1, tap2, cot[0], cot[1], k1, k2)
        dx[:, :s - lo] = 0
        dx[:, e - lo:] = 0
        return (dx, *zero)


def _rows_of_others(g1: torch.Tensor, g2: torch.Tensor, slab: Slab,
                    rows: Sequence[int]):
    """Rows ``rows`` (global, each within 2 rows of this rank's own) of two
    (B, n, W, 64) maps split over the group as ``slab`` splits the image,
    ``g1`` and ``g2`` this rank's rows, side by side on the last axis: one
    all-gather of every rank's first 2 and last 2 rows."""
    n = g1.shape[1]
    if n:
        ends = [min(i, n - 1) if i < 2 else max(n - 4 + i, 0)
                for i in range(4)]
        edge = torch.stack([torch.cat([g1[:, i], g2[:, i]], -1)
                            for i in ends])
    else:
        edge = g1.new_zeros((4, g1.shape[0], g1.shape[2], 128))
    got = _all_gather(edge, slab.group)
    out = []
    for j in rows:
        q = next(q for q, (a, b) in enumerate(slab.bounds) if a <= j < b)
        a, b = slab.bounds[q]
        out.append(got[q, j - a] if j - a < 2 else got[q, 4 - (b - j)])
    return out


class _Empty(torch.autograd.Function):
    """Zeros of ``shape`` (with no rows) that depend on ``x``: a slab
    without rows skips block1 but stays in the graph, so that its rank
    takes part in every exchange of the backward."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.like = (x.shape, x.dtype, x.device)
        return x.new_zeros(shape)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device), None


def _neighbours(x: torch.Tensor, dim: int, counts, rank: int, group):
    """The row above this rank's rows ``x`` along ``dim`` and the row
    below, each with ``dim`` kept (size 1): the neighbours' boundary
    rows, zeros at the image's edge and where the neighbour has none."""
    h = x.shape[dim]
    rest = x.shape[:dim] + x.shape[dim + 1:]
    if h:
        edge = torch.stack([x.select(dim, 0), x.select(dim, h - 1)])
    else:
        edge = x.new_zeros((2,) + rest)
    got = _all_gather(edge, group)
    zero = x.new_zeros(rest)
    above = got[rank - 1, 1] if rank > 0 and counts[rank - 1] else zero
    below = (got[rank + 1, 0] if rank + 1 < len(counts) and counts[rank + 1]
             else zero)
    return above.unsqueeze(dim), below.unsqueeze(dim)


class _HaloConv(torch.autograd.Function):
    """SAME 3x3 convolution of this rank's NCHW rows with the halo
    exchange (module doc); the kernel is frozen (no gradient)."""

    @staticmethod
    def forward(ctx, h, kernel, counts, rank, group):
        ctx.save_for_backward(kernel)
        ctx.meta = (h.shape, counts, rank, group)
        above, below = _neighbours(h, 2, counts, rank, group)
        n = h.shape[2]
        if n == 0:
            return h.new_empty((h.shape[0], kernel.shape[0], 0, h.shape[3]))
        # SAME padding as the whole image's convolution takes it (the same
        # algorithm), on the halo-extended rows; the first and last output
        # rows, which read the zero padding, are dropped
        y = F.conv2d(torch.cat([above, h, below], 2), kernel, padding=1)
        return y[:, :, 1:n + 1]

    @staticmethod
    def backward(ctx, g):
        kernel, = ctx.saved_tensors
        (b, c, n, w), counts, rank, group = ctx.meta
        if n:
            gp = conv2d_input((b, c, n + 2, w), kernel,
                              F.pad(g, (0, 0, 1, 1)), padding=1)
        else:
            gp = g.new_zeros((b, c, 2, w))
        # row 0 of gp is the row above (the last row of rank - 1), row
        # n + 1 the row below (the first row of rank + 1)
        got = _all_gather(torch.stack([gp[:, :, 0], gp[:, :, n + 1]]), group)
        gh = gp[:, :, 1:n + 1].clone()
        if n and rank > 0 and counts[rank - 1]:
            gh[:, :, 0] += got[rank - 1, 1]
        if n and rank + 1 < len(counts) and counts[rank + 1]:
            gh[:, :, n - 1] += got[rank + 1, 0]
        return gh, None, None, None, None


class _NextRow(torch.autograd.Function):
    """The first row of the next rank's (h, W, C) map (zeros at the
    image's edge); its gradient goes back to that rank's first row."""

    @staticmethod
    def forward(ctx, m, counts, rank, group):
        ctx.meta = (m.shape, counts, rank, group)
        first = m[0] if m.shape[0] else m.new_zeros(m.shape[1:])
        got = _all_gather(first, group)
        if rank + 1 < len(counts) and counts[rank + 1]:
            return got[rank + 1].clone()
        return torch.zeros_like(first)

    @staticmethod
    def backward(ctx, g):
        shape, counts, rank, group = ctx.meta
        got = _all_gather(g, group)
        gm = g.new_zeros(shape)
        if shape[0] and rank > 0 and counts[rank - 1]:
            gm[0] = got[rank - 1]
        return gm, None, None, None


class SlabColumns:
    """A hypercolumn split by height: the replicated ``image`` (B, H, W, 3)
    and this rank's rows of each tap map (``maps``, NHWC, after
    ``levels[i]`` poolings of ``slab``). :func:`strotss_torch.ops.sampling.
    sample_hypercolumn` samples it through :meth:`sample`, whose rows are
    the unsharded rows bit for bit."""

    def __init__(self, image: torch.Tensor, maps: Sequence[torch.Tensor],
                 levels: Sequence[int], slab: Slab):
        self.image, self.maps = image, list(maps)
        self.levels, self.slab = list(levels), slab
        self._next = {}

    def shapes(self) -> List[Tuple[int, int]]:
        """The whole maps' (height, width): the image's, then each tap's."""
        w = self.image.shape[2]
        return [(self.slab.height, w)] + [self.slab.shape(j, w)
                                          for j in self.levels]

    def _next_row(self, i: int, m: torch.Tensor) -> torch.Tensor:
        """Map i's next row; exchanged once for maps without gradients
        (the content's, fixed for a scale)."""
        if i in self._next:
            return self._next[i]
        row = _NextRow.apply(m, self.slab.counts(self.levels[i]),
                             self.slab.rank, self.slab.group)
        if not row.requires_grad:
            self._next[i] = row
        return row

    def _gather(self, i: int, coords: torch.Tensor, hw, nearest: bool):
        """This rank's part of map i's rows at ``coords`` (already scaled to
        the map): the owned samples' rows, zeros for the others."""
        m = self.maps[i][0] if self.maps[i].ndim == 4 else self.maps[i]
        a, b = self.slab.rows(self.levels[i])
        nxt = self._next_row(i, m)
        n = m.shape[0]
        h, w = hw

        def lookup(xi, yi):
            if n == 0:
                return nxt[yi]
            local = xi - a
            return torch.where((local < n)[:, None],
                               m[local.clamp(0, n - 1), yi], nxt[yi])

        if nearest:
            gx = coords[:, 0].clamp(0, h - 1).long()
            gy = coords[:, 1].clamp(0, w - 1).long()
            out = lookup(gx, gy).float()
        else:
            corners = bilinear_corners(coords, h, w)
            gx = corners[0][0]
            out = None
            for xi, yi, wt in corners:
                term = lookup(xi, yi).float() * wt[:, None]
                out = term if out is None else out + term
        own = (gx >= a) & (gx < b)
        return torch.where(own[:, None], out, out.new_zeros(()))

    def sample(self, coords: torch.Tensor, bilinear: bool = True,
               integer_coords: bool = False,
               impl: str = "plain") -> torch.Tensor:
        """:func:`strotss_torch.ops.sampling.sample_hypercolumn` of the
        whole maps: (n, C) float32 rows, the same on every rank. The taps'
        slab gathers are plain; the image's column takes ``impl``."""
        shapes = self.shapes()
        factors = coordinate_factors(shapes)
        parts = []
        for i, fac in enumerate(factors[1:]):
            c = coords * fac if fac != 1.0 else coords
            nearest = not bilinear or (integer_coords and fac == 1.0)
            parts.append(self._gather(i, c, shapes[i + 1], nearest))
        taps = _Summed.apply(torch.cat(parts, dim=1), self.slab.group)
        return torch.cat([sample_hypercolumn([self.image], coords, bilinear,
                                             integer_coords, impl), taps],
                         dim=1)


class Spatial:
    """The 'spatial' process group of a run and the depth of its VGG
    (:func:`depth_of` its taps): what the step needs to split an image."""

    def __init__(self, group, taps: Sequence[str]):
        self.group, self.depth = group, depth_of(taps)

    def slab(self, height: int) -> Slab:
        return Slab(height, self.group, self.depth)
