"""Hypercolumn gathers: CUDA kernel pair K5, its plain mirror, its VJP.

No counterpart in ``strotss_tpu/ops/kernels``: the JAX package gathers
through XLA (``strotss_tpu/ops/sampling.py``). The kernels
(``csrc/gather.cu``, whose header states their bound and design) take every
map of one or two hypercolumns at once:

- ``gather_fwd``: the (n, C) float32 rows of each side at the sample
  coordinates, one launch, bit for bit the plain route of
  :mod:`strotss_torch.ops.sampling` (counted in ``launch.gather_fwd``);
- ``gather_bwd``: each map's dense gradient in its own dtype and layout,
  two launches (counted in ``launch.gather_bwd``): the map's corner keys
  sorted stably by pixel, then per pixel the sum of cotangent x weight over
  its keys in that order, in float32, rounded once. The plain route rounds
  each term to bf16 and adds them with atomics in an order that changes
  from run to run; this sum is never less precise and the same in every
  call.

:func:`rows` is the entry :mod:`strotss_torch.ops.sampling` calls on CUDA
tensors, differentiable in the maps. :func:`corner_keys`, :func:`key_order`
and :func:`grad_mirror` state the backward's keys, their order and its sums
in PyTorch, for the tests (the forward's mirror is the plain route itself).
"""

from __future__ import annotations

import struct
from array import array
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from strotss_torch.ops.kernels.common import launch_on, stream_scratch
from strotss_torch.utils.timing import count

#: csrc/gather.cu: maps a launch takes, 64-bit words of a map's descriptor
MAX_MAPS, DESC_WORDS = 32, 16
#: map dtype -> its code in csrc/gather.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Side(NamedTuple):
    """One hypercolumn to sample: its maps, each map's coordinate factor
    (:func:`strotss_torch.ops.sampling.coordinate_factors`) and whether it
    takes the nearest lookup."""

    maps: Sequence[torch.Tensor]
    factors: Sequence[float]
    nearest: Sequence[bool]


class _MapMeta(NamedTuple):
    """What the backward needs of a map: no values, its shape and place."""

    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype
    side: int
    col: int
    row: int
    fac: float
    nearest: bool


def _f32_bits(v: float) -> int:
    """The bits of ``v`` rounded to float32, as torch rounds a Python
    scalar it multiplies a float32 tensor by."""
    return struct.unpack("<I", struct.pack("<f", v))[0]


def dense_strides(shape: Sequence[int],
                  stride: Sequence[int]) -> Tuple[int, ...]:
    """``stride`` where it lays ``shape`` out densely without overlap (a
    permutation of a contiguous tensor, as the VGG taps' NHWC views of NCHW
    tensors), else the contiguous strides."""
    expect = 1
    for s, n in sorted((s, n) for s, n in zip(stride, shape) if n != 1):
        if s != expect:
            out, acc = [], 1
            for n2 in reversed(shape):
                out.append(acc)
                acc *= n2
            return tuple(reversed(out))
        expect *= n
    return tuple(stride)


def describe(metas: Sequence[_MapMeta],
             strides: Sequence[Sequence[int]]) -> array:
    """The kernels' map table with the pointers left 0: DESC_WORDS words a
    map (csrc/gather.cu, ``read_table``): pointer, row, column and channel
    strides, h, w, C, the factor's float32 bits, dtype, nearest, scaled,
    column, side, row width. A map is (h, w, C) or (1, h, w, C): its last
    three axes."""
    words = array("q")
    for m, st in zip(metas, strides):
        h, w, c = m.shape[-3:]
        words.extend([0, *st[-3:], h, w, c, _f32_bits(m.fac),
                      _DTYPE_CODE[m.dtype], int(m.nearest), int(m.fac != 1.0),
                      m.col, m.side, m.row, 0, 0])
    return words


def _filled(table: array, ptrs) -> array:
    """A copy of ``table`` with map i's pointer set to ``ptrs[i]``."""
    words = array("q", table)
    for i, p in enumerate(ptrs):
        words[i * DESC_WORDS] = p
    return words


class _Plan:
    """What a call's maps fix, made once for each signature (shapes,
    strides, dtypes, factors, lookups): the maps' metadata, the rows'
    widths and the forward's table; the backward's tables, each for the
    maps that need a gradient, as they are first asked for."""

    def __init__(self, sides: Sequence[Side], device: int):
        if len(sides) not in (1, 2):
            raise ValueError(f"K5 samples one or two sides, got {len(sides)}")
        self.metas: List[_MapMeta] = []
        self.widths = []
        for s, side in enumerate(sides):
            row = sum(int(m.shape[-1]) for m in side.maps)
            self.widths.append(row)
            col = 0
            for m, fac, near in zip(side.maps, side.factors, side.nearest):
                if m.get_device() != device:
                    raise ValueError(f"a map lies on {m.device}, the coords "
                                     f"on cuda:{device}")
                if m.dtype not in _DTYPE_CODE:
                    raise TypeError("K5 takes float32 and bfloat16 maps, "
                                    f"got {m.dtype}")
                if m.ndim not in (3, 4) or (m.ndim == 4 and m.shape[0] != 1)\
                        or min(m.shape[-3:-1]) < 1:
                    raise ValueError("a map must be (h, w, C) or (1, h, w, "
                                     f"C) with h, w >= 1, got "
                                     f"{tuple(m.shape)}")
                self.metas.append(_MapMeta(tuple(m.shape), tuple(m.stride()),
                                           m.dtype, s, col, row, float(fac),
                                           bool(near)))
                col += int(m.shape[-1])
        if len(self.metas) > MAX_MAPS:
            raise ValueError(f"K5 takes at most {MAX_MAPS} maps a call, got "
                             f"{len(self.metas)}")
        self.fwd = describe(self.metas, [m.stride for m in self.metas])
        self._bwd = {}

    def backward(self, need: Tuple[int, ...]):
        """(metas, gradient strides, table) of the maps ``need``."""
        if need not in self._bwd:
            metas = [self.metas[i] for i in need]
            strides = [dense_strides(m.shape, m.stride) for m in metas]
            self._bwd[need] = (metas, strides, describe(metas, strides))
        return self._bwd[need]


_PLANS_KEPT = 64
_plans: Dict[tuple, _Plan] = {}


def _plan(sides: Sequence[Side], device: int) -> _Plan:
    # each map's device in the key: a plan checked them when it was made
    key = (device,) + tuple(
        (s, m.get_device(), m.shape, m.stride(), m.dtype, f, near)
        for s, side in enumerate(sides)
        for m, f, near in zip(side.maps, side.factors, side.nearest))
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= _PLANS_KEPT:
            _plans.clear()
        plan = _plans[key] = _Plan(sides, device)
    return plan


def _forward(coords: torch.Tensor, maps: Sequence[torch.Tensor],
             plan: _Plan) -> Tuple[torch.Tensor, ...]:
    n = coords.shape[0]
    dev = coords.device
    outs = tuple(torch.empty((n, w), dtype=torch.float32, device=dev)
                 for w in plan.widths)
    words = _filled(plan.fwd, [m.data_ptr() for m in maps])
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch_on(dev, "gather_fwd", words.buffer_info()[0], len(plan.metas),
              coords.data_ptr(), n, outs[0].data_ptr(), outs[-1].data_ptr(),
              stream)
    count("launch.gather_fwd")
    return outs


def backward(coords: torch.Tensor, plan: _Plan, need: Tuple[int, ...],
             cotangents: Sequence[torch.Tensor]):
    """K5's backward for the maps ``need`` of ``plan``: each one's dense
    gradient, in the map's dtype and (dense) layout; also the scratch,
    whose first half holds each map's keys sorted by pixel (pixel, key
    index), one block of keys a map in ``need``'s order."""
    n = coords.shape[0]
    dev = coords.device
    metas, strides, table = plan.backward(need)
    grads = [torch.empty_strided(m.shape, st, dtype=m.dtype, device=dev)
             for m, st in zip(metas, strides)]
    keys = sum(n if m.nearest else 4 * n for m in metas)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = stream_scratch(("gather", dev.index, keys), stream,
                             4 * max(1, keys), torch.int32, dev)
    # a side none of whose maps is asked for may come as None
    gs = [None if g is None else g.contiguous() for g in cotangents]
    ptrs = [0 if g is None else g.data_ptr() for g in gs]
    words = _filled(table, [g.data_ptr() for g in grads])
    launch_on(dev, "gather_bwd", words.buffer_info()[0], len(metas),
              coords.data_ptr(), n, ptrs[0], ptrs[-1], scratch.data_ptr(),
              stream)
    count("launch.gather_bwd", 2)
    return grads, scratch


class _Rows(torch.autograd.Function):
    """The sides' rows through K5, with K5's backward for the maps."""

    @staticmethod
    def forward(ctx, coords, plan, *maps):
        ctx.plan = plan
        ctx.save_for_backward(coords)
        # the content's rows take no gradient: no zeros made for them
        ctx.set_materialize_grads(False)
        return _forward(coords, maps, plan)

    @staticmethod
    def backward(ctx, *cotangents):
        (coords,) = ctx.saved_tensors
        plan = ctx.plan
        need = tuple(i for i, want in enumerate(ctx.needs_input_grad[2:])
                     if want)
        out = [None] * len(plan.metas)
        if need:
            sides = {plan.metas[i].side for i in need}
            cotangents = [
                torch.zeros(coords.shape[0], w, device=coords.device)
                if g is None and s in sides else g
                for s, (g, w) in enumerate(zip(cotangents, plan.widths))]
            grads, _ = backward(coords, plan, need, cotangents)
            for i, g in zip(need, grads):
                out[i] = g
        return (None, None, *out)


def rows(coords: torch.Tensor,
         sides: Sequence[Side]) -> Tuple[torch.Tensor, ...]:
    """Each side's (n, sum C) float32 rows at ``coords`` (the plain route's
    ``sample_hypercolumn``, bit for bit), one K5 launch for all sides;
    differentiable in the maps (two launches for all maps that need a
    gradient)."""
    if not coords.is_cuda or coords.dtype != torch.float32 or \
            coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError("coords must be an (n, 2) float32 CUDA tensor, got "
                         f"{tuple(coords.shape)} {coords.dtype} on "
                         f"{coords.device}")
    coords = coords.contiguous()
    plan = _plan(sides, coords.get_device())
    maps = [m for side in sides for m in side.maps]
    if torch.is_grad_enabled() and any(m.requires_grad for m in maps):
        return _Rows.apply(coords, plan, *maps)
    return _forward(coords, maps, plan)


def corner_keys(coords: torch.Tensor, h: int, w: int, fac: float,
                nearest: bool):
    """The backward's keys of one map in key order k = sample * corners +
    corner: (pixel x * w + y as int64, weight as float32), by the plain
    route's arithmetic (``bilinear_corners``, ``nearest_gather``)."""
    c = coords * fac if fac != 1.0 else coords
    if nearest:
        x = c[:, 0].clamp(0, h - 1).long()
        y = c[:, 1].clamp(0, w - 1).long()
        return x * w + y, torch.ones(c.shape[0], dtype=torch.float32,
                                     device=c.device)
    gx, gy = c[:, 0], c[:, 1]
    fx, fy = torch.floor(gx), torch.floor(gy)
    dx, dy = gx - fx, gy - fy
    x0, y0 = fx.clamp(0, h - 1).long(), fy.clamp(0, w - 1).long()
    x1, y1 = (fx + 1).clamp(0, h - 1).long(), (fy + 1).clamp(0, w - 1).long()
    pix = torch.stack([x0 * w + y0, x0 * w + y1, x1 * w + y0, x1 * w + y1], 1)
    wt = torch.stack([(1 - dx) * (1 - dy), (1 - dx) * dy, dx * (1 - dy),
                      dx * dy], 1)
    return pix.reshape(-1), wt.reshape(-1)


def key_order(pixel: torch.Tensor) -> torch.Tensor:
    """The key indices sorted by pixel, ties in key order: the order in
    which the backward adds a pixel's terms (its radix sort is stable)."""
    return torch.sort(pixel, stable=True).indices


def grad_mirror(g: torch.Tensor, coords: torch.Tensor, shape, fac: float,
                nearest: bool, dtype: torch.dtype) -> torch.Tensor:
    """One map's gradient as K5's backward computes it, from its rows'
    (n, C) float32 cotangent ``g``: per pixel, 0 + t_1 + t_2 + ... over its
    keys in :func:`key_order`, t = g[sample] * weight (g[sample] for a
    nearest map), in float32, rounded once to ``dtype``; (h, w, C)."""
    h, w, ch = shape
    pix, wt = corner_keys(coords, h, w, fac, nearest)
    order = key_order(pix)
    sp = pix[order]
    sample = order if nearest else order // 4
    terms = g[sample] if nearest else g[sample] * wt[order][:, None]
    # a key's rank among its pixel's keys: one add per rank, in order
    first = torch.searchsorted(sp, sp, right=False)
    rank = torch.arange(sp.shape[0], device=sp.device) - first
    acc = torch.zeros(h * w, ch, dtype=torch.float32, device=g.device)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        acc[sp[sel]] = acc[sp[sel]] + terms[sel]
    return acc.reshape(h, w, ch).to(dtype)


def sum_bound(ref: torch.Tensor, abs_sum: torch.Tensor, terms: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """How far the backward's gradient may lie from the exact (float64)
    gradient ``ref``: one unit in the last place of ``dtype`` at |ref|,
    plus float32's bound for a sequential sum of ``terms`` terms whose
    magnitudes sum to ``abs_sum``, (terms - 1) 2^-24 sum|t|. Zero where a
    pixel has no term."""
    mant = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = torch.finfo(dtype).tiny
    e = torch.floor(torch.log2(ref.abs().clamp_min(tiny)))
    ulp = torch.exp2(e - mant)
    bound = ulp + (terms - 1).clamp_min(0) * 2.0 ** -24 * abs_sum
    return torch.where(terms > 0, bound, torch.zeros_like(bound))


def term_counts(coords: torch.Tensor, shape, fac: float,
                nearest: bool) -> torch.Tensor:
    """The keys of each pixel of an (h, w, C) map, as (h, w, 1)."""
    h, w, _ = shape
    pix, _ = corner_keys(coords, h, w, fac, nearest)
    return torch.bincount(pix, minlength=h * w).reshape(h, w, 1)
