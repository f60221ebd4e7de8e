"""REMD with the style samples split over ranks, the counterpart of
``strotss_tpu/parallel/transport.py`` (lines 29-68).

Every rank of the 'sample' group holds the whole prediction block x
(N, C) and the whole style block y (M, C), and runs kernel K1
(:func:`strotss_torch.ops.kernels.remd.remd_mins`) on x against its
``torch.tensor_split`` shard of y's rows, so each rank's K1 sweeps
N x M/p pairs. Then:

- row minima: each rank's (N,) minima over its columns are gathered to
  (p, N), and the minimum over the rank axis is the row minimum; its
  gradient goes to the winning shard (ties: the lowest rank, which holds
  the lowest column, as K1's first argmin does);
- column minima: each shard's are complete; their sum is all-reduced
  and divided by M.

The collectives are three ``torch.autograd.Function`` s of the port's
own, the conjugate pair of tensor-parallel code. ``x`` and ``y`` enter
through :class:`_Replicated` (identity forward, all-reduce of the
gradient backward: each rank's K1 VJP holds only its shard's share of
the gradient, and the replicated layers above need the whole of it);
the row minima leave through :class:`_Gathered` (all-gather forward,
this rank's slice of the cotangent backward, no traffic) and the
column-minimum sum through :class:`_Summed` (all-reduce forward,
identity backward). ``torch.distributed.nn.functional`` is not used: its
all-gather's backward is a summing reduce-scatter, which scales a
replicated loss's gradient by p.

Traffic a call: one (p, N) all-gather and one scalar all-reduce forward,
one (N, C) all-reduce backward (and one (M, C) where y needs a gradient).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from strotss_torch.ops.losses import _f32, reshape_2d


class _Replicated(torch.autograd.Function):
    """Identity forward; the gradient is summed over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gathered(torch.autograd.Function):
    """(p, ...) stack of every rank's ``t`` forward; this rank's slice of
    the cotangent backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rank = dist.get_rank(group)
        p = dist.get_world_size(group)
        # gloo gathers into the concatenation only
        out = t.new_empty((p * t.numel(),))
        dist.all_gather_into_tensor(out, t.contiguous().view(-1), group=group)
        return out.view((p,) + tuple(t.shape))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _Summed(torch.autograd.Function):
    """Sum over ``group`` forward; identity backward."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def remd_over_group(x: torch.Tensor, y: torch.Tensor, group,
                    distance: str = "cosine",
                    impl: str = "auto") -> torch.Tensor:
    """:func:`strotss_torch.ops.losses.relaxed_emd` of (x, y) with y's rows
    split over the process group ``group``; the same value (and floors)
    on every rank of the group, and each input's whole gradient."""
    from strotss_torch.ops.kernels.remd import remd_mins

    x, y = reshape_2d(_f32(x)), reshape_2d(_f32(y))
    p, r = dist.get_world_size(group), dist.get_rank(group)
    x = _Replicated.apply(x, group)
    y = _Replicated.apply(y, group)
    rowmin, colmin = remd_mins(x, torch.tensor_split(y, p)[r].contiguous(),
                               distance, impl)
    row = torch.min(_Gathered.apply(rowmin, group), dim=0).values
    r_y = _Summed.apply(torch.sum(colmin), group) / y.shape[0]
    return torch.maximum(torch.mean(row), r_y)


def relaxed_emd_sharded(x: torch.Tensor, y: torch.Tensor, mesh,
                        distance: str = "cosine", axis: str = "sample",
                        impl: str = "auto") -> torch.Tensor:
    """REMD with ``y`` (M, C) split over ``mesh``'s axis ``axis`` and ``x``
    (N, C) whole on every rank (``strotss_tpu/parallel/transport.py:
    39-68``); matches ``relaxed_emd(x, y, distance)``."""
    return remd_over_group(x, y, mesh.get_group(axis), distance, impl)
