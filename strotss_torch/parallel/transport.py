"""The transport losses with the style samples split over ranks: REMD,
the counterpart of ``strotss_tpu/parallel/transport.py`` (lines 29-68),
and Sinkhorn, the counterpart of the materialized
``strotss_tpu.ops.losses.sinkhorn`` that GSPMD partitions under
``shard_samples`` (``strotss_tpu/programs.py:567-583``).

Every rank of the 'sample' group holds the whole of x (N, C) and of y
(M, C), and runs kernel K1
(:func:`strotss_torch.ops.kernels.remd.remd_mins`) on x against its
``torch.tensor_split`` shard of y's rows, so each rank's K1 sweeps
N x M/p pairs, and its minima and argmins are those of the unsharded
K1(x, y)'s columns, bit for bit. A step passes (style targets,
prediction), the operand order of its unsharded ``relaxed_emd``: in the
other order K1 rounds some distances 1 ulp apart, and a near-tie can pick
another argmin than the unsharded step does. Then:

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

:func:`sinkhorn_over_group` splits the rows of x (the style targets,
``sinkhorn(target, prediction)``'s first operand) instead: rank r holds
x_r, its ``torch.tensor_split`` shard, and the whole of y, so its cost
block C_r = d(x_r, y) is exactly the whole cost matrix's rows (every
distance is row-local). The row half-update
``log_u_r = log_p - LSE_j(log_k_r + log_v)`` is then local; the column
half-update ``log_v = log_q - LSE_i(log_k + log_u)`` combines the ranks:
the column maxima are all-reduced with MAX (detached: the LSE does not
depend on its shift) and the sums of exp below them with SUM. ``log_v``,
which every rank holds whole, enters each rank's local work through
:class:`_Replicated`, the column sums and the result <T_r, C_r> leave
through :class:`_Summed`; every value that a rank holds whole comes out
of an all-reduce, so the ranks hold the same bits. Each iteration is
recomputed in the backward pass, its all-reduces included (every rank
recomputes the same graph in the same order). Traffic a call: two (M,)
all-reduces an iteration and one scalar forward; in the backward pass
three (M,) all-reduces an iteration (the recompute's two and log_v's
gradient), one more for the final log_v, and the (N, C) and (M, C)
gradient all-reduces.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from strotss_torch.ops.losses import _f32, dist_metrics, reshape_2d


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


def sinkhorn_over_group(x: torch.Tensor, y: torch.Tensor, group,
                        distance: str = "cosine", lam: float = 10.0,
                        n_iter: int = 30) -> torch.Tensor:
    """The materialized :func:`strotss_torch.ops.losses.sinkhorn` of
    (x, y) (``n_iter`` log-domain iterations, uniform marginals, then
    <T, C>) with x's rows split over the process group ``group``; the
    same value on every rank of the group, and each input's whole
    gradient through the unrolled iterations."""
    x, y = reshape_2d(_f32(x)), reshape_2d(_f32(y))
    p, r = dist.get_world_size(group), dist.get_rank(group)
    n, m = x.shape[0], y.shape[0]
    x = _Replicated.apply(x, group)
    y = _Replicated.apply(y, group)
    c = dist_metrics[distance](torch.tensor_split(x, p)[r], y)
    log_k = -lam * c
    # the marginals of the whole problem, not of the shard
    log_p = torch.full((c.shape[0],), -math.log(n), dtype=c.dtype,
                       device=c.device)
    log_q = torch.full((m,), -math.log(m), dtype=c.dtype, device=c.device)

    def body(log_u, log_v):
        log_v = _Replicated.apply(log_v, group)
        log_u = log_p - torch.logsumexp(log_k + log_v[None, :], dim=1)
        z = log_k + log_u[:, None]
        top = torch.amax(z.detach(), dim=0)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        s = _Summed.apply(torch.sum(torch.exp(z - top[None, :]), dim=0),
                          group)
        return log_u, log_q - (top + torch.log(s))

    log_u, log_v = c.new_zeros(c.shape[0]), c.new_zeros(m)
    for _ in range(n_iter):
        # as in the plain route: recompute each iteration in the backward
        log_u, log_v = checkpoint(body, log_u, log_v, use_reentrant=False)
    log_t = (log_u[:, None] + log_k
             + _Replicated.apply(log_v, group)[None, :])
    return _Summed.apply(torch.sum(torch.exp(log_t) * c), group)


def relaxed_emd_sharded(x: torch.Tensor, y: torch.Tensor, mesh,
                        distance: str = "cosine", axis: str = "sample",
                        impl: str = "auto") -> torch.Tensor:
    """REMD with ``y`` (M, C) split over ``mesh``'s axis ``axis`` and ``x``
    (N, C) whole on every rank (``strotss_tpu/parallel/transport.py:
    39-68``); matches ``relaxed_emd(x, y, distance)``."""
    return remd_over_group(x, y, mesh.get_group(axis), distance, impl)
