"""Moment term of the style loss: CUDA kernel set K6, its plain version,
its autograd Function.

No counterpart in ``strotss_tpu/ops/kernels``: the JAX package leaves the
moments to XLA (``strotss_tpu/ops/losses.py`` ``moment_matching``). For
the prediction's rows y (n, C) against a style target's (mean m, cov T):

    p = mean(y),  P = (y - p)^T (y - p) / n
    L = mean |T - P| + mean |m - p|
    S = sign(P - T),  H = S + S^T
    dL/dy = ((y - p) H - (1/n) 1 (colsum(y - p) H)) / (n C^2)
            + sign(p - m) / (n C)

the last line being autograd's gradient of the plain formula, written out:
the symmetric product gives S + S^T, the centring its mean term (zero in
exact arithmetic, kept as the plain route computes it), the mean's MAE the
last term.

On CUDA tensors :func:`stats` and :func:`loss_fwd` / :func:`loss_bwd`
launch ``csrc/moments.cu`` (whose header states its bound and design):
the rows prepared once, the covariance's upper-triangle tiles on 3xTF32
``wgmma`` with the comparison in their epilogue (H as int8, no C x C
float32 matrix in device memory), the gradient as one product. They count
their launches (``launch.moments_stats`` 2 a call, ``launch.moments_fwd``
3, ``launch.moments_bwd`` 1). On CPU tensors :func:`moment_stats` and
:func:`moment_matching_from_stats` compute the plain formula
(:func:`stats_plain`, :func:`loss_plain`), and under ``impl='auto'`` on
CUDA tensors too where a gradient is wanted through the statistics'
input or a target's statistics, which K6 does not differentiate. :func:`mirror` states the
kernels' arithmetic tile by tile in float64, and :func:`shapes` and
:func:`tile_of` their layouts, for the CPU tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from strotss_torch.ops.kernels.common import launch_on, resolve_impl, round_up
from strotss_torch.ops.losses import _f32, mae, reshape_2d
from strotss_torch.utils.timing import count

#: csrc/moments.cu: the covariance's output tile rows (MO_T) and columns
#: (MO_TN), the rows or channels of a stage (MO_KS), the backward's
#: channels (MO_BM) and samples (MO_BN) a block, the column sums' row group
#: (MO_CS), the preparation's channels a block (MO_PREP_COLS), the
#: channels' padding (MO_CPAD)
MO_T, MO_TN, MO_KS, MO_BM, MO_BN, MO_CS = 128, 192, 16, 192, 128, 8
PREP_COLS, MO_CPAD = 32, 384


class Shapes(NamedTuple):
    """The kernels' padded sizes for rows (n, c): samples ``np`` (n up to
    a multiple of MO_BN), channels ``cp`` (c up to MO_CPAD: the prepared
    columns' and H's rows), backward channels ``kq`` (c up to MO_KS; the
    pitch of the row-major parts and of H), the preparation's blocks and
    the covariance's tiles (:func:`tile_of`)."""

    np: int
    cp: int
    kq: int
    prep_blocks: int
    tiles: int


def _jmin(i: int) -> int:
    """The first column tile row tile ``i`` needs: the one holding its
    first diagonal entry, column MO_T i."""
    return i * MO_T // MO_TN


def _row_tiles(c: int) -> Tuple[int, int]:
    return -(-c // MO_T), -(-c // MO_TN)


def shapes(n: int, c: int) -> Shapes:
    cp = round_up(c, MO_CPAD)
    tr, tc = _row_tiles(c)
    return Shapes(round_up(n, MO_BN), cp, round_up(c, MO_KS),
                  cp // PREP_COLS, sum(tc - _jmin(i) for i in range(tr)))


def tile_of(b: int, c: int) -> Tuple[int, int]:
    """Tile (I, J) that block ``b`` of the covariance kernel computes for c
    channels: rows MO_T I.., columns MO_TN J.., the tiles holding an entry
    (a, b), a <= b, row by row."""
    _, tc = _row_tiles(c)
    i = 0
    while b >= tc - _jmin(i):
        b -= tc - _jmin(i)
        i += 1
    return i, _jmin(i) + b


def stats_plain(x: torch.Tensor):
    """(mean (1, C), biased covariance (C, C)) of the rows of ``x``."""
    xm = torch.mean(x, dim=0, keepdim=True)
    cx = x - xm
    return xm, (cx.T @ cx) / x.shape[0]


def loss_plain(stats, y: torch.Tensor) -> torch.Tensor:
    """MAE(cov, cov_y) + MAE(mean, mean_y), ``stats`` = (mean, cov)."""
    xm, xv = stats
    ym, yv = stats_plain(y)
    return mae(xv, yv) + mae(xm, ym)


def mirror(y: torch.Tensor, tm: torch.Tensor, tv: torch.Tensor):
    """(loss, dL/dy, H) as K6 computes them, in float64: the covariance
    kernel's tiles in block order, each adding |d1| + |d2| of its (a, b),
    a < b, and |d1| of its (a, a) to its partial, and writing H = sign(d1)
    + sign(d2) to (a, b) and (b, a), d1 = P_ab - T_ab, d2 = P_ab - T_ba;
    then the backward's product, its column-sum term and the mean's
    term."""
    y, tm, tv = y.double(), tm.double().reshape(-1), tv.double()
    n, c = y.shape
    p = y.mean(0)
    cx = y - p
    cov = cx.T @ cx / n
    h = torch.zeros(c, c, dtype=torch.float64)
    total = torch.zeros((), dtype=torch.float64)
    for b in range(shapes(n, c).tiles):
        ti, tj = tile_of(b, c)
        r = torch.arange(ti * MO_T, min(ti * MO_T + MO_T, c))
        q = torch.arange(tj * MO_TN, min(tj * MO_TN + MO_TN, c))
        a, bb = torch.meshgrid(r, q, indexing="ij")
        keep = bb >= a
        v = cov[a, bb]
        d1, d2 = v - tv[a, bb], v - tv[bb, a]
        w = torch.where(a == bb, d1.abs(), d1.abs() + d2.abs())
        total = total + torch.where(keep, w, torch.zeros_like(w)).sum()
        s = torch.sign(d1) + torch.sign(d2)
        h[a[keep], bb[keep]] = s[keep]
        h[bb[keep], a[keep]] = s[keep]
    dm = p - tm
    loss = total / (c * c) + dm.abs().sum() / c
    colsum = cx.sum(0)
    grad = ((cx @ h - (colsum @ h) / n) / (n * c * c)
            + torch.sign(dm) / (n * c))
    return loss, grad, h


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_rows(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 2 or \
            not x.is_contiguous() or min(x.shape) < 1:
        raise ValueError(f"{name} must be a contiguous (n, C) float32 CUDA "
                         f"tensor with n, C >= 1, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")


class Saved(NamedTuple):
    """What :func:`loss_bwd` takes from :func:`loss_fwd`: the centred rows'
    row-major TF32 parts with their column sums, H as int8 (cp, kq) and
    sign(p - m)."""

    rm: torch.Tensor
    h: torch.Tensor
    msign: torch.Tensor


def _fwd(y: torch.Tensor, tm=None, tv=None, want_grad: bool = False):
    n, c = y.shape
    sh = shapes(n, c)
    dev = y.device
    f32 = {"dtype": torch.float32, "device": dev}
    loss_side = tv is not None
    ct = torch.empty(2 * sh.cp * sh.np, **f32)
    rm = (torch.empty(2 * (sh.np + MO_CS) * sh.kq, **f32) if want_grad
          else None)
    h = (torch.empty(sh.cp, sh.kq, dtype=torch.int8, device=dev)
         if want_grad else None)
    mean = torch.empty(1, c, **f32)
    msign = torch.empty(c, **f32) if loss_side else None
    part = torch.empty(sh.prep_blocks + sh.tiles, **f32) if loss_side \
        else None
    cov = None if loss_side else torch.empty(c, c, **f32)
    loss = torch.empty((), **f32) if loss_side else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch_on(dev, "moments_fwd", y.data_ptr(), n, c, _ptr(tm), _ptr(tv),
              ct.data_ptr(), _ptr(rm), mean.data_ptr(), _ptr(msign),
              _ptr(part), _ptr(cov), _ptr(h), _ptr(loss), stream)
    return mean, cov, loss, (Saved(rm, h, msign) if want_grad else None)


def stats(x: torch.Tensor):
    """(mean (1, C), cov (C, C)) of the rows of ``x`` through K6, the
    covariance exactly symmetric; two launches."""
    _check_rows("x", x)
    mean, cov, _, _ = _fwd(x)
    count("launch.moments_stats", 2)
    return mean, cov


def _check_target(y: torch.Tensor, tm: torch.Tensor, tv: torch.Tensor):
    c = y.shape[1]
    for name, t, shape in (("target mean", tm, (1, c)),
                           ("target cov", tv, (c, c))):
        if t.device != y.device or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"the {name} must be a contiguous float32 "
                             f"{shape} tensor on {y.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def loss_fwd(y: torch.Tensor, tm: torch.Tensor, tv: torch.Tensor,
             want_grad: bool = True):
    """(loss, :class:`Saved` or None) of rows ``y`` against the target's
    (mean (1, C), cov (C, C)) through K6; three launches."""
    _check_rows("y", y)
    _check_target(y, tm, tv)
    _, _, loss, saved = _fwd(y, tm, tv, want_grad)
    count("launch.moments_fwd", 3)
    return loss, saved


def loss_bwd(saved: Saved, g: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """dL/dy (n, c) times the upstream gradient ``g`` (a scalar on the
    card); one launch."""
    dev = saved.rm.device
    g = g.reshape(()).to(device=dev, dtype=torch.float32).contiguous()
    dx = torch.empty(n, c, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch_on(dev, "moments_bwd", saved.h.data_ptr(), saved.rm.data_ptr(),
              saved.msign.data_ptr(), g.data_ptr(), n, c, dx.data_ptr(),
              stream)
    count("launch.moments_bwd")
    return dx


class MomentLoss(torch.autograd.Function):
    """The moment loss of rows ``y`` through K6, differentiable in ``y``."""

    @staticmethod
    def forward(ctx, y, tm, tv):
        loss, saved = loss_fwd(y, tm, tv, want_grad=True)
        ctx.save_for_backward(*saved)
        ctx.nc = tuple(y.shape)
        return loss

    @staticmethod
    def backward(ctx, g):
        return loss_bwd(Saved(*ctx.saved_tensors), g, *ctx.nc), None, None


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_grad_through(name: str, *ts: torch.Tensor) -> None:
    if _wants_grad(*ts):
        raise RuntimeError(f"K6 does not differentiate the {name}; use "
                           "impl='plain' or 'auto' to take its gradient")


def _route(impl: str, t: torch.Tensor, *no_grad: torch.Tensor) -> str:
    """``impl`` resolved for ``t``: 'auto' takes K6 on a CUDA tensor unless
    a gradient is wanted through ``no_grad`` (the statistics' input, a
    target's statistics), which K6 does not give: then the plain formula,
    as on the CPU. 'kernel' there raises."""
    route = resolve_impl(impl, t)
    if route == "kernel" and impl == "auto" and _wants_grad(*no_grad):
        return "plain"
    return route


def moment_stats(x: torch.Tensor, impl: str = "auto"):
    """(mean (1, C), biased covariance (C, C)) of the rows of ``x``."""
    x = reshape_2d(_f32(x))
    if _route(impl, x, x) == "plain":
        return stats_plain(x)
    _no_grad_through("statistics' input", x)
    return stats(x.contiguous())


def moment_matching_from_stats(stats_xy, y: torch.Tensor,
                               impl: str = "auto") -> torch.Tensor:
    """MAE(cov, cov_y) + MAE(mean, mean_y) of rows ``y`` against
    ``stats_xy`` = (mean, cov), differentiable in ``y`` (and, on the plain
    route, in ``stats_xy``)."""
    if _route(impl, y, *stats_xy) == "plain":
        return loss_plain(stats_xy, reshape_2d(_f32(y)))
    tm, tv = (t.contiguous() for t in stats_xy)
    _no_grad_through("target's statistics", tm, tv)
    y = reshape_2d(_f32(y)).contiguous()
    if _wants_grad(y):
        return MomentLoss.apply(y, tm, tv)
    return loss_fwd(y, tm, tv, want_grad=False)[0]
