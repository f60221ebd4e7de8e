"""Streamed Sinkhorn: CUDA kernel K4 (one LSE half-update), its plain
version, the transport read-out and the Danskin gradient.

Counterpart of ``strotss_tpu/ops/kernels/sinkhorn.py``. The materialized
Sinkhorn (:func:`strotss_torch.ops.losses.sinkhorn`, ``impl='plain'``)
keeps the N x M log-kernel and differentiates through the unrolled
iterations. Above the memory gate the port, like the JAX package, runs
every half-update as one streamed pass over the raw feature rows instead:

    lse_pass(x, y, logv)_i = LSE_j(-lam * d(x_i, y_j) + logv_j)

which kernel K4 (``csrc/sinkhorn.cu``, whose header states its bound and
design) computes without forming N x M. The iterations run in the JAX
package's Gauss-Seidel order (u from v, then v from the new u), and the
loss is the read-out ``sum_ij T_ij d_ij`` of the plan
``T = exp(log_u_i - lam * d_ij + log_v_j)``, in row blocks.

Gradient: the converged-plan (Danskin) gradient ``dL/dd_ij = T_ij``, the
gradient of the read-out with the plan held fixed. It costs one block-
streamed pass instead of differentiating through 2 * n_iter passes, and it
is not the unrolled gradient of the plain path (cosine ~0.9 with it at 30
iterations).

``lse_pass`` is the wrapper: on a CUDA tensor it launches K4 (and counts
the launch in ``lse_pass.launches``), on a CPU tensor it computes the same
function with :func:`lse_pass_plain`.
"""

from __future__ import annotations

import math

import torch

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import _DIST_CODE, check_cuda_f32
from strotss_torch.ops.losses import dist_metrics


def lse_pass_plain(x: torch.Tensor, y: torch.Tensor, logv: torch.Tensor,
                   lam: float, distance: str) -> torch.Tensor:
    """(N,) ``LSE_j(-lam * dist(x, y)_ij + logv_j)`` from the materialized
    N x M distance matrix."""
    d = dist_metrics[distance](x, y)
    return torch.logsumexp(-lam * d + logv[None, :], dim=1)


def lse_pass(x: torch.Tensor, y: torch.Tensor, logv: torch.Tensor,
             lam: float, distance: str) -> torch.Tensor:
    """(N,) ``LSE_j(-lam * dist(x, y)_ij + logv_j)``: kernel K4 on CUDA
    tensors. The LSE over rows is the same call with x and y swapped."""
    if distance not in _DIST_CODE:
        raise ValueError(f"unknown distance {distance!r}")
    if not x.is_cuda:
        return lse_pass_plain(x, y, logv, lam, distance)
    n, c = x.shape
    m = y.shape[0]
    check_cuda_f32("x", x, (n, c))
    check_cuda_f32("y", y, (m, c))
    check_cuda_f32("logv", logv, (m,))
    if y.device != x.device or logv.device != x.device:
        raise ValueError("x, y and logv must lie on the same device")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        build.launch(
            "sinkhorn_lse", x.data_ptr(), y.data_ptr(), logv.data_ptr(), n, m,
            c, _DIST_CODE[distance], float(lam), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    lse_pass.launches += 1
    return out


lse_pass.launches = 0


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
        for _ in range(n_iter):
            log_u = log_p - lse_pass(x, y, log_v, lam, distance)
            log_v = log_q - lse_pass(y, x, log_u, lam, distance)
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
