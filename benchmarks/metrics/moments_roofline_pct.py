"""Kernel set K6 (the moment term of the style loss, ``csrc/moments.cu``):
the least time of its launches over their device time.

The bound counts the products the mathematics needs, whatever computes
them, as ``mfu_pct`` counts the moments, at the bf16 peak: a pair and
region a step, the covariance and its gradient, 4 n C^2; a style target
a scale, its covariance, 2 n C^2. That is more than K6 computes (its
covariance is symmetric: n C^2 + 2 n C^2 a step, ``csrc/moments.cu``'s
header) on purpose: the share prices the loss's work, not one design's,
and the bf16 peak more than offsets the 4/3. Bytes: each input read once and each
output written once: a step's rows and the target's covariance read and
its gradient written; a style target's rows read and its covariance
written. Each is bound by its products. Launches, a pair and region at a
time: ``moments_prep_kernel`` and ``moments_cov_kernel`` a step and a
style target a scale, ``moments_finish_kernel`` and
``moments_bwd_kernel`` a step.
"""

from harness.layers import roofline
from harness.work import bound_s

NAMES = ("moments_prep_kernel", "moments_cov_kernel",
         "moments_finish_kernel", "moments_bwd_kernel")


def step_bound(n, c, rates):
    """The loss and its gradient for n rows of c channels."""
    return bound_s(rates, flops=4 * n * c * c,
                   nbytes=4 * (2 * n * c + c * c))


def target_bound(n, c, rates):
    """A style target's (mean, covariance)."""
    return bound_s(rates, flops=2 * n * c * c,
                   nbytes=4 * (n * c + c * c + c))


def read(ctx):
    r, bound, steps, targets = ctx["rates"], 0.0, 0, 0
    for call in ctx["calls"]:
        for s in call:
            k = s["pairs"] * s["regions"]
            bound += k * (s["steps"] * step_bound(s["n"], s["c"], r)
                          + target_bound(s["n"], s["c"], r))
            steps += k * s["steps"]
            targets += k
    return roofline(ctx, NAMES, bound, {
        "moments_prep_kernel": steps + targets,
        "moments_cov_kernel": steps + targets,
        "moments_finish_kernel": steps, "moments_bwd_kernel": steps})
