"""Kernel K2 (self-similarity, ``csrc/selfsim.cu``): the least time of
its launches over their device time. The forward (K2a) reads both sets
of N unit rows of C channels and their column sums, and writes the loss,
two column vectors and the N x N signs (one byte each); its operations
are the two symmetric Gram matrices, N (N + 1) C each. The backward (K2b)
reads the rows, the signs and the column vectors and writes the
prediction's gradient, (G + G^T) x, 2 N^2 C operations (the content's
side needs none). Products at the bf16 peak. One of each a step, pair
and region."""

from harness.layers import roofline
from harness.work import bound_s

NAMES = ("selfsim_fwd_kernel", "selfsim_fwd_reduce_kernel",
         "selfsim_bwd_kernel")


def fwd(n, c, rates):
    nbytes = 8 * n * c + 8 * n + 4 * (1 + 2 * n) + n * n
    return bound_s(rates, 2 * n * (n + 1) * c, nbytes)


def bwd(n, c, rates):
    nbytes = 8 * n * c + n * n + 16 * n + 4 * n * c
    return bound_s(rates, 2 * n * n * c, nbytes)


def read(ctx):
    r, bound, calls = ctx["rates"], 0.0, 0
    for call in ctx["calls"]:
        for s in call:
            k = s["steps"] * s["pairs"] * s["regions"]
            bound += k * (fwd(s["n"], s["c"], r) + bwd(s["n"], s["c"], r))
            calls += k
    return roofline(ctx, NAMES, bound, {"selfsim_fwd_kernel": calls,
                                        "selfsim_bwd_kernel": calls})
