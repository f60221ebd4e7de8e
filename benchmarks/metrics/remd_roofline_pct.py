"""Kernel K1 (REMD row and column minima, ``csrc/remd.cu``): the least
time of its calls over their device time. A call on N x M rows of C
channels reads both sets once and writes the minima and their argmins;
its operations are the distance matrix's products, 2 N M C at the bf16
peak, and for the 'both' distance N M square roots at the transcendental
rate. Two calls a step, pair and region: the features' cosine term and
the YUV 'both' term."""

from harness.layers import roofline
from harness.work import bound_s

NAMES = ("remd_tc_kernel", "remd_tile_kernel", "remd_reduce_kernel")


def call_bound(n, m, c, both, rates):
    nbytes = 4 * (n + m) * c + 8 * (n + m)
    return bound_s(rates, 2 * n * m * c, nbytes, n * m if both else 0)


def read(ctx):
    r, bound, calls = ctx["rates"], 0.0, 0
    for call in ctx["calls"]:
        for s in call:
            if s["sinkhorn"]:
                continue
            k = s["steps"] * s["pairs"] * s["regions"]
            n = s["n"]
            bound += k * (call_bound(n, n, s["c"], False, r)
                          + call_bound(n, n, 3, True, r))
            calls += 2 * k
    if not calls:
        return None
    return roofline(ctx, NAMES, bound, {"remd_reduce_kernel": calls})
