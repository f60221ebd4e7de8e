"""Kernel K3 (VGG block1, ``csrc/block1.cu``): the least time of its
launches over their device time. A forward launch reads the float32
images and both kernels and writes both float32 taps; a backward call
(K3b's two kernels) reads both taps and both cotangents and writes the
image's gradient. Operations: both convolutions (3 -> 64 -> 64) at the
bf16 peak. Launches: one forward for the contents, one for the styles a
scale, and a forward and a backward a step, each over all pairs."""

from harness.layers import roofline
from harness.work import bound_s

NAMES = ("block1_fwd_kernel", "block1_dy1_kernel", "block1_dx_kernel")
WEIGHTS = 4 * (64 * 3 * 9 + 64 + 64 * 64 * 9 + 64)


def fwd(h, w, b, rates):
    flops = 2 * b * h * w * 9 * (3 * 64 + 64 * 64)
    nbytes = 4 * b * h * w * (3 + 2 * 64) + WEIGHTS
    return bound_s(rates, flops, nbytes)


def bwd(h, w, b, rates):
    flops = 2 * b * h * w * 9 * (64 * 64 + 64 * 3)
    nbytes = 4 * b * h * w * (4 * 64 + 3) + WEIGHTS
    return bound_s(rates, flops, nbytes)


def read(ctx):
    r, bound, n_fwd, n_bwd = ctx["rates"], 0.0, 0, 0
    for call in ctx["calls"]:
        for s in call:
            b, (h, w), (sh, sw) = s["pairs"], s["chw"], s["shw"]
            bound += fwd(h, w, b, r) + fwd(sh, sw, b, r)
            bound += s["steps"] * (fwd(h, w, b, r) + bwd(h, w, b, r))
            n_fwd += 2 + s["steps"]
            n_bwd += s["steps"]
    return roofline(ctx, NAMES, bound, {"block1_fwd_kernel": n_fwd,
                                        "block1_dx_kernel": n_bwd})
