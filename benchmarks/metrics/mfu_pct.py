"""Whole step on the device: model FLOPs of the calls over the bf16 peak
(989 TFLOP/s on an H100 SXM) and over their unprofiled wall time.

Model FLOPs are the matrix products the mathematics needs, counted from
the shapes, whatever computes them: VGG16's convolutions forward at each
scale's content and style images and forward plus input gradient at the
stylized image every step; and each step's loss products, a pair and
region at a time: the moments' covariance and its gradient, the
self-similarity's two Gram matrices (symmetric: N(N+1)C each) and the
prediction side's gradient, REMD's two distance matrices, or Sinkhorn's
passes with its read-out and the Danskin gradient. Float32 products are
priced at the bf16 peak on purpose: a cheaper route that still passes the
check (3-pass bf16) cannot read over 100%.
"""

CONVS = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
         (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
         (512, 512), (512, 512))
POOL_BEFORE = (2, 4, 7, 10)  # conv indices that follow a 2x2 max pool


def vgg_flops(h, w):
    """Forward FLOPs of VGG16's 13 convolutions on one h x w image."""
    total = 0
    for i, (cin, cout) in enumerate(CONVS):
        if i in POOL_BEFORE:
            h, w = h // 2, w // 2
        total += 2 * h * w * 9 * cin * cout
    return total


def transport_flops(s, c):
    n = s["n"]
    if not s["sinkhorn"]:
        return 2 * n * n * c
    # 2 * iters passes, the read-out, the frozen plan's two gradients
    return (2 * s["iters"] + 1 + 2) * 2 * n * n * c


def loss_flops(s):
    n, c = s["n"], s["c"]
    moments = 4 * n * c * c
    selfsim = 2 * n * (n + 1) * c + 2 * n * n * c
    return moments + selfsim + transport_flops(s, c) + transport_flops(s, 3)


def call_flops(call):
    total = 0
    for s in call:
        b = s["pairs"]
        total += b * (vgg_flops(*s["chw"]) + vgg_flops(*s["shw"]))
        total += s["steps"] * (2 * b * vgg_flops(*s["chw"])
                               + b * s["regions"] * loss_flops(s))
    return total


def read(ctx):
    if ctx["wall_s"] <= 0:
        return None
    flops = sum(call_flops(c) for c in ctx["calls"])
    return 100.0 * flops / ctx["rates"]["bf16"] / ctx["wall_s"]
