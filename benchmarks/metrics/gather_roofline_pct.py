"""Kernel K5 (hypercolumn gathers, ``csrc/gather.cu``): the least time of
its launches over their device time. Every launch is bound by bytes.

A hypercolumn's maps are the image (3 channels) and the VGG taps, each
at its block's size (halved, floored, once a block after the first), the
image and block1's taps in float32 and blocks 2-5's in the compute dtype.
A map at the image's size is read by the nearest lookup, one row a
sample; a smaller one by the bilinear lookup, four corner rows a sample;
neither more than the whole map. Launches, a pair and region at a time:

- the paired forward (``gather_fwd_kernel``), one a step: both sides'
  maps read at the content's size and both (n, C) float32 row blocks
  written;
- the style forward (``gather_fwd_kernel``), one a scale: the style's
  maps read by the nearest lookup and one row block written;
- the backward (``gather_sort_kernel`` then ``gather_acc_kernel``), one
  of each a step: the prediction rows' cotangent read and every map's
  dense gradient written in the map's dtype.
"""

from harness.layers import roofline
from harness.work import TAP_CHANNELS, bound_s

NAMES = ("gather_fwd_kernel", "gather_sort_kernel", "gather_acc_kernel")


def maps(h, w, taps, dtype):
    """(h, w, channels, bytes a value, nearest) of each map of a
    hypercolumn on an h x w image."""
    low = 2 if dtype == "bfloat16" else 4
    out = [(h, w, 3, 4, True)]
    for tap in taps:
        block = int(tap[len("block")])
        f = 2 ** (block - 1)
        out.append((h // f, w // f, TAP_CHANNELS[tap],
                    4 if block == 1 else low, block == 1))
    return out


def read_bytes(hw_maps, n, nearest_only=False):
    """Bytes the lookups of n samples read from the maps."""
    total = 0
    for h, w, c, b, nearest in hw_maps:
        rows = n if nearest or nearest_only else 4 * n
        total += min(h * w, rows) * c * b
    return total


def paired_fwd(h, w, n, taps, dtype, rates):
    m = maps(h, w, taps, dtype)
    c = sum(x[2] for x in m)
    return bound_s(rates, nbytes=2 * (4 * n * c + read_bytes(m, n)))


def style_fwd(h, w, n, taps, dtype, rates):
    m = maps(h, w, taps, dtype)
    c = sum(x[2] for x in m)
    return bound_s(rates, nbytes=4 * n * c + read_bytes(m, n, True))


def bwd(h, w, n, taps, dtype, rates):
    m = maps(h, w, taps, dtype)
    c = sum(x[2] for x in m)
    return bound_s(rates, nbytes=4 * n * c + sum(
        mh * mw * mc * b for mh, mw, mc, b, _ in m))


def read(ctx):
    r, bound, n_fwd, n_bwd = ctx["rates"], 0.0, 0, 0
    for call in ctx["calls"]:
        for s in call:
            k = s["pairs"] * s["regions"]
            args = (s["n"], s["taps"], s["dtype"], r)
            bound += k * (s["steps"] * (paired_fwd(*s["chw"], *args)
                                        + bwd(*s["chw"], *args))
                          + style_fwd(*s["shw"], *args))
            n_fwd += k * (s["steps"] + 1)
            n_bwd += k * s["steps"]
    return roofline(ctx, NAMES, bound, {"gather_fwd_kernel": n_fwd,
                                        "gather_sort_kernel": n_bwd,
                                        "gather_acc_kernel": n_bwd})
