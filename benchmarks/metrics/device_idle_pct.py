"""Device: the share of the wall time in which no operation ran on the
card, 100 x (1 - busy / wall): busy is the union of the device's
intervals in the profiled calls, wall the time of the same calls made
without the profiler (which slows the host, not the card)."""


def read(ctx):
    if ctx["busy_s"] <= 0 or ctx["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["wall_s"])
