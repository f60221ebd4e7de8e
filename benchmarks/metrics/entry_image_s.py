"""Entry: seconds a stylization (a pair) in the traced run's calls made
with tracing and the profiler off, ``image_s`` read per layer where its
runs spread too widely across processes for a bound (the host's pace)."""


def read(ctx):
    if not ctx.get("images") or ctx["wall_s"] <= 0:
        return None
    return ctx["wall_s"] / ctx["images"]
