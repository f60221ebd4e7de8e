"""Scale driver: the host's milliseconds in the ``scale.readback`` spans
(each ``.cpu()`` of the loss rows at a scale's end, which waits for the
card to finish the scale's steps), per scale, in the traced unprofiled
calls."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("scale.readback",), "scale")
