"""Scale driver (``solve.stylize_single``, ``batch.prepare_scale_batch``):
the host's milliseconds in each scale's set-up, the ``scale.setup`` span
(the seed pyramid, the content features, the style targets and their
moments, the masks), per scale, in the traced unprofiled calls."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("scale.setup",), "scale")
