"""VGG at the prediction: the host's milliseconds in the ``step.vgg``
span (kernel K3a and VGG blocks 2-5, ``models/vgg.py``), per step of the
entry, in the traced unprofiled calls."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("step.vgg",), "step")
