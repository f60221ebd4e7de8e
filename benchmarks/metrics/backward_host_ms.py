"""Backward and RMSprop: the host's milliseconds in the ``step.backward``
(``torch.autograd.grad``) and ``step.update`` (``RMSprop.step``) spans,
per step of the entry, in the traced unprofiled calls."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("step.backward", "step.update"), "step")
