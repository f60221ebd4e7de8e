"""Sampling and losses over regions and pairs: the host's milliseconds in
the ``step.losses`` span (``programs.step_losses``' region loop, in a
batch the whole pairs loop: ``ops/sampling.py``, ``ops/losses.py``), per
step of the entry, in the traced unprofiled calls."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("step.losses",), "step")
