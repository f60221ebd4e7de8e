"""Step layer: the host's milliseconds inside the step layer's calls
(``programs.optimization_steps``, ``programs.batch_steps``) per step of
the entry, in the unprofiled calls of the traced run. The step never
waits for the card, so this is the time to issue a step (in a batch one
step covers every pair)."""


def read(ctx):
    if not ctx["steps"]:
        return None
    return 1e3 * ctx["step_host_s"] / ctx["steps"]
