"""Step layer: the most device memory, in GiB, that one step call
(``programs.optimization_steps``, ``programs.batch_steps``) allocated above
what was allocated as it began: VGG's activations kept for the backward,
the loss kernels' buffers, the gradients. Read from the allocator's peak,
reset before each call, in the traced unprofiled calls; none on the CPU.
What a scale holds across its steps (weights, features, targets, the
pyramid and its slots) lies under it, so the two make the run's peak."""


def read(ctx):
    b = ctx.get("step_transient_b")
    return None if not b else b / 2 ** 30
