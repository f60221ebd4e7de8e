"""Step: the profiler's kernel-launch runtime calls (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel*``, ``cudaGraphLaunch``) that
start inside a ``step`` span, per step of the entry, in the profiled
calls; None where the profile holds none (the CPU)."""

from harness import spans


def read(ctx):
    return spans.step_launches(ctx)
