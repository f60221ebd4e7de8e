"""Timing: the reference's start/stop wall clock, and a CUDA-event timer.

PyTorch returns before the card finishes its work, so a host clock around
CUDA work measures the enqueue; ``CudaTimer`` records events on the
current stream and reads the time between them once they have completed.
"""

from __future__ import annotations

import time

import torch


class Timer:
    """start()/stop() wall clock; elapsed rounded to 3 decimals."""

    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0

    def start(self):
        self._start = time.time()

    def stop(self):
        self._elapsed = round(time.time() - self._start, 3)
        self._start = 0.0

    @property
    def elapsed_time(self) -> float:
        return self._elapsed


class CudaTimer:
    """Device time of the work enqueued between ``start()`` and ``stop()``.

    ``seconds()`` waits for the stop event. Use it only on a CUDA device.
    """

    def __init__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def start(self):
        self._start.record()

    def stop(self):
        self._end.record()

    def seconds(self) -> float:
        self._end.synchronize()
        return self._start.elapsed_time(self._end) / 1e3
