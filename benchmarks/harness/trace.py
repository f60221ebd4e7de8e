"""Reads a ``torch.profiler`` trace of whole stylizations: device time by
kernel name, the union of the device's busy intervals, and where the
device sat idle, by what the host was doing.

It reads the profiler's raw events (``kineto_results``) and never builds
PyTorch's event tree, whose parse took minutes for one traced 8-pair
batch on an H100's host. Profiling slows the host (49 to 77 ms a default
step), so the idle share is taken against the wall time of an unprofiled
run of the same calls, never against the profiled window.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple


def spans(prof):
    """(device spans, host spans): (start ns, end ns, name) of every
    event the profiler recorded, on the card and on the host."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        span = (s, s + e.duration_ns(), e.name())
        (dev if e.device_type() == cuda else host).append(span)
    return dev, host


def device_rows(dev) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (device seconds, launches)} of the device spans."""
    rows: Dict[str, Tuple[float, int]] = {}
    for s, e, name in dev:
        t, n = rows.get(name, (0.0, 0))
        rows[name] = (t + (e - s) / 1e9, n + 1)
    return rows


def timeline(dev):
    """(busy seconds, idle gaps [(start, end) ns]): the union of every
    device activity's interval and the gaps between its pieces."""
    merged: List[List[int]] = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return busy, gaps


def idle_by_host(gaps, host, top: int = 10) -> List[List]:
    """The device's idle time, by the innermost host operator running at
    the middle of each gap (the host's own Python when none is), the
    largest ``top``."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        hi = bisect.bisect_right(starts, mid)
        name, best = "host python", None
        # operators that started before mid; the shortest that covers it
        for h in host[max(0, hi - 400):hi]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best):
                name, best = h[2], h[1] - h[0]
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            [:top]]
