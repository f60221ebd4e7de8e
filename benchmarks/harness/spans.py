"""Reads the program's own spans (``strotss_torch.utils.timing``) of the
traced calls, alone and beside a ``torch.profiler`` trace of the same
calls: the host's time by layer, and the launch calls, the device time
and the device's idle time each layer was in.

The spans are on the clock of the profiler's host events (Unix epoch ns).
A runtime call belongs to the innermost span covering its start; a
kernel or a copy to its runtime call's span (matched by correlation id),
and to no span when it has none; an idle gap of
the device to the innermost span covering its middle. The autograd
engine's thread, which issues the backward pass's launches, runs while
the calling thread sits in its ``step.backward`` span, and attribution
by time puts its launches there.

A reader that finds no spans in its ``ctx`` returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

#: the runtime calls that launch work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
#: the children of ``step`` that make it up
STEP_PARTS = ("step.fold", "step.vgg", "step.losses", "step.backward",
              "step.update")
OUTSIDE = "(no span)"


def profile_events(prof):
    """(runtime calls [(start ns, correlation id, name)], device work
    [(start ns, end ns, name, correlation id)]) of a profile's raw events:
    the calls of CUDA's runtime and driver APIs, and every kernel, copy
    and fill on the card."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    calls, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns()
            kernels.append((s, s + e.duration_ns(), e.name(),
                            e.correlation_id()))
        elif e.name().startswith("cu"):
            calls.append((e.start_ns(), e.correlation_id(), e.name()))
    return calls, kernels


class Tree:
    """The spans of one set of calls, to find the innermost span at a
    time. Spans on one thread nest, and their starts rise with their
    index, so the spans covering a time are the last span started before
    it and its ancestors."""

    def __init__(self, spans):
        self.spans = spans
        self.starts = [s.start_ns for s in spans]

    def at(self, t: float) -> int:
        """Index of the innermost span covering ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end_ns < t:
            i = self.spans[i].parent
        return i

    def name_at(self, t: float) -> str:
        i = self.at(t)
        return OUTSIDE if i < 0 else self.spans[i].name

    def within(self, start: float, end: float, names) -> bool:
        """Whether [start, end] lies inside one span named in ``names``."""
        i = self.at(start)
        while i >= 0 and self.spans[i].name not in names:
            i = self.spans[i].parent
        return i >= 0 and end <= self.spans[i].end_ns


def self_ns(spans) -> Dict[str, int]:
    """{span name: its spans' ns less their children's}."""
    out: Dict[str, int] = defaultdict(int)
    for s in spans:
        d = s.end_ns - s.start_ns
        out[s.name] += d
        if s.parent >= 0:
            out[spans[s.parent].name] -= d
    return dict(out)


def total_ns(spans, names) -> int:
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names)


def n_named(spans, name: str) -> int:
    return sum(1 for s in spans if s.name == name)


def host_ms(ctx: Dict, names, per: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` in the traced unprofiled calls
    (``ctx["spans"]``), per span ``per`` ('scale' or 'step')."""
    spans = ctx.get("spans")
    n = n_named(spans or (), per)
    if not n:
        return None
    return total_ns(spans, names) / 1e6 / n


def step_launches(ctx: Dict) -> Optional[float]:
    """Launch calls inside ``step`` spans per step, in the profiled calls
    (``ctx["profile_spans"]``, ``ctx["launch_calls"]``); None where the
    profile holds no launch call."""
    spans, calls = ctx.get("profile_spans"), ctx.get("launch_calls")
    launches = [c for c in calls or () if c[2] in LAUNCH_CALLS]
    steps = n_named(spans or (), "step")
    if not steps or not launches:
        return None
    tree = Tree(spans)
    inside = 0
    for t, _, _ in launches:
        i = tree.at(t)
        while i >= 0 and spans[i].name != "step":
            i = spans[i].parent
        inside += i >= 0
    return inside / steps


def by_span(spans, profile_spans, calls, kernels, gaps) -> Dict[str, Dict]:
    """{span name: host self ms (``spans``), launch calls, device ms and
    device idle ms (``profile_spans`` and the profile: ``calls`` and
    ``kernels`` as :func:`profile_events` gives them, ``gaps`` as
    ``harness.trace.timeline``)}, each per step of its own set of calls;
    ``OUTSIDE`` collects what lies in no span."""
    tree = Tree(profile_spans)
    n_host = max(n_named(spans, "step"), 1)
    n_prof = max(n_named(profile_spans, "step"), 1)
    rows: Dict[str, Dict] = defaultdict(lambda: {
        "host_self_ms": 0.0, "launches": 0.0, "device_ms": 0.0,
        "idle_ms": 0.0})
    for name, ns in self_ns(spans).items():
        rows[name]["host_self_ms"] = ns / 1e6 / n_host
    launched_in = {}
    for t, corr, call in calls:
        name = tree.name_at(t)
        launched_in[corr] = name
        if call in LAUNCH_CALLS:
            rows[name]["launches"] += 1 / n_prof
    for s, e, _, corr in kernels:
        rows[launched_in.get(corr, OUTSIDE)]["device_ms"] += \
            (e - s) / 1e6 / n_prof
    for s, e in gaps:
        rows[tree.name_at((s + e) / 2)]["idle_ms"] += (e - s) / 1e6 / n_prof
    return dict(rows)


def table(rows: Dict[str, Dict]) -> List[str]:
    """The by-span rows as lines of text, the largest host share first."""
    keys = ("host_self_ms", "launches", "device_ms", "idle_ms")
    out = [f"{'span':<16}" + "".join(f"{k:>14}" for k in keys)]
    for name, r in sorted(rows.items(),
                          key=lambda kv: -kv[1]["host_self_ms"]):
        out.append(f"{name:<16}" + "".join(f"{r[k]:>14.4f}" for k in keys))
    total = {k: sum(r[k] for r in rows.values()) for k in keys}
    out.append(f"{'total':<16}" + "".join(f"{total[k]:>14.4f}"
                                          for k in keys))
    return out
