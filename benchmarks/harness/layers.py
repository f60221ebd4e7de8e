"""Per-layer metrics: each is a module ``benchmarks/metrics/<name>.py``
with ``read(ctx) -> float | None``, found by the metric's name.

``ctx`` holds what the traced run measured:

- ``calls``: the profiled calls' scale records (:func:`harness.work.
  call_shapes`, one list a call);
- ``kernels``: {kernel name: (device seconds, launches)} of the profile;
- ``busy_s``: the union of the device's busy intervals in the profile;
- ``wall_s``: the wall time of the same calls made without the profiler;
- ``step_host_s``, ``steps``: the host's time inside the step layer's
  calls and the entry's steps, in the unprofiled calls;
- ``rates``: the chip's peaks (:data:`harness.work.PEAKS`);
- ``spans``: the program's spans (``strotss_torch.utils.timing``) of a
  second set of as many calls, unprofiled, under its tracing;
- ``profile_spans``, ``launch_calls``: the spans of the profiled calls and
  the runtime calls the profile recorded in them
  (:func:`harness.spans.profile_events`).

A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Dict, List, Optional

from harness.cells import BENCH


def reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def launches(ctx: Dict, names) -> int:
    return sum(n for k, (_, n) in ctx["kernels"].items()
               if k.removeprefix("void ").startswith(tuple(names)))


def device_s(ctx: Dict, names) -> float:
    return sum(s for k, (s, _) in ctx["kernels"].items()
               if k.removeprefix("void ").startswith(tuple(names)))


def roofline(ctx: Dict, names, bound_s: float,
             expect: Dict[str, int]) -> Optional[float]:
    """100 x the least time of the work (``bound_s``) over the device
    time of the kernels ``names``; None when the profile holds none of
    them, or when a kernel of ``expect`` shows another launch count than
    the shapes give (its time would be counted wrong)."""
    t = device_s(ctx, names)
    if t <= 0:
        return None
    for k, n in expect.items():
        seen = launches(ctx, [k])
        if seen != n:
            print(f"{k}: {seen} launches in the profile, {n} from the "
                  "shapes; roofline left out", file=sys.stderr)
            return None
    return 100.0 * bound_s / t


def read_all(metrics: List[Dict], ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
