"""A cell cut to a size the CPU runs in seconds, for the benchmark's
tests: the harness's set-up, window, trace and check as a run drives
them, on the CPU in float32 (or bfloat16)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

import run  # noqa: E402
from harness.cells import resolve  # noqa: E402


def cell(pairs=1, regions=0, dtype="float32", levels=2, max_iter=3,
         workload="strotss512.single"):
    """``workload``'s cell (its metrics and limits) at a CPU's size."""
    base = resolve(workload)
    cfg = dict(base.config)
    cfg["strotss"] = dict(cfg["strotss"], levels=levels, max_iter=max_iter,
                          sample_size=64, compute_dtype=dtype)
    traffic = {"content_hw": [40, 56], "style_hw": [48, 40], "images": 2,
               "pairs": pairs, "regions": regions, "check": 1,
               "trace_calls": 1}
    if pairs > 1:
        traffic["alphas"] = [0.5, 2.0, 1.0, 4.0][:pairs]
    return base._replace(config=cfg, traffic=traffic)


def drive(c, trace=0, seed=2 ** 40 + 7, seconds=4.0):
    """(exit code, the last stdout line as JSON or None, stderr)."""
    import torch

    torch.set_num_threads(2)
    out, err = io.StringIO(), io.StringIO()
    # the test process may hold JAX already (the repository's conftest
    # loads it): the run is judged on what it loads itself
    before = set(run.forbidden_modules())
    check = run.forbidden_modules
    run.forbidden_modules = lambda: sorted(set(check()) - before)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = run.main(["--workload", c.name, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace",
                           str(trace)],
                          device="cpu", cell=c)
    finally:
        run.forbidden_modules = check
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
