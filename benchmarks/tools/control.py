"""The readings the limits of ``correct`` are set from, at a cell's own
size, in one process: for each seed, the run's set-up and ``--calls``
calls of the entry (no window), then every finished call's numbers twice:
the program against the reference (the lower reading) and the control,
the reference in the next lower precision put in the program's place
(the upper reading). One JSON line a seed and call.

    python3 benchmarks/tools/control.py --workload strotss512.single \
        --seeds 1,2,3 --calls 1 --out chiprun_out/control.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

import run  # noqa: E402
from harness import check  # noqa: E402
from harness.cells import resolve  # noqa: E402


def readings(cell, seed: int, calls: int, device, control: bool = True):
    """[(program numbers, control numbers or None, their details)] of
    ``calls`` calls."""
    program, traffic, weights, rec, _ = run.setup(cell, seed, device)
    out = []
    for _ in range(calls):
        job = traffic.job()
        img, scales = program.call(job)
        cfg = cell.config["strotss"]
        dp, dc = [], []
        prog = check.stylization_numbers(cfg, weights, job, img, scales,
                                         run.FOLLOW, detail=dp)
        ctl = (check.stylization_numbers(cfg, weights, job, img, scales,
                                         run.FOLLOW, control=True,
                                         detail=dc)
               if control else None)
        out.append((prog, ctl, dp, dc))
    return out


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--no_control", action="store_true")
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    run._caches()
    cell = resolve(a.workload)
    device = torch.device("cuda:0")
    for seed in a.seeds.split(","):
        t = time.perf_counter()
        for i, (prog, ctl, dp, dc) in enumerate(readings(
                cell, int(seed), a.calls, device, not a.no_control)):
            rec = {"workload": a.workload, "seed": int(seed), "call": i,
                   "program": prog, "control": ctl,
                   "seconds": time.perf_counter() - t}
            print(json.dumps(rec), flush=True)
            rec.update(detail_program=dp, detail_control=dc)
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
