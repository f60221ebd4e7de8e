"""Runs one cell several times, each run a process of its own as the
check runs it, and writes each run's result line, exit code and the end
of its stderr to a JSON-lines file; prints each run's metrics and the
quartile spread of each metric over the runs.

    python3 benchmarks/tools/sets.py --workload strotss512.single \
        --seeds 101,102,103 --trace 0 --out chiprun_out/single.jsonl

``--seconds`` defaults to BENCHMARK.json's ``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def spread(values):
    """Interquartile distance over the median (Python's quartiles)."""
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def cpu_ticks():
    """(steal, total) jiffies of the machine's CPUs, from /proc/stat."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except OSError:
        return None
    return v[7] if len(v) > 7 else 0, sum(v[:8])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        seconds = a.seconds or json.load(f)["run_seconds"]
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    values = {}
    for seed in a.seeds.split(","):
        t, ticks = time.perf_counter(), cpu_ticks()
        p = subprocess.run(
            [sys.executable, "benchmarks/run.py", "--workload", a.workload,
             "--seed", seed, "--seconds", str(seconds), "--trace",
             str(a.trace)], cwd=REPO, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        rec = {"workload": a.workload, "seed": int(seed), "trace": a.trace,
               "rc": p.returncode, "seconds": time.perf_counter() - t,
               "result": res, "stderr": p.stderr[-3000:]}
        after = cpu_ticks()
        if ticks and after:
            # CPU seconds the machine's host took back during the run
            rec["steal_s"] = (after[0] - ticks[0]) / os.sysconf(
                "SC_CLK_TCK")
        with open(a.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = None if res is None else {
            "correct": res["correct"],
            **{k: v["value"] for k, v in res["metrics"].items()},
            "peak_gib": res["device"]["memory_peak_bytes"] / 2 ** 30,
            **{k: v["value"] for k, v in res.get("compared", {}).items()}}
        print(seed, p.returncode, round(rec["seconds"], 1),
              rec.get("steal_s"), short, flush=True)
        if res is None:
            print(p.stderr[-2000:], flush=True)
        for k, v in (res or {}).get("metrics", {}).items():
            values.setdefault(k, []).append(v["value"])
    for k, v in values.items():
        print(k, "median", statistics.median(v), "spread", spread(v),
              flush=True)


if __name__ == "__main__":
    main()
