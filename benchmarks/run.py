"""The port's benchmark: one run of one cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the VGG16 weights and the images (and masks) from ``--seed`` on the
card, warms up the cell's shapes, then drives the entry in a closed loop:
whole stylizations back to back, one call in flight, for ``--seconds``.
``--trace 0`` reports the end-to-end metrics that the cell lists, of:
``image_s``, the window's seconds up to the end of the last stylization
finished inside it over the stylizations (pairs) finished; ``setup_s``;
``memory_peak_gib``, the most device memory the window's calls allocated.
``--trace 1`` times ``trace_calls`` calls without the profiler, then as
many under the program's span tracing (``strotss_torch.utils.timing.
tracing``, the step's memory read too), then as many under both the
tracing and the profiler, and reports the cell's per-layer metrics
(``benchmarks/metrics/``); the table of the spans by layer goes to
stderr. Either way a sample of the finished calls, drawn from the seed,
is then held to the plain reference (:mod:`harness.check`) and
``correct`` says whether every number stayed within its limit
(``benchmarks/limits/<cell>.json``).
The last line on stdout is the result as JSON; the numbers compared and
their limits are the last lines on stderr.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
for _p in (REPO, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: modules that may not be loaded in the process that prints the result,
#: by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "strotss_tpu")
FOLLOW = 3


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches():
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc builds go to build/strotss_torch/<hash>)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(REPO, "build", sub)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Sample:
    """A reservoir of ``size`` finished calls, drawn with the seed."""

    def __init__(self, size: int, seed: int):
        import numpy as np

        self.size, self.seen, self.kept = size, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.kept[j] = item


def peak_bytes(device, rec) -> int:
    """The device memory the window's calls allocated at most (0 on the
    CPU), the peaks that the step's memory readings reset included."""
    import torch

    if device.type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(device), rec.peak_seen)


def setup(cell, seed: int, device):
    """(program, traffic, weights, recorder, seeds) of a run: the weights
    and the images from ``seed`` on ``device``, the step layer wrapped,
    and one call of the cell's shapes made to warm them up."""
    import dataclasses

    from harness import drive, inputs
    from strotss_torch import StrotssConfig

    t = time.perf_counter()
    seeds = inputs.streams(seed, 3)
    cfg = StrotssConfig(**cell.config["strotss"])
    weights = inputs.vgg_weights(seeds[0], device)
    traffic = inputs.Traffic(cell.traffic, seeds[1], device)
    rec = drive.Recorder(FOLLOW)
    drive.install(rec)
    program = drive.Program(cfg, weights, device, rec)
    t_inputs = time.perf_counter()
    program.call(traffic.job(), dataclasses.replace(
        cfg, **cell.config.get("warmup", {})))
    print(f"set-up: imports {t - T0:.3f} s, weights and images "
          f"{t_inputs - t:.3f} s, warm-up call "
          f"{time.perf_counter() - t_inputs:.3f} s", file=sys.stderr)
    return program, traffic, weights, rec, seeds


def run(args, cell, device) -> int:
    import torch

    from harness import check, drive, layers, trace, work

    program, traffic, weights, rec, seeds = setup(cell, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    sample = Sample(int(cell.traffic.get("check", 1)), seeds[2])
    pairs = int(cell.traffic.get("pairs", 1))
    attempted = finished = 0
    result, traced = {}, None

    def one(deadline=None):
        job = traffic.job()
        out, scales = program.call(job, deadline=deadline)
        sample.offer((job, out, scales))

    if args.trace == 0:
        t0 = time.perf_counter()
        deadline, t_last = t0 + args.seconds, None
        while time.perf_counter() < deadline:
            attempted += pairs
            try:
                one(deadline)
            except drive.Stop:
                break
            t_last = time.perf_counter()
            finished += pairs
        if not finished:
            print("no stylization finished inside the window",
                  file=sys.stderr)
            return 3
        print(f"window: {finished} stylizations in {t_last - t0:.6f} s, "
              f"{(t_last - t0) / finished:.6f} s each", file=sys.stderr)
        values = {"image_s": (t_last - t0) / finished, "setup_s": setup_s,
                  "memory_peak_gib": peak_bytes(device, rec) / 2 ** 30}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        from torch.profiler import ProfilerActivity, profile

        from harness import spans
        from strotss_torch.utils.timing import tracing

        k = int(cell.traffic.get("trace_calls", 1))
        host0, steps0 = rec.host_s, rec.steps
        t0 = time.perf_counter()
        for _ in range(k):
            one()
        wall = time.perf_counter() - t0
        host, steps = rec.host_s - host0, rec.steps - steps0
        # the program's spans: a set of its own, so that the set above
        # times the calls with tracing off; the step's memory is read in
        # it too
        rec.watch_memory(device.type == "cuda")
        with tracing() as traced_set:
            for _ in range(k):
                one()
        rec.watch_memory(False)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with tracing() as profiled_set, profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for _ in range(k):
                one()
            window = time.perf_counter() - t1
        attempted = finished = 3 * k * pairs
        launch_calls, kernel_events = spans.profile_events(prof)
        dev_spans, host_spans = trace.spans(prof)
        del prof
        busy, gaps = trace.timeline(dev_spans)
        kernels = trace.device_rows(dev_spans)
        rates = work.peaks(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "")[1]
        ctx = {"calls": [work.call_shapes(cell.config["strotss"],
                                          cell.traffic)] * k,
               "kernels": kernels, "busy_s": busy, "wall_s": wall,
               "images": k * pairs, "step_host_s": host, "steps": steps,
               "step_transient_b": rec.transient, "rates": rates,
               "spans": traced_set.spans,
               "profile_spans": profiled_set.spans,
               "launch_calls": launch_calls}
        result["metrics"] = layers.read_all(cell.per_layer, ctx)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, (s, _) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:10]],
            "idle_gaps": trace.idle_by_host(gaps, host_spans)}
        print("by span, per step of the entry (host self ms: the traced "
              "set; the rest: the profiled set):", file=sys.stderr)
        for row in spans.table(spans.by_span(
                traced_set.spans, profiled_set.spans, launch_calls,
                kernel_events, gaps)):
            print("  " + row, file=sys.stderr)
        traced = {"busy_s": busy, "window_s": window}
    peak = peak_bytes(device, rec)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 4

    # the check runs once the window has closed and the peak is read
    del program, traffic
    rec.scales = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = {}
    for job, out, scales in sample.kept:
        nums = check.stylization_numbers(cell.config["strotss"], weights,
                                         job, out, scales, FOLLOW)
        for k_, v in nums.items():
            numbers[k_] = max(numbers.get(k_, 0.0), v)
    correct = bool(sample.kept) and check.judge(numbers, cell.limits)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": 1, "memory_peak_bytes": int(peak),
           "power_limit_w": _power_limit() if device.type == "cuda"
           else None}
    if traced:
        dev.update(traced)
    compared = {k_: {"value": numbers.get(k_), "limit": v["limit"]}
                for k_, v in cell.limits.items()}
    line = {"correct": correct, "attempted": attempted,
            "failed": 0, "metrics": result["metrics"], "device": dev}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = compared
    print(json.dumps(line), flush=True)
    for k_, v in compared.items():
        print(f"{k_} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"calls compared {len(sample.kept)} of {sample.seen}",
          file=sys.stderr, flush=True)
    return 0


def main(argv=None, device=None, cell=None) -> int:
    """``device`` and ``cell`` stand in for the card and the cell named
    in BENCHMARK.json (the benchmark's CPU tests); a run passes neither."""
    args = _parse(argv)
    _caches()
    os.environ["USE_FLAX"] = "0"
    # the work is on the card: one host thread issues it, and no idle pool
    # of CPU threads competes with it for the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    from harness.cells import resolve

    cell = cell or resolve(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    return run(args, cell, torch.device(device))


if __name__ == "__main__":
    sys.exit(main())
