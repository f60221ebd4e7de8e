"""The program's spans in one cell: the host's time, the launch calls,
the device time and the device's idle time by layer, read from the
program's own spans (``strotss_torch.utils.timing``) beside a
``torch.profiler`` trace, and the per-layer metrics that read them
(``benchmarks/metrics/``: ``scale_setup_ms``, ``readback_wait_ms``,
``vgg_host_ms``, ``loss_host_ms``, ``backward_host_ms``,
``step_launches``).

    python3 benchmarks/tools/spans.py --workload strotss512.single \
        --seed 7 --out spans_single.json

After the run's set-up (:func:`run.setup`): ``--rounds`` pairs of sets of
``trace_calls`` calls, one set with tracing off and one under
``timing.tracing()``, in alternating order (the tracing-on overhead is
the traced sets' wall over the untraced sets', minus 1); then one set
under tracing and the profiler. Then the cost of a span with tracing off
and on, timed in a loop on this host. Prints on stderr the overhead, the
step spans' sum against the benchmark wrapper's host time in the same
calls (``drive.Recorder.host_s``), the share of the steps their parts
cover, the share of the device's idle time inside a span, and the table
by span per step of the entry; writes all of it as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

import run  # noqa: E402
from harness import layers, spans, trace  # noqa: E402
from harness.cells import resolve  # noqa: E402

METRICS = ("scale_setup_ms", "readback_wait_ms", "vgg_host_ms",
           "loss_host_ms", "backward_host_ms", "step_launches")


def span_cost(n: int = 200_000, block: int = 1000):
    """(ns a span costs with tracing off, with tracing on) on this host:
    a loop of ``with timing.span(...)`` against the same loop empty; on,
    in tracing blocks of ``block`` spans (about a call's), each block's
    close included."""
    from strotss_torch.utils import timing

    def empty():
        pass

    def one():
        with timing.span("step.vgg"):
            pass

    def loop(body, blocks=1, traced=False):
        t = time.perf_counter_ns()
        for _ in range(blocks):
            with (timing.tracing() if traced else contextlib.nullcontext()):
                for _ in range(n // blocks):
                    body()
        return (time.perf_counter_ns() - t) / n

    base = min(loop(empty) for _ in range(3))
    off = min(loop(one) for _ in range(3)) - base
    on = min(loop(one, n // block, True) for _ in range(3)) - base
    return off, on


def measure(cell, seed: int, device, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from strotss_torch.utils.timing import tracing

    program, traffic, _, rec, _ = run.setup(cell, seed, device)
    k = int(cell.traffic.get("trace_calls", 1))

    def one_set(traced):
        host0 = rec.host_s
        t0 = time.perf_counter()
        if traced:
            with tracing() as tr:
                for _ in range(k):
                    program.call(traffic.job())
        else:
            tr = None
            for _ in range(k):
                program.call(traffic.job())
        return time.perf_counter() - t0, rec.host_s - host0, tr

    walls = {False: [], True: []}
    traced_spans, traced_host = [], 0.0
    for r in range(rounds):
        for traced in ((False, True) if r % 2 == 0 else (True, False)):
            wall, host, tr = one_set(traced)
            walls[traced].append(wall)
            if traced:
                # one list of one thread's spans: indices shifted
                shift = len(traced_spans)
                traced_spans += [s._replace(parent=s.parent + shift
                                            if s.parent >= 0 else -1)
                                 for s in tr.spans]
                traced_host += host
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tracing() as ptr, profile(activities=acts) as prof:
        for _ in range(k):
            program.call(traffic.job())
    calls, kernels = spans.profile_events(prof)
    dev, host = trace.spans(prof)
    del prof
    busy, gaps = trace.timeline(dev)
    ctx = {"spans": traced_spans, "profile_spans": ptr.spans,
           "launch_calls": calls}
    rows = spans.by_span(traced_spans, ptr.spans, calls, kernels, gaps)
    steps = spans.total_ns(traced_spans, ("step",)) / 1e9
    parts = spans.total_ns(traced_spans, spans.STEP_PARTS) / 1e9
    idle = sum(e - s for s, e in gaps) / 1e9
    tree = spans.Tree(ptr.spans)
    outside = sum(e - s for s, e in gaps if tree.at((s + e) / 2) < 0) / 1e9
    # the clocks agree when each convolution the profiler saw lies in a
    # span where VGG runs
    convs = [tree.within(s, e, ("step.vgg", "scale.setup"))
             for s, e, name in host if name == "aten::conv2d"]
    off_ns, on_ns = span_cost()
    n_steps = spans.n_named(traced_spans, "step")
    untraced = statistics.median(walls[False])
    return {
        "cell": cell.name, "seed": seed, "calls_a_set": k,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "power_limit_w": (run._power_limit() if device.type == "cuda"
                          else None),
        "untraced_wall_s": walls[False], "traced_wall_s": walls[True],
        "overhead": [t / u - 1 for t, u in zip(walls[True], walls[False])],
        "overhead_median": statistics.median(walls[True]) / untraced - 1,
        # what the spans of a set cost at the loop's price, over its wall
        "overhead_from_cost": (on_ns - off_ns) * len(traced_spans) / rounds
        / 1e9 / untraced,
        "step_spans_s": steps, "recorder_host_s": traced_host,
        "step_over_host": steps / traced_host if traced_host else None,
        "parts_over_step": parts / steps if steps else None,
        "idle_s": idle, "busy_s": busy,
        "idle_in_span": 1 - outside / idle if idle else None,
        "convs_in_vgg_spans": sum(convs) / len(convs) if convs else None,
        "spans_a_step": len(traced_spans) / n_steps if n_steps else None,
        "span_off_ns": off_ns, "span_on_ns": on_ns,
        "metrics": {m: layers.reader(m)(ctx) for m in METRICS},
        "by_span": rows,
    }


def report(res: dict) -> None:
    def pct(v):
        return "n/a" if v is None else f"{100 * v:.2f}%"

    print(f"{res['cell']} seed {res['seed']} on {res['device']} "
          f"({res['power_limit_w']} W)", file=sys.stderr)
    print(f"tracing-on overhead {pct(res['overhead_median'])} (medians; "
          f"pairs {[round(100 * o, 2) for o in res['overhead']]} %); "
          f"{pct(res['overhead_from_cost'])} from the spans' cost",
          file=sys.stderr)
    print(f"step spans {res['step_spans_s']:.4f} s of the wrapper's "
          f"{res['recorder_host_s']:.4f} s host time: "
          f"{pct(res['step_over_host'])}; fold+vgg+losses+backward+update "
          f"{pct(res['parts_over_step'])} of the steps", file=sys.stderr)
    print(f"device idle {res['idle_s']:.4f} s in the profiled calls, "
          f"{pct(res['idle_in_span'])} inside a span; "
          f"{res['spans_a_step']:.1f} spans a step, a span "
          f"{res['span_off_ns']:.0f} ns off, {res['span_on_ns']:.0f} ns on; "
          f"convolutions inside VGG's spans {pct(res['convs_in_vgg_spans'])}",
          file=sys.stderr)
    print("per step of the entry:", file=sys.stderr)
    for line in spans.table(res["by_span"]):
        print("  " + line, file=sys.stderr)
    print(" ".join(f"{m}={v!r}" for m, v in res["metrics"].items()),
          file=sys.stderr, flush=True)


def main(argv=None, device=None, cell=None) -> dict:
    """``device`` and ``cell`` stand in for the card and the cell named
    in BENCHMARK.json (the CPU tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run._caches()
    import torch

    if device is None:
        os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card")
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    res = measure(cell or resolve(args.workload), args.seed,
                  torch.device(device), args.rounds)
    report(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
