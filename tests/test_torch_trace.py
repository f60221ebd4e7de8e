"""The port's spans and counters (``strotss_torch.utils.timing``) on the
CPU: the span tree of a traced stylization and of a masked batch, the
spans against the benchmark's own clock around the step layer and
against ``torch.profiler``'s host events, results unchanged by tracing,
and the benchmark's readers of the spans (``benchmarks/harness/spans.py``,
``benchmarks/tools/spans.py``).

Tiny sizes: 40x48 images, one or two taps, 32 samples, float32.
"""

import importlib.util
import os
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch import solve
from strotss_torch.models.weights import random_params
from strotss_torch.parallel import batch, stylize_batch
from strotss_torch.solve import stylize_single
from strotss_torch.utils import timing

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks")
for _p in (os.path.dirname(BENCH), BENCH, os.path.join(BENCH, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import drive, spans as bspans  # noqa: E402

STEP_PARTS = {"step.fold", "step.vgg", "step.losses", "step.backward",
              "step.update"}
LOSS = ("loss.sample", "loss.content", "loss.style")


def _cfg(**kw):
    base = dict(levels=2, max_iter=2, sample_size=32,
                compute_dtype="float32", taps=("block1_conv1",))
    return strotss_torch.StrotssConfig(**dict(base, **kw))


def _img(seed, b=1, h=40, w=48):
    return torch.tensor(np.random.default_rng(seed).random((b, h, w, 3)),
                        dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return random_params("16", 0)


def _single(params, cfg=None, **kw):
    return stylize_single(_img(1), _img(2, h=40, w=40), cfg or _cfg(),
                          params, **kw)


def _batch(params, cfg=None):
    """2 pairs, 2 regions each (content left/right, style top/bottom)."""
    cm = np.zeros((2, 2, 40, 48, 1), np.float32)
    sm = np.zeros((2, 2, 40, 40, 1), np.float32)
    cm[:, 0, :, :24], cm[:, 1, :, 24:] = 1.0, 1.0
    sm[:, 0, :20], sm[:, 1, 20:] = 1.0, 1.0
    return stylize_batch(_img(1, 2).numpy(), _img(2, 2, 40, 40).numpy(),
                         cfg or _cfg(), params, content_masks=cm,
                         style_masks=sm, alphas=[1.0, 4.0],
                         pair_seeds=[3, 11], device="cpu")


def _check_tree(spans, levels, steps, units):
    """One call, ``levels`` scales, ``levels * steps`` steps, each step
    made of its five parts and one of each loss span a (region, pair) of
    ``units``; every child inside its parent, every span in the call."""
    names = Counter(s.name for s in spans)
    assert names["call"] == 1
    assert names["scale"] == names["scale.setup"] == levels
    assert names["step"] == levels * steps
    call_ids = {s.call_id for s in spans}
    assert call_ids == {spans[0].call_id} and spans[0].name == "call"
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for i, s in enumerate(spans):
        kids = [c for c in spans if c.parent == i]
        if s.name == "step":
            assert spans[s.parent].name == "scale"
            assert sorted(c.name for c in kids) == sorted(STEP_PARTS)
        if s.name == "step.losses":
            got = Counter((c.name, c.attrs["region"], c.attrs["pair"])
                          for c in kids)
            assert got == Counter((n, r, p) for r, p in units for n in LOSS)
    assert [s.attrs["index"] for s in spans if s.name == "scale"] == \
        list(range(levels))


def test_spans_are_one_shared_no_op_while_tracing_is_off():
    a = timing.span("step")
    assert a is timing.span("loss.sample", region=0, pair=0)
    with a as inner:
        assert inner is a
    with timing.tracing() as tr:
        pass
    with timing.span("step"):
        pass
    assert tr.spans == []
    # inside a tracing block, another thread's spans are not recorded
    seen = []
    with timing.tracing() as tr:
        t = threading.Thread(target=lambda: seen.append(timing.span("x")))
        t.start()
        t.join(timeout=30)
        with timing.span("mine", k=1):
            pass
    assert not t.is_alive() and seen == [a]
    assert [(s.name, s.parent, s.call_id, s.attrs) for s in tr.spans] == \
        [("mine", -1, 0, {"k": 1})]


def test_counters_count_always_and_tracing_reports_their_change():
    timing.count("test.things", 2)
    before = timing.counters()["test.things"]
    with timing.tracing() as tr:
        timing.count("test.things")
        timing.count("test.other", 3)
    assert tr.counts == {"test.things": 1, "test.other": 3}
    assert timing.counters()["test.things"] == before + 1


def test_a_traced_stylization_gives_the_span_tree(params):
    with timing.tracing() as tr:
        _, info = _single(params, progress_cb=lambda *a: None)
    _check_tree(tr.spans, 2, 2, [(0, 0)])
    assert {s.attrs["px"] for s in tr.spans if s.name == "scale"} == \
        {64, 128}
    assert tr.spans[0].attrs == {"pairs": 1, "regions": 1}
    # the scale's seconds and its span come from the same clock reads
    assert [e["seconds"] for e in info["scales"]] == [
        (s.end_ns - s.start_ns) / 1e9 for s in tr.spans
        if s.name == "scale"]
    # the progress block and the loss curve read back at each scale's end
    assert Counter(s.name for s in tr.spans)["scale.readback"] == 4


def test_a_traced_masked_batch_gives_the_span_tree(params):
    with timing.tracing() as tr:
        _batch(params)
    _check_tree(tr.spans, 2, 2, [(r, p) for p in (0, 1) for r in (0, 1)])
    assert tr.spans[0].attrs == {"pairs": 2, "regions": 2}


def test_the_parts_of_a_step_cover_it(params):
    with timing.tracing() as tr:
        _single(params)
        _batch(params)
    steps = bspans.total_ns(tr.spans, ("step",))
    parts = bspans.total_ns(tr.spans, STEP_PARTS)
    assert 0.95 * steps <= parts <= steps


def test_step_spans_sum_to_the_benchmarks_host_time(params, monkeypatch):
    """The benchmark's clock around the step layer's calls
    (``drive.Recorder.host_s``) holds the step spans and little else."""
    monkeypatch.setattr(solve, "optimization_steps",
                        solve.optimization_steps)
    monkeypatch.setattr(batch, "batch_steps", batch.batch_steps)
    rec = drive.Recorder(3)
    drive.install(rec)
    with timing.tracing() as tr:
        _single(params)
        _batch(params)
    steps = bspans.total_ns(tr.spans, ("step",)) / 1e9
    assert rec.steps == 8 and rec.host_s > 0
    assert 0.9 * rec.host_s <= steps <= rec.host_s


def test_profiler_ops_of_vgg_lie_inside_its_spans(params):
    """On the shared clock the convolutions the profiler records lie in
    ``step.vgg`` (each the same number) or in a scale's set-up, where the
    content and the style go through VGG, and nowhere else."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(taps=("block1_conv1", "block1_conv2"))
    with timing.tracing() as tr, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        _single(params, cfg)
    convs = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::conv2d"]
    per_vgg, setup = [], 0
    for s in tr.spans:
        inside = [c for c in convs
                  if s.start_ns <= c[0] and c[1] <= s.end_ns]
        if s.name == "step.vgg":
            per_vgg.append(len(inside))
        elif s.name == "scale.setup":
            setup += len(inside)
    assert per_vgg == [2] * 4
    assert sum(per_vgg) + setup == len(convs)


def test_tracing_changes_no_result(params):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = _single(params)
        with timing.tracing():
            traced = _single(params)
        plain_b, traced_b = _batch(params), None
        with timing.tracing():
            traced_b = _batch(params)
    finally:
        torch.set_num_threads(threads)
    for (img, info), (img2, info2) in ((plain, traced),
                                       (plain_b, traced_b)):
        assert torch.equal(img, img2)
        for a, b in zip(info["scales"], info2["scales"]):
            assert np.array_equal(a["curve"], b["curve"])


class _Span:
    def __init__(self, name, start, end, parent):
        self.name, self.start_ns, self.end_ns = name, start, end
        self.parent = parent


def test_the_readers_attribute_launches_kernels_and_gaps_by_time():
    spans = [_Span("call", 0, 100, -1), _Span("step", 10, 60, 0),
             _Span("step.vgg", 12, 30, 1), _Span("step.backward", 30, 58, 1),
             _Span("step", 62, 95, 0), _Span("step.vgg", 63, 70, 4)]
    calls = [(13, 1, "cudaLaunchKernel"), (29, 2, "cuLaunchKernelEx"),
             (40, 3, "cudaLaunchKernelExC"), (59, 4, "cudaLaunchKernel"),
             (64, 5, "cudaGraphLaunch"), (97, 6, "cudaLaunchKernel"),
             (105, 7, "cudaMemsetAsync")]
    kernels = [(20, 25, "a", 1), (40, 44, "b", 3), (70, 71, "c", 5),
               (98, 99, "d", 6), (106, 109, "e", 7)]
    gaps = [(25, 40), (44, 70), (90, 98)]
    rows = bspans.by_span(spans, spans, calls, kernels, gaps)
    assert rows["step.vgg"]["launches"] == 3 / 2
    assert rows["step.backward"]["launches"] == 1 / 2
    assert rows["step"]["launches"] == 1 / 2  # 59: after backward's end
    assert rows["call"]["launches"] == 1 / 2
    assert rows[bspans.OUTSIDE]["launches"] == 0  # a fill, no launch
    assert rows["step.vgg"]["device_ms"] == (5 + 1) / 1e6 / 2
    assert rows["step.backward"]["device_ms"] == 4 / 1e6 / 2
    assert rows["call"]["device_ms"] == 1 / 1e6 / 2
    assert rows[bspans.OUTSIDE]["device_ms"] == 3 / 1e6 / 2
    # gaps by their middle: 32.5 backward, 57 backward, 94 step
    assert rows["step.backward"]["idle_ms"] == (15 + 26) / 1e6 / 2
    assert rows["step"]["idle_ms"] == 8 / 1e6 / 2
    # self time: the step's own less its parts
    assert rows["step"]["host_self_ms"] == (50 - 18 - 28 + 33 - 7) / 1e6 / 2
    ctx = {"spans": spans, "profile_spans": spans, "launch_calls": calls}
    assert bspans.step_launches(ctx) == 5 / 2
    assert bspans.step_launches(dict(ctx, launch_calls=[])) is None
    assert bspans.host_ms(ctx, ("step.vgg",), "step") == 25 / 1e6 / 2
    assert bspans.host_ms({}, ("step.vgg",), "step") is None


def test_the_span_tool_reads_the_metrics_of_a_cell_on_the_cpu():
    import tiny

    spec = importlib.util.spec_from_file_location(
        "spans_tool", os.path.join(BENCH, "tools", "spans.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    c = tiny.cell(max_iter=2)
    threads = torch.get_num_threads()
    try:
        res = tool.main(["--workload", c.name, "--seed", str(2 ** 40 + 9),
                         "--rounds", "1"], device="cpu", cell=c)
    finally:
        torch.set_num_threads(threads)
    m = res["metrics"]
    assert m["step_launches"] is None  # no launch call on the CPU
    for name in tool.METRICS[:5]:
        assert m[name] > 0, name
    assert 0.9 <= res["step_over_host"] <= 1.0
    assert res["parts_over_step"] >= 0.95
    assert res["span_off_ns"] < res["span_on_ns"]
    assert {"step", "step.vgg", "scale.setup"} <= set(res["by_span"])
