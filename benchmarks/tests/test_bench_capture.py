"""The states the check reads, taken at the step layer's call boundaries
(:class:`harness.drive.Recorder` splits each call at a scale's steps 1 and
``follow``), are bit for bit the states the optimizer's own updates show:
the capture that wrapped ``opt.step`` is kept here as the yardstick."""

import inspect

import pytest
import torch

import tiny
from harness import drive, inputs

FOLLOW = 3


class StepCounted(drive.Recorder):
    """The capture that counts the optimizer's own ``step`` calls and
    copies the RMSprop slots after the first and the pyramid after the
    ``follow``-th, inside the step layer's call."""

    def _counted(self, n_steps, pyramid, opt):
        last = self.scales[-1] if self.scales else None
        if last is not None and last["opt"] is opt:
            cap = last
        else:
            cap = {"start": [p.detach().clone() for p in pyramid],
                   "lr": opt.lr, "steps": 0, "updates": 0, "opt": opt,
                   "rows": []}
            self.scales.append(cap)
        cap["steps"] += n_steps
        step = opt.step

        def counted(*a, **k):
            out = step(*a, **k)
            cap["updates"] += 1
            if cap["updates"] == 1:
                cap["nu1"] = [v.clone() for v in opt.nu]
            if cap["updates"] == self.follow:
                cap["after"] = [p.detach().clone() for p in pyramid]
            return out

        opt.step = counted
        return cap

    def wrap(self, fn):
        rec = self
        sig = inspect.signature(fn)

        def steps(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            pyramid, opt = a["pyramid"], a["opt"]
            cap = (rec._counted(int(a["n_steps"]), pyramid, opt)
                   if rec.scales is not None else None)
            try:
                rows = fn(*args, **kw)
            finally:
                if cap is not None:
                    del opt.step
            if cap is not None:
                assert cap["updates"] == cap["steps"]
                cap["rows"].append(rows)
                cap["final"] = [p.detach() for p in pyramid]
            return rows

        return steps


def _call(c, recorder, seed=2 ** 35 + 3):
    from strotss_torch import StrotssConfig

    seeds = inputs.streams(seed, 3)
    device = torch.device("cpu")
    weights = inputs.vgg_weights(seeds[0], device)
    traffic = inputs.Traffic(c.traffic, seeds[1], device)
    drive.install(recorder)
    program = drive.Program(StrotssConfig(**c.config["strotss"]), weights,
                            device, recorder)
    return program.call(traffic.job())


@pytest.mark.parametrize("pairs,regions,log_every", [
    (1, 0, 2), (1, 2, 200), (3, 0, 200)],
    ids=["single_in_chunks", "regions", "batch"])
def test_the_split_capture_equals_the_step_counted_one(pairs, regions,
                                                       log_every,
                                                       monkeypatch):
    from strotss_torch import solve
    from strotss_torch.parallel import batch

    monkeypatch.setattr(solve, "optimization_steps",
                        solve.optimization_steps)
    monkeypatch.setattr(batch, "batch_steps", batch.batch_steps)
    c = tiny.cell(pairs=pairs, regions=regions, max_iter=5)
    c.config["strotss"]["log_every"] = log_every
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        split_rec = drive.Recorder(FOLLOW)
        out, split = _call(c, split_rec)
        want_out, want = _call(c, StepCounted(FOLLOW))
    finally:
        torch.set_num_threads(threads)
    assert split_rec.steps == 5 * c.config["strotss"]["levels"]
    assert torch.equal(out, want_out)
    assert len(split) == len(want) == c.config["strotss"]["levels"]
    for got, ref in zip(split, want):
        assert got["steps"] == ref["steps"] == 5
        for key in ("start", "nu1", "after", "final"):
            assert all(torch.equal(g, r) for g, r in zip(got[key], ref[key]))
        assert torch.equal(torch.cat(got["rows"]), torch.cat(ref["rows"]))


@pytest.mark.parametrize("done,n,cuts", [
    (0, 10, [1, 2, 7]), (0, 1, [1]), (0, 2, [1, 1]), (0, 3, [1, 2]),
    (1, 5, [2, 3]), (2, 2, [1, 1]), (3, 7, [7]), (4, 2, [2])])
def test_a_call_splits_where_steps_1_and_follow_end(done, n, cuts):
    assert drive.Recorder(FOLLOW).cuts(done, n) == cuts


def test_a_scale_without_its_states_raises():
    cap = {"steps": 4, "final": [], "rows": [], "nu1": []}
    with pytest.raises(drive.CaptureError):
        drive.checked([cap], 1, FOLLOW)
    short = {"steps": 2, "final": ["end"], "rows": [], "nu1": []}
    assert drive.checked([short], 1, FOLLOW)[0]["after"] == ["end"]


class _Opt:
    def __init__(self, pyramid):
        self.lr, self.nu = 1.0, [torch.zeros_like(p) for p in pyramid]


def _fake_steps(n_steps, pyramid, opt, coords_fn, seen):
    """A step layer whose state counts its steps: each step draws its
    coordinates and adds 1 to every leaf and slot in place."""
    for t in range(n_steps):
        seen.append(coords_fn(t))
        for p, v in zip(pyramid, opt.nu):
            p.add_(1.0)
            v.add_(1.0)
    return torch.arange(n_steps, dtype=torch.float32)


def _fake_batch_steps(n_steps, pyramid, opt, coords_fn, seen):
    for t in range(n_steps):
        seen.append(coords_fn(1, t))
        for p, v in zip(pyramid, opt.nu):
            p.add_(1.0)
            v.add_(1.0)
    return torch.arange(n_steps, dtype=torch.float32)


@pytest.mark.parametrize("fake,coords", [
    (_fake_steps, lambda t: t), (_fake_batch_steps, lambda b, t: (b, t))],
    ids=["optimization_steps", "batch_steps"])
def test_the_split_calls_offset_the_coordinates_and_read_each_state(
        fake, coords):
    """Chunks of 4, 4 and 2 steps of one scale: the coordinates of global
    steps 0-9 in order, the slots after step 1, the pyramid after step 3,
    the rows in order."""
    rec = drive.Recorder(FOLLOW)
    rec.begin()
    wrapped = rec.wrap(fake)
    pyramid = [torch.zeros(2), torch.zeros(3)]
    opt, seen = _Opt(pyramid), []
    done = 0
    for k in (4, 4, 2):
        wrapped(k, pyramid, opt, lambda *a, d=done: coords(
            *a[:-1], a[-1] + d), seen)
        done += k
    (cap,) = drive.checked(rec.end(), 1, FOLLOW)
    assert seen == [coords(*((1,) if fake is _fake_batch_steps else ()), t)
                    for t in range(10)]
    assert cap["steps"] == rec.steps == 10
    assert all(torch.equal(v, torch.ones_like(v)) for v in cap["nu1"])
    assert all(torch.equal(p, torch.full_like(p, 3.0))
               for p in cap["after"])
    assert all(torch.equal(p, torch.zeros_like(p)) for p in cap["start"])
    # the first chunk as calls of 1, 2 and 1 steps, then 4, then 2
    assert torch.cat(cap["rows"]).tolist() == [0, 0, 1, 0, 0, 1, 2, 3, 0,
                                               1]


def test_watched_step_calls_read_their_memory(monkeypatch):
    """While watched, each step call's peak above its start is read
    outside the timed interval, and the peaks the readings reset are
    kept for the run's."""
    mem = {"now": 100, "peak": 900}

    def alloc(n):
        mem["now"] += n
        mem["peak"] = max(mem["peak"], mem["now"])
        mem["now"] -= n

    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda *a: mem["now"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a: mem["peak"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: mem.update(peak=mem["now"]))

    def steps(n_steps, pyramid, opt, coords_fn, seen):
        alloc(10 * n_steps)
        return _fake_steps(n_steps, pyramid, opt, coords_fn, seen)

    rec = drive.Recorder(FOLLOW)
    pyramid = [torch.zeros(2)]
    for watch in (False, True):
        rec.watch_memory(watch)
        rec.begin()
        rec.wrap(steps)(10, pyramid, _Opt(pyramid), lambda t: t, [])
        rec.end()
    # calls of 1, 2 and 7 steps: the last allocated 70 above its start
    assert rec.transient == 70
    assert rec.peak_seen == 900
