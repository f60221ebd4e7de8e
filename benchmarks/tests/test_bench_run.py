"""A whole run of a cell cut to CPU size: the result line's keys, the
refusal without a card, and ``correct`` coming out false when the timed
path is broken underneath (each fault a cell can have)."""

import contextlib
import io

import pytest
import torch

import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def test_the_result_line_has_the_contracts_keys():
    rc, line, err = tiny.drive(tiny.cell())
    assert rc == 0, err
    assert list(line) == KEYS
    assert line["correct"] is True, line["compared"]
    assert set(line["metrics"]) == {"image_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    # the numbers compared are stderr's last lines, each with its limit
    tail = err.strip().splitlines()[-len(line["compared"]) - 1:-1]
    assert [t.split()[0] for t in tail] == list(line["compared"])
    assert all(" limit " in t for t in tail)


def test_a_traced_run_reports_per_layer_metrics():
    rc, line, err = tiny.drive(tiny.cell(), trace=1)
    assert rc == 0, err
    assert list(line) == KEYS[:5] + ["breakdown", "compared"]
    # the program's spans feed the scale driver's metrics; on the CPU the
    # profile holds no launch call and no kernel, so their metrics are
    # left out
    assert {"step_host_ms", "scale_setup_ms", "readback_wait_ms"} <= \
        set(line["metrics"])
    assert line["metrics"]["scale_setup_ms"]["value"] > 0
    assert line["metrics"]["readback_wait_ms"]["value"] > 0
    assert not {"step_launches", "gather_roofline_pct"} & \
        set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "by span, per step of the entry" in err
    assert line["correct"] is True, line["compared"]


def test_the_masked_cell_reports_memory_in_place_of_image_s():
    """Where the host's pace spreads ``image_s`` too widely for a bound,
    the cell reports its memory end to end and the seconds per layer."""
    c = tiny.cell(regions=2, workload="strotss512.masked2")
    rc, line, err = tiny.drive(c, seconds=6.0)
    assert rc == 0, err
    assert set(line["metrics"]) == {"setup_s", "memory_peak_gib"}
    assert line["correct"] is True, line["compared"]
    rc, line, err = tiny.drive(c, trace=1)
    assert rc == 0, err
    # the step's memory is a card's reading: none on the CPU
    assert set(line["metrics"]) == {"entry_image_s"}
    assert line["metrics"]["entry_image_s"]["value"] > 0
    assert line["correct"] is True, line["compared"]


def test_without_a_card_a_run_fails_and_prints_no_result(monkeypatch):
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "strotss512.single", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_masked_and_batched_cells_run_correct():
    for c in (tiny.cell(regions=2), tiny.cell(pairs=3)):
        rc, line, err = tiny.drive(c, seconds=12.0)
        assert rc == 0, err
        assert line["correct"] is True, line["compared"]


def _frozen_step(self, grads):
    """A step that returns its state unchanged."""


def _half_batch(orig):
    """The batched step on the first half of the pairs, their mean."""
    def steps(spec, n_steps, vgg, feats, pairs, pyramid, opt, coords_fn,
              *a):
        from strotss_torch import programs

        half = len(pairs) // 2

        def only(t):
            return t * (torch.arange(t.shape[0]) < half).view(
                -1, *[1] * (t.ndim - 1)).to(t.dtype)

        class Opt:
            lr, nu = opt.lr, opt.nu

            def step(self, grads):
                opt.step([only(g) * len(pairs) / half for g in grads])

        return programs.batch_steps(spec, n_steps, vgg, feats, pairs,
                                    pyramid, Opt(), coords_fn, *a)
    return steps


def _altered_image(orig):
    """The entry's image with one pixel moved by one level."""
    def stylize(*a, **k):
        out, info = orig(*a, **k)
        out = out.clone()
        out.view(-1)[7] += 1
        return out, info
    return stylize


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_image"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import strotss_torch
    from strotss_torch import programs
    from strotss_torch.parallel import batch

    c = tiny.cell(pairs=4 if fault == "half_batch" else 1)
    if fault == "unchanged_state":
        monkeypatch.setattr(programs.RMSprop, "step", _frozen_step)
    elif fault == "half_batch":
        monkeypatch.setattr(programs, "batch_steps",
                            programs.batch_steps)
        import harness.drive as drive

        orig = drive.install

        def install(rec):
            orig(rec)
            batch.batch_steps = rec.wrap(_half_batch(None))
        monkeypatch.setattr(drive, "install", install)
    else:
        monkeypatch.setattr(strotss_torch, "stylize",
                            _altered_image(strotss_torch.stylize))
    rc, line, err = tiny.drive(c, seconds=12.0)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]


def _unseen_updates(orig, frozen=False):
    """The step with its optimizer updates made where the benchmark does
    not see them, as a step replayed as one graph would; ``frozen``: with
    those updates left out."""
    def steps(spec, n_steps, vgg, feats, targets, moments, alpha, pyramid,
              opt, coords_fn, *a):
        class Opt:
            lr, nu = opt.lr, opt.nu

            def step(self, grads):
                if not frozen:
                    type(opt).step(opt, grads)

        return orig(spec, n_steps, vgg, feats, targets, moments, alpha,
                    pyramid, Opt(), coords_fn, *a)
    return steps


@pytest.mark.parametrize("frozen", [False, True])
def test_a_step_whose_updates_cannot_be_seen_is_judged(frozen, monkeypatch):
    """The states are read at the step layer's call boundaries: a step
    whose updates Python cannot see is checked, correct when it updates
    and not correct when its hidden update is left out."""
    import harness.drive as drive
    from strotss_torch import programs, solve

    monkeypatch.setattr(solve, "optimization_steps",
                        solve.optimization_steps)
    orig = drive.install

    def install(rec):
        orig(rec)
        solve.optimization_steps = rec.wrap(
            _unseen_updates(programs.optimization_steps, frozen))
    monkeypatch.setattr(drive, "install", install)
    rc, line, err = tiny.drive(tiny.cell(max_iter=5), seconds=12.0)
    assert rc == 0, err
    assert line["correct"] is (not frozen), line["compared"]
