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
    assert "step_host_ms" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
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


def _unseen_updates(orig):
    """The step with its optimizer updates made where the benchmark does
    not see them, as a step replayed as one graph would."""
    def steps(spec, n_steps, vgg, feats, targets, moments, alpha, pyramid,
              opt, coords_fn, *a):
        class Opt:
            lr, nu = opt.lr, opt.nu

            def step(self, grads):
                type(opt).step(opt, grads)

        return orig(spec, n_steps, vgg, feats, targets, moments, alpha,
                    pyramid, Opt(), coords_fn, *a)
    return steps


def test_a_step_whose_updates_cannot_be_seen_fails_the_run(monkeypatch):
    import harness.drive as drive
    from strotss_torch import programs, solve

    orig = drive.install

    def install(rec):
        orig(rec)
        solve.optimization_steps = rec.wrap(
            _unseen_updates(programs.optimization_steps))
    monkeypatch.setattr(drive, "install", install)
    with pytest.raises(drive.CaptureError):
        tiny.drive(tiny.cell())
