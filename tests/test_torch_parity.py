"""``tools/parity_torch.py``'s plumbing on both sides at a tiny size, and
its verdict rules."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import parity_torch as P  # noqa: E402

TINY = ["--steps", "3", "--tail", "2", "--sample_size", "64", "--taps",
        "block1_conv1", "--seeds", "0,1"]

_TORCH_SIDE = """
import json, sys
sys.path.insert(0, {tools!r})
import parity_torch
parity_torch.main({argv!r})
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',
                                                      'strotss_tpu')]
print(json.dumps(bad))
"""


@pytest.fixture(scope="module")
def band(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parity") / "band.json")
    assert P.main(["--side", "jax", "--jobs", "4", "--out", out] + TINY) == 0
    with open(out) as f:
        return out, json.load(f)


def test_jax_side_writes_the_band(band):
    _, b = band
    assert b["seeds"] == [0, 1] and b["metrics"] == list(P.METRICS)
    assert set(b["protocols"]) == {"default", "masked"}
    assert b["protocols"]["masked"] == dict(P.COMMON, steps=3, tail=2,
                                            sample_size=64,
                                            taps=["block1_conv1"])
    assert set(b["cells"]) == {f"{p}/{d}" for p in P.PROTOCOLS
                               for d in P.DTYPES}
    for cell in b["cells"].values():
        assert cell["platform"] == "cpu" and cell["seconds"] > 0
        for m in P.METRICS:
            assert len(cell[m]) == 2 and np.all(np.isfinite(cell[m]))


def test_torch_side_reports_against_the_band(band, tmp_path):
    """The torch side imports neither JAX nor the JAX package, runs the
    same protocols and writes both sides' tail-means, the deviations and
    a verdict per protocol, dtype and metric."""
    path, b = band
    out = str(tmp_path / "report.json")
    argv = ["--side", "torch", "--device", "cpu", "--band", path, "--out",
            out] + TINY
    run = subprocess.run(
        [sys.executable, "-c", _TORCH_SIDE.format(
            tools=os.path.join(REPO, "tools"), argv=argv)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    with open(out) as f:
        r = json.load(f)
    assert r["device"] == "cpu" and r["rule"] == P.RULE
    assert r["protocols"] == b["protocols"]
    assert set(r["cells"]) == set(b["cells"])
    for name, cell in r["cells"].items():
        assert cell["launches"] == {k: 0 for k in cell["launches"]}
        for m in P.METRICS:
            v = cell[m]
            assert v["jax"] == b["cells"][name][m] and len(v["torch"]) == 2
            assert v == P.verdict(v["jax"], v["torch"])
    assert r["all_pass"] == all(c[m]["pass"] for c in r["cells"].values()
                                for m in P.METRICS)


def test_jax_side_extends_the_band(band, tmp_path):
    """``--extend`` runs only the seeds the band lacks and keeps the
    others' tail-means."""
    _, b = band
    out = str(tmp_path / "band.json")
    one = TINY[:-1] + ["0"]
    argv = ["--side", "jax", "--protocols", "default", "--dtypes",
            "float32", "--out", out]
    assert P.main(argv + one) == 0
    assert P.main(argv + TINY[:-1] + ["0-1", "--extend"]) == 0
    with open(out) as f:
        ext = json.load(f)
    assert ext["seeds"] == [0, 1]
    for m in P.METRICS:
        assert ext["cells"]["default/float32"][m] == \
            b["cells"]["default/float32"][m]


def test_torch_side_extends_and_rejudges(band, tmp_path):
    """The torch side's ``--extend`` keeps the report's seeds, adds the
    missing ones, and with none missing judges the report anew."""
    path, b = band
    out = str(tmp_path / "report.json")
    argv = ["--side", "torch", "--device", "cpu", "--band", path, "--out",
            out, "--protocols", "default", "--dtypes", "float32"]
    P.main(argv + TINY[:-1] + ["1"])
    with open(out) as f:
        first = json.load(f)["cells"]["default/float32"]
    P.main(argv + TINY[:-1] + ["0,1", "--extend"])
    with open(out) as f:
        ext = json.load(f)
    cell = ext["cells"]["default/float32"]
    assert ext["seeds"] == [1, 0]
    for m in P.METRICS:
        assert cell[m]["torch"][0] == first[m]["torch"][0]
        assert len(cell[m]["torch"]) == 2
        assert cell[m] == P.verdict(b["cells"]["default/float32"][m],
                                    cell[m]["torch"])
    P.main(argv + TINY[:-1] + ["0,1", "--extend"])
    with open(out) as f:
        again = json.load(f)
    assert again["cells"] == ext["cells"]


def test_torch_side_refuses_a_band_of_another_protocol(band, tmp_path):
    path, _ = band
    with pytest.raises(ValueError, match="protocol"):
        P.main(["--side", "torch", "--device", "cpu", "--band", path,
                "--out", str(tmp_path / "r.json"), "--protocols", "default",
                "--dtypes", "float32", "--steps", "4", "--tail", "2",
                "--sample_size", "64", "--taps", "block1_conv1",
                "--seeds", "0"])


@pytest.mark.parametrize("shift,passes", [(0.0, True), (0.009, True),
                                          (0.011, False), (-0.011, False)])
def test_verdict_one_percent_term(shift, passes):
    """Tight spreads: the 1% of |mean_jax| term decides."""
    j = [1.0, 1.0001, 0.9999, 1.0, 1.0]
    t = [v + shift for v in j]
    v = P.verdict(j, t)
    assert v["pass"] is passes
    assert v["limit"] == pytest.approx(0.01)


@pytest.mark.parametrize("shift,passes", [(0.25, True), (0.31, False)])
def test_verdict_two_sample_term(shift, passes):
    """Wide spreads: 3 * s_j * sqrt(1/5 + 1/5) decides."""
    j = np.array([9.8, 10.2, 10.0, 9.9, 10.1])
    t = j[::-1] + shift
    v = P.verdict(j, t)
    s = float(np.std(j, ddof=1))
    assert v["limit"] == pytest.approx(3 * math.sqrt(2 * s * s / 5))
    assert v["pass"] is passes
    assert v["rel_dev"] == pytest.approx(list((t - 10.0) / 10.0))


def test_single_draw_rule():
    """Four of JAX's standard deviations of a single draw about the mean
    of its n seeds, s * sqrt(1 + 1/n), with no floor in percent."""
    for vals in ([1.0, 1.002, 0.998, 1.001, 0.999],
                 [0.9, 1.1, 1.0, 0.95, 1.05]):
        cell = {"loss": vals}
        sd = float(np.std(vals, ddof=1)) * math.sqrt(1.2)
        assert P.single_draw(cell, "loss", 1.0 + 3.9 * sd)["pass"]
        assert P.single_draw(cell, "loss", 1.0 - 3.9 * sd)["pass"]
        assert not P.single_draw(cell, "loss", 1.0 + 4.1 * sd)["pass"]
        assert P.single_draw(cell, "loss", 1.0)["limit"] == pytest.approx(
            4 * sd)


def test_verdict_limit_ignores_the_ports_spread():
    """A port whose seeds scatter more does not widen its own bound: the
    limit is JAX's, and the spread is reported beside it."""
    j = np.array([9.8, 10.2, 10.0, 9.9, 10.1])
    tight = P.verdict(j, j[::-1] + 0.31)
    wide = P.verdict(j, (j[::-1] - 10.0) * 6.0 + 10.31)
    assert wide["limit"] == tight["limit"]
    assert wide["pass"] is tight["pass"] is False
    assert wide["spread_ratio"] == pytest.approx(6.0)
    assert tight["spread_ratio"] == pytest.approx(1.0)
    assert wide["spread_p"] < 0.01 < tight["spread_p"]


def test_protocol_inputs_are_the_jax_tools():
    """The images and masks of tools/parity_tf.py and parity_masked.py."""
    import parity_masked
    import parity_tf

    c, s, cm, sm = P.inputs("masked")
    np.testing.assert_array_equal(c[0], parity_tf.synth(96, 80, 1))
    np.testing.assert_array_equal(s[0], parity_tf.synth(88, 104, 2))
    np.testing.assert_array_equal(cm, parity_masked.masks(96, 80))
    assert sm.shape == (2, 88, 104, 1)
    assert sm[0, :, :52].min() == 1 and sm[0, :, 52:].max() == 0
    assert sm[1].sum() == 88 * 52
    assert P.inputs("default")[2] is None


def test_replay_runs_both_packages_on_the_jax_coordinates(tmp_path):
    """``tools/parity_replay.py`` at a tiny size: the port on the JAX
    package's coordinates tracks it step by step (the 1-tap, 64-sample
    width where the trajectories agree to 1e-4, as in
    ``tests/test_torch_step.py``), and the report carries both pairs."""
    import parity_replay as R

    out = str(tmp_path / "replay.json")
    assert R.main(["--seeds", "0", "--out", out] + TINY[:-2]) == 0
    with open(out) as f:
        r = json.load(f)
    assert set(r["cells"]) == {"default", "masked"}
    for cell in r["cells"].values():
        (row,) = cell["seeds"]
        assert set(row["tails"]) == {"jax", "torch", "control"}
        for pair in ("jax_vs_torch", "torch_vs_control"):
            got = row[pair]
            assert len(got["rel_diff_first_10"]) == 3
            assert max(got["rel_diff_first_10"]) < 1e-4
            assert got["first_step_over_1e-3"] is None
            assert set(cell[pair]) == set(P.METRICS)


def test_cpu_drawn_coordinates_are_the_cpu_runs():
    """``--coords cpu`` samples what the port's CPU run of the same seed
    samples: on the CPU both give the same tail-means (one thread, so the
    sums run in one order)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        over = dict(steps=3, tail=2, sample_size=64, taps=["block1_conv1"])
        for protocol in P.PROTOCOLS:
            own = P.torch_cell(protocol, "float32", [1], "cpu", **over)
            cpu = P.torch_cell(protocol, "float32", [1], "cpu", "cpu",
                               **over)
            for m in P.METRICS:
                assert own[m] == cpu[m]
    finally:
        torch.set_num_threads(threads)
