"""The harness finds cells, configurations, traffic and metrics by the
names in BENCHMARK.json: a new one is files and entries, no edit."""

import json
import os
import shutil

import tiny
from harness.cells import resolve
from harness.layers import read_all


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(tiny.BENCH), "BENCHMARK.json"),
                root / "BENCHMARK.json")
    return root


def test_every_cell_resolves():
    spec = json.load(open(os.path.join(os.path.dirname(tiny.BENCH),
                                       "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = resolve(w["name"])
        assert cell.config_name == w["config"]
        assert set(cell.limits) >= {"loss_gap", "image_gap"}
        # set-up and one more end-to-end metric; each per-layer metric
        # moves one that the cell reports
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m.get("moves") in e2e for m in cell.per_layer)


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    b = root / "benchmarks"
    (b / "traffic" / "tall.json").write_text(json.dumps(
        {"content_hw": [512, 256], "style_hw": [640, 480], "pairs": 1}))
    cfg = json.loads((b / "configs" / "strotss512.json").read_text())
    cfg["strotss"]["levels"] = 3
    (b / "configs" / "strotss256.json").write_text(json.dumps(cfg))
    (b / "limits" / "strotss256.tall.json").write_text(json.dumps(
        {"loss_gap": {"limit": 1}}))
    (b / "metrics" / "steps_per_call.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "strotss256", "source": "x",
                            "file": "benchmarks/configs/strotss256.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "strotss256.tall",
                              "config": "strotss256", "traffic": "tall",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "steps_per_call", "unit": "1",
                              "better": "lower", "source": "program_span",
                              "layer": "Step", "moves": "image_s",
                              "workloads": ["strotss256.tall"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = resolve("strotss256.tall", root=str(root))
    assert cell.config["strotss"]["levels"] == 3
    assert cell.traffic["content_hw"] == [512, 256]
    assert [m["name"] for m in cell.per_layer] == ["steps_per_call"]
    # the metric's reader comes from the checkout's metrics folder
    import harness.layers as L

    saved = L.BENCH
    L.BENCH = str(b)
    try:
        got = read_all(cell.per_layer, {"steps": 40})
    finally:
        L.BENCH = saved
    assert got == {"steps_per_call": {"value": 40.0, "unit": "1"}}


def test_an_unknown_workload_is_refused():
    import pytest

    with pytest.raises(KeyError):
        resolve("strotss512.nothing")
