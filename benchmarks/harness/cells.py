"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Its files, each found by name and never listed in code:

- ``benchmarks/configs/<config>.json``: the ``StrotssConfig`` fields under
  ``strotss``, the source, what was reduced and what was assumed, and the
  overrides of the set-up's warm-up run under ``warmup``;
- ``benchmarks/traffic/<traffic>.json``: the parameters the one generator
  (:mod:`harness.inputs`) reads: image sizes, pairs a call, regions, the
  per-pair alphas, how many finished stylizations the check compares and
  how many the traced run times;
- ``benchmarks/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``benchmarks/metrics/<metric>.py``: the reader of each per-layer metric
  (:mod:`harness.layers`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, cell_e2e: List[str]) -> bool:
    """A metric is reported in a cell that its ``workloads`` list (all
    cells that report the end-to-end metric it moves, without one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in cell_e2e


def resolve(workload: str, root: str = REPO) -> Cell:
    """The cell named ``workload`` in ``root``'s ``BENCHMARK.json``, with
    its configuration, traffic, limits and metrics."""
    spec = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    bench = os.path.join(root, "benchmarks")
    traffic = _load(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    limits = _load(os.path.join(bench, "limits", workload + ".json"))
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), w["config"], config,
                w["traffic"], traffic, limits, e2e, per_layer)
