"""Whole-run loss parity of the PyTorch port against the JAX package.

Two protocols, both those of the JAX package's own parity tools:

- ``default`` (``tools/parity_tf.py``): content ``synth(96, 80, 1)``, style
  ``synth(88, 104, 2)``, one 64 px scale (``levels=1``, ``max_size=64``),
  lr 2e-3, 1024 samples, the default alpha (16), 600 steps, the mean of
  the last 300;
- ``masked`` (``tools/parity_masked.py``): the same images with two
  regions, content top/bottom paired with style left/right, 240 steps, the
  mean of the last 120.

Each runs seeds 0-19 in float32 and bfloat16. Both sides take the port's
seeded numpy VGG16 init (``strotss_torch.models.weights.random_params``);
the JAX side gets it in its own layout as ``vgg_params``. The two sides
draw their samples from different generators, so a single run is a draw,
not a measurement: the comparison is between the per-seed tail-means of
the two sides (``docs/PARITY.md``).

``--side jax`` (needs JAX; run it on the CPU) writes the JAX package's
tail-means to ``tools/parity_jax_band.json``, one process per protocol and
dtype so that each compiles once. ``--side torch --device {cpu,cuda}``
imports neither JAX nor the JAX package; it runs the port through
``strotss_torch.stylize`` (the CUDA kernels engaged on a card) and writes
``tools/parity_torch_<device>.json`` with both sides' tail-means, each
seed's relative deviation from JAX's mean, and a verdict per protocol,
dtype and metric (:data:`RULE`).

Usage::

    JAX_PLATFORMS=cpu python tools/parity_torch.py --side jax
    python tools/parity_torch.py --side torch --device cuda
    python tools/parity_torch.py --side torch --device cpu --dtypes float32

``--extend`` keeps what the output file already holds and runs only the
seeds it lacks (``--seeds 0-39 --extend`` adds seeds 20-39); on the torch
side with no seed lacking it judges the report anew against the band.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BAND = os.path.join(HERE, "parity_jax_band.json")
PROTOCOLS = {
    "default": {"steps": 600, "tail": 300},
    "masked": {"steps": 240, "tail": 120},
}
COMMON = {"scale": 64, "sample_size": 1024, "lr": 2e-3, "alpha": 1.0,
          "taps": None}
DTYPES = ("float32", "bfloat16")
SEEDS = tuple(range(20))
METRICS = ("loss", "loss_c", "loss_s")
RULE = ("pass when |mean_torch - mean_jax| <= max(3 * s_jax * sqrt(1 / "
        "n_jax + 1 / n_torch), 0.01 * |mean_jax|), s_jax the sample standard "
        "deviation (ddof 1) of the JAX package's per-seed tail-means, n the "
        "seeds a side; the first term is a two-sample bound under the "
        "hypothesis that the port replicates the JAX package, so that both "
        "sides share JAX's spread and the port's own spread cannot widen its "
        "bound; the second is the JAX package's own 1% criterion. The port's "
        "spread is reported beside it: spread_ratio s_torch / s_jax and "
        "spread_p, the two-sided F-test p-value of equal variances")
SINGLE_RULE = ("one draw passes when |tail_mean - mean_jax| <= 4 * s_jax * "
               "sqrt(1 + 1 / n_jax)")


def synth(h, w, seed):
    """``tools/parity_tf.py``'s synthesized image: 32 px and 8 px random
    blocks summed, scaled to a maximum of 1; (h, w, 3) float32."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for cell in (32, 8):
        base = rng.random((h // cell + 2, w // cell + 2, 3)).astype(np.float32)
        img += np.kron(base, np.ones((cell, cell, 1), np.float32))[:h, :w]
    return img / img.max()


def inputs(protocol):
    """(content, style, content_masks, style_masks) of a protocol: images
    (1, H, W, 3), masks (2, H, W, 1) float32 or None."""
    content, style = synth(96, 80, 1)[None], synth(88, 104, 2)[None]
    if protocol == "default":
        return content, style, None, None
    cm = np.zeros((2, 96, 80, 1), np.float32)
    cm[0, :48] = 1.0
    cm[1, 48:] = 1.0
    sm = np.zeros((2, 88, 104, 1), np.float32)
    sm[0, :, :52] = 1.0
    sm[1, :, 52:] = 1.0
    return content, style, cm, sm


def settings(protocol, **over):
    """The protocol's settings, with ``over``'s non-None entries on top
    (the tests shrink steps, samples and taps)."""
    out = dict(COMMON, **PROTOCOLS[protocol])
    out.update({k: v for k, v in over.items() if v is not None})
    return out


def tail_means(curve, tail):
    """{metric: mean of the last ``tail`` steps} of an (n, 3) curve."""
    curve = np.asarray(curve, np.float64)
    return {m: float(curve[-tail:, i].mean()) for i, m in enumerate(METRICS)}


def _config_kw(st, dtype, seed):
    return dict(levels=1, max_iter=st["steps"], log_every=st["steps"],
                lr=st["lr"], alpha=st["alpha"], sample_size=st["sample_size"],
                compute_dtype=dtype, max_size=st["scale"], seed=seed,
                taps=tuple(st["taps"]) if st["taps"] else None)


def torch_params():
    from strotss_torch.models.weights import random_params

    return random_params("16", 0)


def jax_cell(protocol, dtype, seeds, **over):
    """The JAX package's per-seed tail-means of one protocol and dtype, in
    this process (one compile, the seeds reuse it)."""
    import jax
    import jax.numpy as jnp

    from strotss_tpu.config import StrotssConfig
    from strotss_tpu.solve import stylize_single

    st = settings(protocol, **over)
    params = {name: {"kernel": jnp.asarray(p["kernel"].permute(2, 3, 1, 0)
                                           .numpy()),
                     "bias": jnp.asarray(p["bias"].numpy())}
              for name, p in torch_params().items()}
    content, style, cm, sm = inputs(protocol)
    masks = {} if cm is None else {"content_masks": jnp.asarray(cm),
                                   "style_masks": jnp.asarray(sm)}
    out = {m: [] for m in METRICS}
    t0 = time.perf_counter()
    for seed in seeds:
        cfg = StrotssConfig(use_pallas=False, precompile=False,
                            **_config_kw(st, dtype, seed))
        _, info = stylize_single(jnp.asarray(content), jnp.asarray(style),
                                 cfg, params, **masks)
        for m, v in tail_means(info["scales"][0]["curve"],
                               st["tail"]).items():
            out[m].append(v)
    out["seconds"] = time.perf_counter() - t0
    out["platform"] = jax.devices()[0].platform
    return out


#: the kernels whose launches a cell reports (their wrappers' counters)
KERNELS = ("remd_mins", "selfsim_fwd", "selfsim_bwd", "block1_fwd",
           "block1_bwd", "sinkhorn_lse")


def _launches():
    from strotss_torch.utils import timing

    now = timing.counters()
    return {k: now.get("launch." + k, 0) for k in KERNELS}


def cpu_draws(seed, cm, sm, device):
    """A ``CoordsSource`` drawing on the CPU generators of ``seed``'s
    scales (``solve.scale_generators``): the coordinates of the port's CPU
    run of that seed, moved to ``device``, so that a run on a card samples
    what the CPU run did."""
    import torch

    from strotss_torch.ops import sampling
    from strotss_torch.solve import scale_generators

    gens = {}

    def coords(i, kind, step, hw, n, region=None):
        if i not in gens:
            gens[i] = scale_generators(seed, i, "cpu")
        mask = None
        if region is not None:
            raw = sm if kind == "style" else cm
            mask = sampling.prepare_mask(torch.tensor(raw[region]), hw)
        draw = sampling.full_grid_coords if kind == "style" else \
            sampling.strided_grid_coords
        gen = gens[i][0 if kind == "style" else 1]
        return draw(gen, hw, n, "cpu", mask=mask).to(device)

    return coords


def torch_cell(protocol, dtype, seeds, device, coords="device", **over):
    """The port's per-seed tail-means of one protocol and dtype, and each
    kernel's launches over the cell's runs (all 0 on the CPU).
    ``coords``: draw the samples on the run's device, or on the CPU
    (:func:`cpu_draws`)."""
    import torch

    import strotss_torch
    from strotss_torch.solve import stylize_single

    st = settings(protocol, **over)
    params = torch_params()
    content, style, cm, sm = inputs(protocol)
    masks = {} if cm is None else {"content_masks": cm, "style_masks": sm}
    before = _launches()
    out = {m: [] for m in METRICS}
    t0 = time.perf_counter()
    for seed in seeds:
        cfg = strotss_torch.StrotssConfig(**_config_kw(st, dtype, seed))
        if coords == "cpu":
            _, info = stylize_single(
                torch.tensor(content, device=device),
                torch.tensor(style, device=device), cfg, params,
                coords_source=cpu_draws(seed, cm, sm, device),
                **{k: torch.tensor(v, device=device)
                   for k, v in masks.items()})
        else:
            _, info = strotss_torch.stylize(content, style, cfg,
                                            vgg_params=params,
                                            device=device, **masks)
        for m, v in tail_means(info["scales"][0]["curve"],
                               st["tail"]).items():
            out[m].append(v)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: n - before[k] for k, n in _launches().items()}
    return out


def _spread_p(sj, st, nj, nt):
    """Two-sided F-test p-value of equal variances, or None."""
    if nj < 2 or nt < 2 or sj == 0.0 or st == 0.0:
        return None
    from scipy.stats import f

    ratio = (st / sj) ** 2
    tail = f.sf(ratio, nt - 1, nj - 1) if ratio > 1 else \
        f.cdf(ratio, nt - 1, nj - 1)
    return float(min(1.0, 2.0 * tail))


def verdict(jax_vals, torch_vals):
    """Both sides' means and spreads, each torch seed's relative deviation
    from JAX's mean, the limit of :data:`RULE` and whether it holds."""
    j = np.asarray(jax_vals, np.float64)
    t = np.asarray(torch_vals, np.float64)
    mj, mt = float(j.mean()), float(t.mean())
    sj = float(j.std(ddof=1)) if j.size > 1 else 0.0
    st = float(t.std(ddof=1)) if t.size > 1 else 0.0
    limit = max(3.0 * sj * math.sqrt(1.0 / j.size + 1.0 / t.size),
                0.01 * abs(mj))
    diff = abs(mt - mj)
    return {"jax": j.tolist(), "torch": t.tolist(), "mean_jax": mj,
            "std_jax": sj, "mean_torch": mt, "std_torch": st,
            "spread_ratio": st / sj if sj else None,
            "spread_p": _spread_p(sj, st, j.size, t.size),
            "rel_dev": ((t - mj) / abs(mj)).tolist(), "diff": diff,
            "limit": limit, "pass": bool(diff <= limit)}


def single_draw(band_cell, metric, value):
    """One torch draw against the JAX band (:data:`SINGLE_RULE`): a draw
    of the same distribution lies off the n seeds' mean by a deviation of
    s * sqrt(1 + 1/n); four of them. The five seeds' min-max range would
    be left by a sixth draw a third of the time; a limit in percent of the
    mean, below JAX's own spread, would fail the JAX package itself."""
    j = np.asarray(band_cell[metric], np.float64)
    mj, sj = float(j.mean()), float(j.std(ddof=1))
    limit = 4.0 * sj * math.sqrt(1.0 + 1.0 / j.size)
    return {"value": value, "mean_jax": mj, "std_jax": sj,
            "diff": abs(value - mj), "limit": limit,
            "pass": bool(abs(value - mj) <= limit)}


def cell_name(protocol, dtype):
    return f"{protocol}/{dtype}"


def _seeds(text):
    """'0,1,2' or '0-19' (inclusive) as a list of ints."""
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(s) for s in text.split(",")]


def _overrides(args):
    return {"steps": args.steps, "tail": args.tail,
            "sample_size": args.sample_size,
            "taps": args.taps.split(",") if args.taps else None}


def _protocols_block(protocols, over):
    return {p: settings(p, **over) for p in protocols}


def run_jax_side(protocols, dtypes, seeds, out, jobs=4, extend=False,
                 **over):
    """One subprocess per protocol and dtype, ``jobs`` at a time; writes
    the band to ``out`` and returns it. ``extend``: keep the band already
    at ``out`` (same protocols, dtypes and JAX version) and run only the
    seeds it lacks, appending their tail-means."""
    old = None
    if extend:
        with open(out) as f:
            old = json.load(f)
        if old["protocols"] != _protocols_block(protocols, over):
            raise ValueError(f"{out} holds other protocols")
        seeds = [s for s in seeds if s not in old["seeds"]]
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS",
                                                        "cpu"))
    cells = [(p, d) for p in protocols for d in dtypes]
    results, running = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        def wait_one():
            (p, d), path, proc = running.pop(0)
            if proc.wait() != 0:
                raise RuntimeError(f"JAX side {p}/{d} failed "
                                   f"(rc {proc.returncode})")
            with open(path) as f:
                results[cell_name(p, d)] = json.load(f)

        try:
            for p, d in cells:
                if len(running) >= jobs:
                    wait_one()
                path = os.path.join(tmp, f"{p}_{d}.json")
                cmd = [sys.executable, os.path.abspath(__file__), "--side",
                       "jax", "--cell", f"{p}:{d}", "--seeds",
                       ",".join(map(str, seeds)), "--out", path]
                for k, v in over.items():
                    if v is not None:
                        cmd += [f"--{k}",
                                ",".join(v) if k == "taps" else str(v)]
                running.append(((p, d), path,
                                subprocess.Popen(cmd, env=env)))
            while running:
                wait_one()
        finally:  # a failed cell stops the others
            for _, _, proc in running:
                proc.kill()
                proc.wait()
    import jax

    if old is not None:
        if old["jax_version"] != jax.__version__:
            raise ValueError(f"{out} was made with jax {old['jax_version']}")
        for name, got in results.items():
            was = old["cells"][name]
            got.update({m: was[m] + got[m] for m in METRICS},
                       seconds=was["seconds"] + got["seconds"])
        seeds = old["seeds"] + list(seeds)
    band = {"what": "the JAX package's per-seed tail-means "
                    "(tools/parity_torch.py --side jax)",
            "jax_version": jax.__version__,
            "seeds": list(seeds), "metrics": list(METRICS),
            "protocols": _protocols_block(protocols, over),
            "cells": {cell_name(p, d): results[cell_name(p, d)]
                      for p, d in cells}}
    _write(out, band)
    return band


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_torch_side(protocols, dtypes, seeds, device, band, out,
                   extend=False, coords="device", **over):
    """Run the port's cells, hold them to ``band`` (a dict or a path) and
    write the report to ``out``; returns it. ``extend``: keep the per-seed
    tail-means of the report already at ``out`` (same device and
    protocols) and run only the seeds it lacks; with none lacking, the
    report is judged anew against ``band``."""
    import torch

    if isinstance(band, str):
        with open(band) as f:
            band = json.load(f)
    report = {"what": "the port's per-seed tail-means against the JAX "
                      "package's (tools/parity_torch.py --side torch)",
              "device": device, "coords": coords,
              "torch_version": torch.__version__,
              "rule": RULE, "seeds": list(seeds),
              "protocols": _protocols_block(protocols, over), "cells": {}}
    old = None
    if extend and os.path.exists(out):
        with open(out) as f:
            old = json.load(f)
        if (old["device"], old.get("coords", "device")) != (
                device, coords) or any(
                old["protocols"][p] != report["protocols"][p]
                for p in protocols):
            raise ValueError(f"{out} holds another device or protocol")
        report["seeds"] = old["seeds"] + [s for s in seeds
                                          if s not in old["seeds"]]
    new = report["seeds"][len(old["seeds"]) if old else 0:]
    if old is not None and not new:  # judged anew: the runs are old's
        report.update({k: old[k] for k in ("torch_version", "card")
                       if k in old})
    elif torch.device(device).type == "cuda":
        report["card"] = _card()
    for p in protocols:
        if band["protocols"][p] != report["protocols"][p]:
            raise ValueError(f"the band's {p} protocol "
                             f"{band['protocols'][p]} is not this run's "
                             f"{report['protocols'][p]}")
        for d in dtypes:
            name = cell_name(p, d)
            got = (torch_cell(p, d, new, device, coords, **over) if new else
                   {"seconds": 0.0, "launches": {}})
            if old is not None:
                was = old["cells"][name]
                got.update({m: was[m]["torch"] + got.get(m, [])
                            for m in METRICS},
                           seconds=was["seconds"] + got["seconds"],
                           launches={k: n + got["launches"].get(k, 0)
                                     for k, n in was["launches"].items()})
            ref = band["cells"][name]
            report["cells"][name] = {
                "seconds": got["seconds"], "launches": got["launches"],
                "jax_seconds": ref["seconds"],
                **{m: verdict(ref[m], got[m]) for m in METRICS}}
            print(json.dumps({name: {m: report["cells"][name][m]["pass"]
                                     for m in METRICS}}), flush=True)
    report["all_pass"] = all(c[m]["pass"] for c in report["cells"].values()
                             for m in METRICS)
    _write(out, report)
    return report


def _write(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch side: 'cuda' (the kernels) or 'cpu'")
    ap.add_argument("--protocols", default="default,masked")
    ap.add_argument("--dtypes", default=",".join(DTYPES))
    ap.add_argument("--seeds", default=f"{SEEDS[0]}-{SEEDS[-1]}",
                    help="comma-separated, or a range 'a-b'")
    ap.add_argument("--band", default=BAND,
                    help="the JAX side's output, the torch side's input")
    ap.add_argument("--out", default=None,
                    help="default: the band (jax side) or "
                         "tools/parity_torch_<device>.json")
    ap.add_argument("--jobs", type=int, default=4,
                    help="jax side: processes at a time")
    ap.add_argument("--coords", choices=("device", "cpu"), default="device",
                    help="torch side: draw the samples on the run's device "
                         "or on the CPU (those of the CPU run of each seed)")
    ap.add_argument("--extend", action="store_true",
                    help="add the seeds that the output lacks to it")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--tail", type=int, default=None)
    ap.add_argument("--sample_size", type=int, default=None)
    ap.add_argument("--taps", default=None)
    ap.add_argument("--cell", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    protocols = args.protocols.split(",")
    dtypes = args.dtypes.split(",")
    seeds = _seeds(args.seeds)
    over = _overrides(args)
    if args.side == "jax":
        if args.cell:  # one protocol and dtype, spawned by run_jax_side
            p, d = args.cell.split(":")
            _write(args.out, jax_cell(p, d, seeds, **over))
            return 0
        run_jax_side(protocols, dtypes, seeds, args.out or args.band,
                     args.jobs, args.extend, **over)
        return 0
    out = args.out or os.path.join(HERE, f"parity_torch_{args.device}.json")
    report = run_torch_side(protocols, dtypes, seeds, args.device, args.band,
                            out, args.extend, args.coords, **over)
    print(json.dumps({"all_pass": report["all_pass"], "out": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
