"""Whole parity runs of both packages on the same sample coordinates.

``tools/parity_torch.py`` compares the two packages' seed distributions:
each side draws its own samples. This tool removes the draws from the
comparison: for each seed it runs the JAX package's protocol run (float32,
XLA on the CPU) and then the port's on the coordinates that the JAX
package drew, rebuilt from its key splits (per scale ``fold_in`` and a
split in three, per step the scan's split, per region ``split(key, K)``;
``strotss_tpu/solve.py``, ``programs.py:274,529,665``). The two curves
then differ only by float32 arithmetic and how the optimization amplifies
it. As a control the port runs a second time on the same coordinates with
one CPU thread, which sums in another order: the port against itself
shows how far float32 rounding alone carries two runs apart. Reported per
seed and pair (JAX against the port, the port against its control): the
relative difference of the loss at each of the first 10 steps, the first
step at which it exceeds 1e-3, and the tail-means' relative differences.

Needs JAX; run it on the CPU::

    JAX_PLATFORMS=cpu python tools/parity_replay.py --seeds 0-2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import parity_torch as P  # noqa: E402

OUT = os.path.join(HERE, "parity_replay.json")


def jax_coords(seed, cm=None, sm=None):
    """A ``CoordsSource`` giving the JAX package's coordinates, region by
    region under masks. Steps are asked for in order, so each scale's key
    chain advances once per step."""
    import jax
    import jax.numpy as jnp
    import torch

    from strotss_tpu.ops import sampling as JS

    chain = {}

    def keys(i):
        if i not in chain:
            key = jax.random.PRNGKey(seed)
            _, k_style, k_run = jax.random.split(jax.random.fold_in(key, i), 3)
            chain[i] = {"style": k_style, "run": k_run, "step": -1,
                        "k_step": None}
        return chain[i]

    def coords(i, kind, step, hw, n, region=None):
        c = keys(i)
        if kind == "style":
            k = c["style"]
        else:
            while c["step"] < step:
                c["run"], c["k_step"] = jax.random.split(c["run"])
                c["step"] += 1
            k = c["k_step"]
        draw = JS.full_grid_coords if kind == "style" else \
            JS.strided_grid_coords
        if region is None:
            return torch.tensor(np.asarray(draw(k, hw, n)))
        raw = sm if kind == "style" else cm
        mask = JS.prepare_mask(jnp.asarray(raw[region]), hw)
        k = jax.random.split(k, len(raw))[region]
        return torch.tensor(np.asarray(draw(k, hw, n, mask)))

    return coords


def replay(protocol, seed, **over):
    """Both packages' curves of one float32 protocol run of ``seed`` on the
    JAX package's coordinates, and their comparison."""
    import jax.numpy as jnp
    import torch

    import strotss_torch
    from strotss_torch.solve import stylize_single as torch_stylize
    from strotss_tpu.config import StrotssConfig as JaxConfig
    from strotss_tpu.solve import stylize_single as jax_stylize

    st = P.settings(protocol, **over)
    kw = P._config_kw(st, "float32", seed)
    params = P.torch_params()
    content, style, cm, sm = P.inputs(protocol)
    jparams = {name: {"kernel": jnp.asarray(p["kernel"].permute(2, 3, 1, 0)
                                            .numpy()),
                      "bias": jnp.asarray(p["bias"].numpy())}
               for name, p in params.items()}
    t0 = time.perf_counter()
    masks = {} if cm is None else {"content_masks": jnp.asarray(cm),
                                   "style_masks": jnp.asarray(sm)}
    _, jinfo = jax_stylize(jnp.asarray(content), jnp.asarray(style),
                           JaxConfig(use_pallas=False, precompile=False, **kw),
                           jparams, **masks)
    curves = {"jax": jinfo["scales"][0]["curve"]}
    seconds = {"jax": time.perf_counter() - t0}
    masks = {} if cm is None else {"content_masks": torch.tensor(cm),
                                   "style_masks": torch.tensor(sm)}
    threads = torch.get_num_threads()
    for name, n in (("torch", threads), ("control", 1)):
        torch.set_num_threads(n)
        t0 = time.perf_counter()
        _, tinfo = torch_stylize(torch.tensor(content), torch.tensor(style),
                                 strotss_torch.StrotssConfig(**kw), params,
                                 coords_source=jax_coords(seed, cm, sm),
                                 **masks)
        curves[name] = tinfo["scales"][0]["curve"]
        seconds[name] = time.perf_counter() - t0
    torch.set_num_threads(threads)
    tails = {k: P.tail_means(c, st["tail"]) for k, c in curves.items()}
    return {"seed": seed, "tails": tails, "seconds": seconds,
            "torch_threads": threads,
            "jax_vs_torch": _compare(curves["jax"], curves["torch"],
                                     tails["jax"], tails["torch"]),
            "torch_vs_control": _compare(curves["torch"], curves["control"],
                                         tails["torch"], tails["control"])}


def _compare(a, b, ta, tb):
    """How far curve ``b`` lies from ``a``: the loss's relative difference
    at each of the first 10 steps, the first step (1-based) where it
    exceeds 1e-3, and the tail-means' relative differences."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.abs(b[:, 0] - a[:, 0]) / np.abs(a[:, 0])
    over = np.nonzero(rel > 1e-3)[0]
    return {"rel_diff_first_10": rel[:10].tolist(),
            "first_step_over_1e-3": int(over[0]) + 1 if over.size else None,
            "tail_rel_diff": {m: (tb[m] - ta[m]) / abs(ta[m])
                              for m in P.METRICS}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocols", default="default,masked")
    ap.add_argument("--seeds", default="0-2",
                    help="comma-separated, or a range 'a-b'")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--tail", type=int, default=None)
    ap.add_argument("--sample_size", type=int, default=None)
    ap.add_argument("--taps", default=None)
    args = ap.parse_args(argv)
    over = P._overrides(args)
    protocols = args.protocols.split(",")
    report = {"what": "both packages on the JAX package's coordinates "
                      "(tools/parity_replay.py), float32, CPU",
              "protocols": P._protocols_block(protocols, over), "cells": {}}
    for p in protocols:
        rows = [replay(p, s, **over) for s in P._seeds(args.seeds)]
        report["cells"][p] = {"seeds": rows, **{
            pair: {m: float(np.mean([r[pair]["tail_rel_diff"][m]
                                     for r in rows])) for m in P.METRICS}
            for pair in ("jax_vs_torch", "torch_vs_control")}}
        print(json.dumps({p: {k: v for k, v in report["cells"][p].items()
                              if k != "seeds"}}), flush=True)
    P._write(args.out, report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
