"""What makes two runs of the port on a CUDA card differ, bit for bit.

Four measurements, printed as JSON lines, with the card's name and
power limit first:

1. ``index_add_`` (K1's VJP scatters with it) and ``index_put_(...,
   accumulate=True)`` on a (1024, 2179) float32 target with repeated
   indices, 20 times each: how many distinct results.
2. A short batch (2 pairs of 240x320, 2 scales x 10 steps) run twice,
   with PyTorch's default algorithms and with
   ``torch.use_deterministic_algorithms(True)`` (what ranks that hold
   replicas of one pyramid switch on): whether the two float images are
   bit for bit equal.
3. VGG16 (9 taps, the bf16 policy) forward and input gradient at
   384x512 on batches of 4, 2 and 1 images: whether image 0's taps and
   gradient depend on the batch size (cuDNN's algorithm choice).
4. What the deterministic algorithms cost: the default single run
   (``StrotssConfig(max_iter=10)``, 480x640 content, 720x560 style, 4
   scales x 10 steps) after a one-step warm-up, timed with the default
   algorithms and with the switches, in the order default,
   deterministic, deterministic, default; seconds a step of each run.

Run on the card from the repository root:
``PYTHONPATH=. python tools/determinism_probe.py``.
"""

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

import strotss_torch
from strotss_torch import programs
from strotss_torch.models.vgg import VGG
from strotss_torch.models.weights import random_params
from strotss_torch.parallel import stylize_batch


def _image(seed, n, h, w):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(
        np.float32)


def scatter_repeats():
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, 1024, (1024,), device="cuda", generator=gen)
    src = torch.randn(1024, 2179, device="cuda", generator=gen)
    out = {}
    for name, fn in (
            ("index_add_", lambda t: t.index_add_(0, idx, src)),
            ("index_put_accumulate",
             lambda t: t.index_put_((idx,), src, accumulate=True))):
        runs = {fn(torch.zeros(1024, 2179, device="cuda")).cpu().numpy()
                .tobytes() for _ in range(20)}
        out[name] = len(runs)
    return {"probe": "scatter", "distinct_results_of_20": out}


def batch_repeats(params):
    c, s = _image(0, 2, 240, 320), _image(1, 2, 240, 320)
    cfg = strotss_torch.StrotssConfig(levels=2, max_iter=10)
    out = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        a, b = (stylize_batch(c, s, cfg, params, device="cuda",
                              pair_seeds=[1, 2])[1]["stylized"].cpu()
                for _ in range(2))
        out["deterministic" if det else "default"] = {
            "bitwise": bool(torch.equal(a, b)),
            "max_abs_diff": float((a - b).abs().max())}
    torch.use_deterministic_algorithms(False)
    return {"probe": "batch_repeat", **out}


def batch_size(params):
    spec = programs.spec_from_config(strotss_torch.StrotssConfig(), "cuda",
                                     batched=True)
    vgg = VGG({k: {n: t.cuda() for n, t in p.items()}
               for k, p in params.items()}, taps=spec.taps,
              compute_dtype=spec.compute_dtype,
              block1_impl=spec.block1_impl)
    imgs = torch.tensor(_image(2, 4, 384, 512), device="cuda")
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with programs.precision(spec):
        got = {}
        for b in (4, 2, 1):
            x = imgs[:b].clone().requires_grad_(True)
            taps = vgg(x)
            g, = torch.autograd.grad(
                sum((t.float() ** 2).sum() for t in taps), x)
            got[b] = ([t[:1].detach() for t in taps], g[:1])
        for b in (2, 1):
            out[f"4_vs_{b}"] = {
                "taps_equal": dict(zip(spec.taps, (
                    bool(torch.equal(u, v))
                    for u, v in zip(got[4][0], got[b][0])))),
                "grad_equal": bool(torch.equal(got[4][1], got[b][1])),
                "grad_max_rel_diff": float(
                    (got[4][1] - got[b][1]).abs().max()
                    / got[4][1].abs().max())}
    torch.use_deterministic_algorithms(False)
    return {"probe": "batch_size", **out}


def _switches(det):
    """The deterministic switches as ``programs.precision`` sets them."""
    torch.use_deterministic_algorithms(det, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = not det


def step_time(params):
    c, s = _image(3, 1, 480, 640), _image(4, 1, 720, 560)
    cfg = strotss_torch.StrotssConfig(max_iter=10)
    strotss_torch.stylize(c, s, dataclasses.replace(cfg, max_iter=1),
                          vgg_params=params)
    runs = []
    for det in (False, True, True, False):
        _switches(det)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strotss_torch.stylize(c, s, cfg, vgg_params=params)
        torch.cuda.synchronize()
        runs.append({"deterministic": det, "seconds_per_step":
                     (time.perf_counter() - t0) / (cfg.levels
                                                   * cfg.max_iter)})
    _switches(False)
    return {"probe": "step_time", "runs": runs}


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    params = random_params("16", seed=0)
    for probe in (scatter_repeats(), batch_repeats(params),
                  batch_size(params), step_time(params)):
        print(json.dumps(probe), flush=True)


if __name__ == "__main__":
    main()
