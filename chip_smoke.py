#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``strotss_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the CUDA kernels from ``strotss_torch/csrc``, holds each kernel
against its plain PyTorch version on the card (REMD minima on both of
K1's routes: tensor cores for the features, CUDA cores for YUV; self-
similarity forward and backward at N = 1024 and 32769, VGG block1 forward
and backward at the 512 px content and style shapes, the 64 px content
shape and a shape smaller than one forward tile, the Sinkhorn LSE pass
at 32769 x 32769, a ragged shape and a shape just above its route
threshold, with its operands' preparation held to their plain layout,
and the streamed Sinkhorn loss and gradient; the hypercolumn gathers,
kernel pair K5, at the 512 px scale's 10 maps and at 32769 samples, rows
bit for bit the plain route's, gradients bit for bit their mirror and
within one unit in the last place of float64), runs a short slice of the
64 px scale with the kernels and with the plain versions, and then drives
the default stylization (VGG16, 9 taps, 1024 samples, 4 scales to 512 px)
through ``strotss_torch.stylize``, counting each kernel's launches (K5's
too). It drives the same run with two region masks (BASELINE config 3, masks loaded from PNGs
by ``strotss_torch.ops.masks.load_mask``), after holding one masked step's
kernel losses to the plain ones. The batch phase runs 8 pairs at full
width through ``strotss_torch.parallel.stylize_batch`` (BASELINE config
4; VGG block1 over the pair axis, one launch of K3a and K3b a step),
holds 10 batched steps to each pair's single step from the same state,
and runs a masked batch with a padded region; the serve phase runs
``python -m strotss_torch.serve`` on 6 jobs (a batch of 4, a bad job, a
warm job). The multi phase starts ranks through
``strotss_torch.parallel.launch``: two sharing the card over gloo hold
the sample-sharded REMD (K1 on each rank's shard) bit for bit to one
rank and the sample-sharded Sinkhorn to the unsharded one, run
full-width ``shard_samples`` (with REMD and with Sinkhorn) and
``shard_spatial`` stylizations step by step against the unsharded step,
a 2048 px
``shard_spatial`` step against one rank's peak memory, and a batch over
a 'data' mesh bit for bit against one rank on a world-size-1 NCCL mesh;
serve runs with ``--data_devices 1``; K3a and K3b are held on the
'spatial' slabs of one image to the whole image's launches. The kernel
phase also holds K3a and K3b on a batch of images bit for bit to
one-image launches. The features phase blends a second
style with checkpoints, resumes from a checkpoint copied aside, refines
the default run's result at ``start_level=3`` without and with
``remat``, traces the CLI with ``--profile_dir`` and tests the law of
the CUDA generator's coordinate draws against the CPU's. It profiles 10
steps a scale. Then it
drives the ``--sinkhorn`` path twice: below the memory gate (BASELINE
config 5 at reduced depth, the plain materialized Sinkhorn) and above it
(32769 samples, kernel K4). Last, seed 0 of both whole-run parity
protocols of ``tools/parity_torch.py`` in bfloat16 is held to the JAX
package's band (``tools/parity_jax_band.json``). Each phase prints one
JSON line; any failure exits non-zero. The last two lines are the
kernels' measurements and ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# fp32 peak of the CUDA cores, dense bf16 peak of the tensor cores and
# memory rate, by SKU (NVIDIA data sheets); dense TF32 at half the bf16
# rate; special-function results (expf, sqrtf) at 16 per SM and clock
# against 256 fp32 operations, so 1/16 of the fp32 rate
_PEAKS = {
    "SXM": {"fp32": 67e12, "bf16": 989e12, "bytes": 3.35e12},
    "NVL": {"fp32": 60e12, "bf16": 835e12, "bytes": 3.9e12},
    "PCIE": {"fp32": 51e12, "bf16": 756e12, "bytes": 2.0e12},
}
for _rates in _PEAKS.values():
    _rates["sfu"] = _rates["fp32"] / 16
    _rates["tf32"] = _rates["bf16"] / 2

_REPLACES = {
    "remd_mins": "strotss_tpu/ops/kernels/remd.py:142",
    "selfsim_fwd": "strotss_tpu/ops/kernels/selfsim.py:162",
    "selfsim_bwd": "strotss_tpu/ops/kernels/selfsim.py:198",
    "block1_fwd": "strotss_tpu/ops/kernels/block1.py:194",
    "block1_bwd": "strotss_tpu/ops/kernels/block1.py:238",
    "sinkhorn_lse": "strotss_tpu/ops/kernels/sinkhorn.py:106",
    # the JAX package gathers through XLA
    "gather_fwd": "none (strotss_tpu/ops/sampling.py, XLA gathers)",
    "gather_bwd": "none (strotss_tpu/ops/sampling.py, XLA gathers)",
}
_SOURCES = {
    "remd_mins": "strotss_torch/csrc/remd.cu",
    "selfsim_fwd": "strotss_torch/csrc/selfsim.cu",
    "selfsim_bwd": "strotss_torch/csrc/selfsim.cu",
    "block1_fwd": "strotss_torch/csrc/block1.cu",
    "block1_bwd": "strotss_torch/csrc/block1.cu",
    "sinkhorn_lse": "strotss_torch/csrc/sinkhorn.cu",
    "gather_fwd": "strotss_torch/csrc/gather.cu",
    "gather_bwd": "strotss_torch/csrc/gather.cu",
}


class PhaseError(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def peaks(name: str):
    up = name.upper().replace(" ", "")
    for key, rates in _PEAKS.items():
        if key in up:
            return key, rates
    return "SXM", _PEAKS["SXM"]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch

    from strotss_torch.utils.timing import CudaTimer

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        timer = CudaTimer()
        timer.start()
        fn()
        timer.stop()
        times.append(timer.seconds() * 1e3)
    return statistics.median(times)


def device_ms(fn, names, reps: int = 20):
    """Device time per call of ``fn`` in the kernels whose names start with
    one of ``names`` (each launched once a call), from torch.profiler over
    ``reps`` calls; "not measured" if the profiler sees no device time.
    Each kernel's time is divided by the launches the profiler recorded,
    not by ``reps``: a profile of 2 calls of K2 at N = 32769 once showed
    half the time CUDA events show for one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ms = 0.0
    # a window that records none of the kernels (seen once for K2a's
    # cluster launches at N = 1024) is profiled once more
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            # a template kernel's name reads "void name<...>(...)"
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and ev.key.removeprefix("void ").startswith(tuple(names))
                    and ev.count):
                dev = getattr(ev, "self_device_time_total", None)
                dev = dev if dev is not None else ev.self_cuda_time_total
                ms += dev / 1e3 / ev.count
        if ms > 0:
            return ms
    return "not measured"


def bound_ms(flops: float, nbytes: float, rates, ops: str = "fp32") -> tuple:
    """(least ms, what sets it) for ``flops`` operations at the ``ops``
    peak and ``nbytes`` at the memory rate."""
    t_ops = flops / rates[ops] * 1e3
    t_bytes = nbytes / rates["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: no CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    emit({"phase": "card", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    # the nvidia-smi line on its own, as the measurement record wants it
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return name


def phase_build():
    from strotss_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    for name in build._SIGNATURES:
        build.function(name)
    seconds = time.perf_counter() - t0
    ptxas = {k: [ln for ln in v.splitlines() if "registers" in ln
                 or "spill" in ln or "Compiling entry" in ln]
             for k, v in build.build_info.items() if k.startswith("ptxas")}
    emit({"phase": "build", "seconds": seconds, "dir": build.build_info["dir"],
          "ptxas": ptxas})


def _inputs(gen_seed: int, shape, positive: bool = False):
    import torch

    rng = np.random.default_rng(gen_seed)
    a = rng.random(shape) if positive else rng.standard_normal(shape)
    return torch.tensor(a, dtype=torch.float32, device="cuda")


def _grad_err(g, ref) -> float:
    """max|g - ref| / max|ref|, in float64."""
    g, ref = g.double(), ref.double()
    return float((g - ref).abs().max() / ref.abs().max())


def _dist64(x, y, distance):
    """The distances of ``strotss_torch.ops.losses`` in float64 (the port's
    own functions compute in float32 whatever they are given)."""
    import torch

    x, y = x.double(), y.double()
    out = 0.0
    if distance in ("cosine", "both"):
        xn = x * torch.rsqrt((x * x).sum(1, keepdim=True).clamp(min=1e-12))
        yn = y * torch.rsqrt((y * y).sum(1, keepdim=True).clamp(min=1e-12))
        out = 1.0 - xn @ yn.T
    if distance in ("l2", "both"):
        m = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
             - 2.0 * (x @ y.T))
        out = out + torch.sqrt(m.clamp(min=1e-6) / x.shape[1])
    return out


def _rows_off(g, ref) -> int:
    """How many rows of ``g`` stray from ``ref`` by more than 1e-4 of
    max|ref|."""
    row_err = (g.double() - ref.double()).abs().amax(dim=1)
    return int((row_err > 1e-4 * ref.double().abs().max()).sum())


def _rel(a, ref) -> float:
    """Largest elementwise relative error of ``a`` against ``ref``."""
    a, ref = a.double(), ref.double()
    return float(((a - ref).abs() / ref.abs().clamp(min=1e-30)).max())


_K1_TILE_KERNELS = {"cuda_cores": "remd_tile_kernel",
                    "tensor_cores": "remd_tc_kernel"}


def check_remd(n, m, c, distance, seed, rates):
    """K1 against its plain version at one shape; returns measurements."""
    import torch

    from strotss_torch.ops.kernels import remd
    from strotss_torch.ops.losses import dist_metrics

    x = _inputs(seed, (n, c), positive=(c == 3))
    y = _inputs(seed + 1, (m, c), positive=(c == 3))
    route = remd.route(c)
    rmin, cmin, rarg, carg = remd.mins(x, y, distance)
    again = remd.mins(x, y, distance)
    check(all(torch.equal(a, b) for a, b in
              zip((rmin, cmin, rarg, carg), again)),
          f"remd_mins {n}x{m}x{c} {distance}: two runs differ")
    # Values: rtol 1e-5 against the plain version, or, where the distance
    # itself is ill-conditioned in float32 (the L2 expansion and 1 - cos for
    # near neighbours at C = 3), no further from the float64 minima than
    # twice the plain float32 version's own distance from them.
    p_rmin, p_cmin, p_rarg, p_carg = remd.mins_plain(x, y, distance)
    full = _dist64(x, y, distance)
    r64, c64 = full.min(dim=1).values, full.min(dim=0).values
    plain_err = max(_rel(p_rmin, r64), _rel(p_cmin, c64))
    err = max(_rel(rmin, p_rmin), _rel(cmin, p_cmin))
    err64 = max(_rel(rmin, r64), _rel(cmin, c64))
    tol = max(1e-5, 2.0 * plain_err)
    check(err <= 1e-5 or err64 <= tol,
          f"remd_mins {distance} C={c}: minima rel err {err} (vs float64 "
          f"{err64}, plain float32 vs float64 {plain_err})")
    rows = torch.arange(n, device="cuda")
    cols = torch.arange(m, device="cuda")
    arg_err = max(_rel(full[rows, rarg.long()], r64),
                  _rel(full[carg.long(), cols], c64))
    n_flip = int((rarg != p_rarg).sum() + (carg != p_carg).sum())
    check(arg_err <= tol,
          f"remd_mins {distance} C={c}: distance at the kernel's argmin is "
          f"{arg_err} (rel) off the float64 minimum")

    # gradients: the kernel's VJP against plain autograd through the
    # materialized matrix at the same (kernel) argmins, so that a near-tie
    # resolved differently by rounding cannot masquerade as a VJP error;
    # 1e-4 of max|g|, or no further from float64 than twice plain float32
    xk = x.clone().requires_grad_(True)
    yk = y.clone().requires_grad_(True)
    r1, c1 = remd.remd_mins(xk, yk, distance, "kernel")
    gk = torch.autograd.grad(torch.maximum(r1.mean(), c1.mean()), [xk, yk])

    def plain_grads(dtype):
        xp = x.to(dtype).requires_grad_(True)
        yp = y.to(dtype).requires_grad_(True)
        dist = dist_metrics[distance] if dtype == torch.float32 else (
            lambda a, b: _dist64(a, b, distance))
        fp = dist(xp, yp)
        lp = torch.maximum(fp[rows, rarg.long()].mean(),
                           fp[carg.long(), cols].mean())
        return torch.autograd.grad(lp, [xp, yp])

    gp = plain_grads(torch.float32)
    g64 = plain_grads(torch.float64)
    gerr = max(_grad_err(a, b) for a, b in zip(gk, gp))
    gerr64 = max(_grad_err(a, b) for a, b in zip(gk, g64))
    gplain64 = max(_grad_err(a, b) for a, b in zip(gp, g64))
    check(gerr <= 1e-4 or gerr64 <= max(1e-4, 2.0 * gplain64),
          f"remd_mins {distance} C={c}: grad err {gerr} (vs float64 "
          f"{gerr64}, plain float32 vs float64 {gplain64})")

    def call():
        return remd.mins(x, y, distance)

    ms = time_ms(call)
    # the route's tile kernel and the reduction apart; the other route's
    # tile kernel at the same shape, forced, for comparison
    tile_ms = device_ms(call, (_K1_TILE_KERNELS[route],))
    reduce_ms = device_ms(call, ("remd_reduce_kernel",))
    dev_ms = (tile_ms + reduce_ms if isinstance(tile_ms, float)
              and isinstance(reduce_ms, float) else "not measured")
    other = next(r for r in remd.ROUTES if r != route)
    other_ms = device_ms(lambda: remd.mins(x, y, distance, other),
                         (_K1_TILE_KERNELS[other],))
    plain_ms = time_ms(lambda: remd.mins_plain(x, y, distance))
    library_ms = None
    if distance == "cosine":
        # yardstick: cdist of the normalized rows is monotone in the cosine
        # distance, so its minima pick the same pairs
        xn = torch.nn.functional.normalize(x, dim=1)
        yn = torch.nn.functional.normalize(y, dim=1)

        def lib():
            d = torch.cdist(xn, yn)
            return d.min(dim=1), d.min(dim=0)

        library_ms = time_ms(lib)
    epi = {"cosine": 5, "l2": 7, "both": 11}[distance]
    flops = 2.0 * n * m * c + epi * n * m
    nbytes = 4.0 * (n + m) * c + 8.0 * (n + m)
    cores_ms, cores_by = bound_ms(flops, nbytes, rates)
    if route == "tensor_cores":
        # each product is three TF32 products (big.big, big.small,
        # small.big) on the tensor cores
        b_ms, b_by = bound_ms(3 * 2.0 * n * m * c, nbytes, rates, "tf32")
    else:
        b_ms, b_by = cores_ms, cores_by
    out = {"shape": [n, m, c], "distance": distance, "route_taken": route,
           "max_abs_err":
           float(max((rmin - p_rmin).abs().max(), (cmin - p_cmin).abs().max())),
           "max_rel_err": err, "rel_err_vs_f64": err64,
           "plain_rel_err_vs_f64": plain_err, "argmin_flips": n_flip,
           "grad_err": gerr, "grad_err_vs_f64": gerr64,
           "plain_grad_err_vs_f64": gplain64,
           "ms": ms, "device_ms": dev_ms,
           # the wrapper's host share: checks, scratch lookup, the outputs'
           # allocation and the launch
           "host_ms": (ms - dev_ms if isinstance(dev_ms, float)
                       else "not measured"),
           "tile_device_ms": tile_ms, "reduce_device_ms": reduce_ms,
           "other_route": other, "other_route_tile_device_ms": other_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": cores_ms}
    emit({"phase": "kernel", "name": "remd_mins", **out})
    return out


def _signed_rows(seed, n, c, k=16):
    """(n, c) rows of k entries +-1 at distinct random channels, else 0.
    Their norms are 4, so the normalized entries are +-1/4 and every Gram
    entry, column sum and D = 1 - x^ x^T is exact in float32 in any
    summation order: kernel and plain version then see the same signs of
    A - B."""
    import torch

    rng = np.random.default_rng(seed)
    a = np.zeros((n, c), np.float32)
    pos = np.stack([rng.choice(c, k, replace=False) for _ in range(n)])
    a[np.arange(n)[:, None], pos] = rng.choice([-1.0, 1.0], (n, k))
    return torch.tensor(a, device="cuda")


_K2A_KERNELS = ("selfsim_fwd_kernel", "selfsim_fwd_reduce_kernel")
_K2B_KERNELS = ("selfsim_bwd_kernel",)


def _sign_flips(xh, yh, cx, cy, signs):
    """(how many of K2a's signs differ from the plain version's, the
    largest |A - B| among them over max|A - B|); in place, so that N =
    32769 holds three N x N float32 matrices at most."""
    import torch

    a = torch.mm(xh, xh.T).neg_().add_(1.0).div_(cx[None, :])
    b = torch.mm(yh, yh.T).neg_().add_(1.0).div_(cy[None, :])
    a.sub_(b)
    del b
    flips = torch.sign(a).to(torch.int8) != signs
    n_flips = int(flips.sum())
    a.abs_()
    size = float(a[flips].max() / a.max()) if n_flips else 0.0
    return n_flips, size


def check_selfsim(n, c, seed, rates, reps=25, exact=False):
    """K2a and K2b against their plain versions at one shape; ``reps``
    timed calls each (fewer at large N, where one call takes ~1 s).

    ``exact``: :func:`_signed_rows` inputs. Signs of A - B that the
    kernel and the plain version resolve differently grow as N^2 (about
    one at N = 1000, so some thousand at N = 32769), and each moves two
    gradient rows by more than 1e-4 of max|g|; the row-by-row comparison
    at large N needs inputs whose signs both compute alike."""
    import torch

    from strotss_torch.ops.kernels import selfsim

    if exact:
        x, y = _signed_rows(seed, n, c), _signed_rows(seed + 1, n, c)
    else:
        x, y = _inputs(seed, (n, c)), _inputs(seed + 1, (n, c))
    xh, yh, _, _, cx, cy = selfsim._prep(x, y)
    loss, tx, ty, signs = selfsim.selfsim_fwd(xh, yh, cx, cy)
    again = selfsim.selfsim_fwd(xh, yh, cx, cy)
    check(all(torch.equal(a, b) for a, b in zip((loss, tx, ty, signs),
                                                 again)),
          f"selfsim_fwd N={n}: two runs differ")
    del again
    ux, uy = selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    again = selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    check(torch.equal(ux, again[0]) and torch.equal(uy, again[1]),
          f"selfsim_bwd N={n}: two runs differ")
    del again

    p_loss = selfsim.self_similarity_plain(x, y)
    lerr = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
    check(lerr <= 1e-5, f"selfsim N={n}: loss rel err {lerr}")
    flips, flip_size = _sign_flips(xh, yh, cx, cy, signs)
    check(flip_size <= 1e-5, f"selfsim_fwd N={n}: {flips} signs differ from "
          f"the plain version's, where |A - B| reaches {flip_size} of its "
          "largest value")

    # Gradients, row by row: 1e-4 of max|g| in all but 1% of the rows.
    # Where A - B lies within rounding of 0, kernel and plain version may
    # take opposite signs; one such flip at (i, j) moves rows i and j by
    # ~2/(c_j N) |x^_j|, about 1% of max|g| at N ~ 1000, and no other row.
    # K2b itself is compared on the same (t_x, t_y) after the pull-back's
    # projection (which removes the diagonal's rounding-noise sign exactly).
    def project(u, h):
        return u - torch.sum(u * h, dim=1, keepdim=True) * h

    pux, puy = selfsim.selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)
    rows_off_u = max(_rows_off(project(u, h), project(pu, h))
                     for u, pu, h in ((ux, pux, xh), (uy, puy, yh)))

    def grads(fn):
        xx = x.clone().requires_grad_(True)
        yy = y.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xx, yy), [xx, yy])

    gk = grads(lambda a, b: selfsim.self_similarity(a, b, "kernel"))
    gp = grads(lambda a, b: selfsim.self_similarity(a, b, "plain"))
    rows_off_g = max(_rows_off(a, b) for a, b in zip(gk, gp))
    gerr_plain = max(_grad_err(a, b) for a, b in zip(gk, gp))
    check(max(rows_off_u, rows_off_g) <= n // 100,
          f"selfsim N={n}: rows off by more than 1e-4 of max|g|: "
          f"{rows_off_u} of (G + G^T) x^, {rows_off_g} of the gradient")

    warm, dev_reps = min(3, reps), min(20, reps)
    fwd_ms = time_ms(lambda: selfsim.selfsim_fwd(xh, yh, cx, cy), reps, warm)
    bwd_ms = time_ms(lambda: selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty,
                                                 signs), reps, warm)
    fwd_dev = device_ms(lambda: selfsim.selfsim_fwd(xh, yh, cx, cy),
                        _K2A_KERNELS, dev_reps)
    bwd_dev = device_ms(lambda: selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty,
                                                    signs),
                        _K2B_KERNELS, dev_reps)
    xr = x.clone().requires_grad_(True)
    yr = y.clone().requires_grad_(True)
    p_val = selfsim.self_similarity_plain(xr, yr)
    plain_fwd_ms = time_ms(lambda: selfsim.self_similarity_plain(x, y), reps,
                           warm)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        p_val, [xr, yr], retain_graph=True), reps, warm)
    del p_val
    # x^ x^T and y^ y^T are symmetric: N(N+1)/2 dot products of length C
    # each, so N(N+1)C operations per Gram matrix (on the tensor cores
    # three TF32 products each); K2a also writes N^2 bytes of signs
    gram_flops = 2 * float(n) * (n + 1) * c
    fwd_flops = gram_flops + 8.0 * n * n
    fwd_bytes = 4.0 * (2 * n * c + 2 * n) + 4.0 * (1 + 2 * n) + float(n) * n
    fwd_cores = bound_ms(fwd_flops, fwd_bytes, rates)
    fwd_tc = bound_ms(3 * gram_flops, fwd_bytes, rates, "tf32")
    # K2b, with the signs as an input: the two products H x^ (on the tensor
    # cores three TF32 products each), reading the signs, x^, y^ and four
    # vectors, writing u for x and y
    prod_flops = 2 * 2.0 * n * n * c
    bwd_bytes = float(n) * n + 4.0 * (2 * n * c + 4 * n) + 4.0 * 2 * n * c
    bwd_cores = bound_ms(prod_flops, bwd_bytes, rates)
    bwd_tc = bound_ms(3 * prod_flops, bwd_bytes, rates, "tf32")

    def host(ms, dev):
        return ms - dev if isinstance(dev, float) else "not measured"

    out = {
        "fwd": {"shape": [n, c], "max_abs_err": abs(float(loss - p_loss)),
                "max_rel_err": lerr, "sign_flips": flips,
                "split": selfsim.fwd_split(
                    n, torch.cuda.get_device_properties(0)
                    .multi_processor_count),
                "ms": fwd_ms, "device_ms": fwd_dev,
                "host_ms": host(fwd_ms, fwd_dev),
                "plain_ms": plain_fwd_ms, "library_ms": None,
                "bound_ms": fwd_tc[0], "bound_by": fwd_tc[1],
                "bound_fp32_cores_ms": fwd_cores[0]},
        "bwd": {"shape": [n, c], "max_abs_err": float(max(
                    (a - b).abs().max() for a, b in zip(gk, gp))),
                "grad_err_vs_plain": gerr_plain,
                "rows_off_projected": rows_off_u,
                "rows_off_grad": rows_off_g, "ms": bwd_ms,
                "device_ms": bwd_dev, "host_ms": host(bwd_ms, bwd_dev),
                "plain_ms": plain_bwd_ms, "library_ms": None,
                "bound_ms": bwd_tc[0], "bound_by": bwd_tc[1],
                "bound_fp32_cores_ms": bwd_cores[0]},
        # the content loss and its gradient as one row: the Gram pair once
        # plus the products, so moving work between K2a and K2b cannot
        # flatter either
        "fwd_bwd": {
            "ms": fwd_ms + bwd_ms,
            "device_ms": (fwd_dev + bwd_dev if isinstance(fwd_dev, float)
                          and isinstance(bwd_dev, float) else "not measured"),
            "bound_fp32_cores_ms": bound_ms(gram_flops + prod_flops,
                                            fwd_bytes + 4.0 * 2 * n * c,
                                            rates)[0],
            "bound_3xtf32_ms": bound_ms(3 * (gram_flops + prod_flops),
                                        fwd_bytes + 4.0 * 2 * n * c, rates,
                                        "tf32")[0]},
    }
    emit({"phase": "kernel", "name": "selfsim", **out})
    return out


def check_block1(h, w, seed, rates):
    """K3a and K3b against their plain versions at one (H, W)."""
    import torch
    import torch.nn.functional as F

    from strotss_torch.models.weights import random_params
    from strotss_torch.ops.kernels import block1 as B

    p = random_params("16", seed)
    k1 = p["block1_conv1"]["kernel"].cuda()
    k2 = p["block1_conv2"]["kernel"].cuda()
    b1 = 0.1 * _inputs(seed + 1, (64,))
    b2 = 0.1 * _inputs(seed + 2, (64,))
    x = _inputs(seed + 3, (h, w, 3))
    g1 = _inputs(seed + 4, (h, w, 64))
    g2 = _inputs(seed + 5, (h, w, 64))
    name = f"block1 {h}x{w}"

    t1, t2 = B.block1_fwd(x, k1, b1, k2, b2)
    # a repeat call builds no weight layout and sets no kernel attribute
    setups = B.fwd_setups()
    layouts = B.cached_fwd_layouts(k1, b1, k2, b2)
    again = B.block1_fwd(x, k1, b1, k2, b2)
    check(torch.equal(t1, again[0]) and torch.equal(t2, again[1]),
          f"{name}: two forward runs differ")
    dx = B.block1_bwd(t1, t2, g1, g2, k1, k2)
    bwd_setups = B.bwd_setups()
    bwd_layouts = B.cached_bwd_layouts(k1, k2)
    check(torch.equal(dx, B.block1_bwd(t1, t2, g1, g2, k1, k2)),
          f"{name}: two backward runs differ")
    # Plain versions on the same inputs (the backward on the kernel's taps).
    # tap1 to 1e-5 of its max (float32 sums of exact bf16 products in
    # another order); tap2 and dx to 1e-3: where that order moves y1 or dy1
    # across a bf16 rounding boundary, one operand moves by 2^-8.
    p1, p2 = B.block1_plain(x, k1, b1, k2, b2)
    pdx = B.block1_bwd_plain(t1, t2, g1, g2, k1, k2)
    e1, e2, edx = _grad_err(t1, p1), _grad_err(t2, p2), _grad_err(dx, pdx)
    check(e1 <= 1e-5 and e2 <= 1e-3 and edx <= 1e-3,
          f"{name}: errors against the plain version (of max|ref|) tap1 "
          f"{e1}, tap2 {e2}, dx {edx}")
    # what the errors are made of: entries of y1 whose bf16 rounding the
    # two sum orders take to different sides, and the kernel against the
    # plain version summed in float64
    y1_flips = int((t1.to(torch.bfloat16) != p1.to(torch.bfloat16)).sum())
    d = [t.double() for t in (x, k1, b1, k2, b2, t1, t2, g1, g2)]
    q1, q2 = B.block1_plain(*d[:5])
    qdx = B.block1_bwd_plain(*d[5:], d[1], d[3])
    vs64 = [_grad_err(a, b) for a, b in ((t1, q1), (t2, q2), (dx, qdx))]

    # yardstick: cuDNN at the same shape, two bf16 F.conv2d + bias + ReLU
    # and their autograd backward
    bf = torch.bfloat16
    xb = x.permute(2, 0, 1)[None].to(bf).requires_grad_(True)
    kb1, kb2, bb1, bb2 = (t.to(bf) for t in (k1, k2, b1, b2))

    def lib_fwd():
        y1 = torch.relu(F.conv2d(xb, kb1, bb1, padding=1))
        return y1, torch.relu(F.conv2d(y1, kb2, bb2, padding=1))

    ly1, ly2 = lib_fwd()
    fwd_ms = time_ms(lambda: B.block1_fwd(x, k1, b1, k2, b2))
    fwd_dev = device_ms(lambda: B.block1_fwd(x, k1, b1, k2, b2),
                        ("block1_fwd_kernel",))
    check(B.fwd_setups() == setups
          and B.cached_fwd_layouts(k1, b1, k2, b2) is layouts,
          f"{name}: repeat forward calls rebuilt the layouts or set the "
          "kernel's attribute again")

    def bwd():
        return B.block1_bwd(t1, t2, g1, g2, k1, k2)

    bwd_ms = time_ms(bwd)
    # K3b's two kernels apart: dy1 (the transposed conv2 and the masks) and
    # dx (the transposed conv1)
    dy1_dev = device_ms(bwd, ("block1_dy1_kernel",))
    dx_dev = device_ms(bwd, ("block1_dx_kernel",))
    bwd_dev = (dy1_dev + dx_dev if isinstance(dy1_dev, float)
               and isinstance(dx_dev, float) else "not measured")
    check(B.bwd_setups() == bwd_setups
          and B.cached_bwd_layouts(k1, k2) is bwd_layouts,
          f"{name}: repeat backward calls rebuilt the layouts or set a "
          "kernel's attribute again")
    gb = [g.permute(2, 0, 1)[None].to(bf) for g in (g1, g2)]
    flops = 2.0 * h * w * 64 * (27 + 576)
    wbytes = 4.0 * (64 * 27 + 64 + 64 * 576 + 64)
    fwd_bytes = h * w * (3 + 2 * 64) * 4.0 + wbytes
    bwd_bytes = h * w * (4 * 64 + 3) * 4.0 + wbytes
    out = {
        "fwd": {"shape": [h, w], "max_abs_err": float(max(
                    (t1 - p1).abs().max(), (t2 - p2).abs().max())),
                "tap1_err": e1, "tap2_err": e2, "y1_flips": y1_flips,
                "tap1_err_vs_f64": vs64[0], "tap2_err_vs_f64": vs64[1],
                "ms": fwd_ms, "device_ms": fwd_dev,
                # the wrapper's host share: checks, layout lookup, outputs'
                # allocation and the launch
                "host_ms": (fwd_ms - fwd_dev if isinstance(fwd_dev, float)
                            else "not measured"),
                "plain_ms": time_ms(lambda: B.block1_plain(x, k1, b1, k2,
                                                           b2)),
                "library_ms": time_ms(lib_fwd),
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(flops, fwd_bytes, rates, "bf16")))},
        "bwd": {"shape": [h, w], "max_abs_err": float((dx - pdx).abs().max()),
                "dx_err": edx, "dx_err_vs_f64": vs64[2],
                "ms": bwd_ms, "device_ms": bwd_dev,
                "dy1_device_ms": dy1_dev, "dx_device_ms": dx_dev,
                "host_ms": (bwd_ms - bwd_dev if isinstance(bwd_dev, float)
                            else "not measured"),
                "plain_ms": time_ms(lambda: B.block1_bwd_plain(
                    t1, t2, g1, g2, k1, k2)),
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    (ly1, ly2), [xb], gb, retain_graph=True)),
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(flops, bwd_bytes, rates, "bf16")))},
    }
    emit({"phase": "kernel", "name": "block1", **out})
    return out


def check_block1_batch(b, h, w, seed, rates):
    """K3a and K3b over a pair axis: B images of (H, W) in one launch a
    direction. Each image's taps and dx must be bitwise equal to its own
    one-image launch (the tile walk crosses from image to image, and the
    next tile's prefetch reads the next image), and the batch is held to
    the plain version at check_block1's limits. Times the batched launch
    against B one-image launches."""
    import torch

    from strotss_torch.models.weights import random_params
    from strotss_torch.ops.kernels import block1 as B

    p = random_params("16", seed)
    k1 = p["block1_conv1"]["kernel"].cuda()
    k2 = p["block1_conv2"]["kernel"].cuda()
    b1 = 0.1 * _inputs(seed + 1, (64,))
    b2 = 0.1 * _inputs(seed + 2, (64,))
    x = _inputs(seed + 3, (b, h, w, 3))
    g1 = _inputs(seed + 4, (b, h, w, 64))
    g2 = _inputs(seed + 5, (b, h, w, 64))
    name = f"block1 {b}x{h}x{w}"

    before = _launches()
    t1, t2 = B.block1_fwd(x, k1, b1, k2, b2)
    dx = B.block1_bwd(t1, t2, g1, g2, k1, k2)
    made = _launches(before)
    check((made["block1_fwd"], made["block1_bwd"]) == (1, 1),
          f"{name}: a batch must be one launch a direction")
    for i in range(b):
        o1, o2 = B.block1_fwd(x[i], k1, b1, k2, b2)
        odx = B.block1_bwd(t1[i], t2[i], g1[i], g2[i], k1, k2)
        check(torch.equal(t1[i], o1) and torch.equal(t2[i], o2)
              and torch.equal(dx[i], odx),
              f"{name}: image {i} differs from its one-image launch")
    p1, p2 = B.block1_plain(x, k1, b1, k2, b2)
    pdx = B.block1_bwd_plain(t1, t2, g1, g2, k1, k2)
    e1, e2, edx = _grad_err(t1, p1), _grad_err(t2, p2), _grad_err(dx, pdx)
    check(e1 <= 1e-5 and e2 <= 1e-3 and edx <= 1e-3,
          f"{name}: errors against the plain version (of max|ref|) tap1 "
          f"{e1}, tap2 {e2}, dx {edx}")

    def singles_fwd():
        for i in range(b):
            B.block1_fwd(x[i], k1, b1, k2, b2)

    def singles_bwd():
        for i in range(b):
            B.block1_bwd(t1[i], t2[i], g1[i], g2[i], k1, k2)

    def bwd():
        return B.block1_bwd(t1, t2, g1, g2, k1, k2)

    # yardstick: cuDNN on the same batch, two bf16 F.conv2d + bias + ReLU
    # and their autograd backward
    import torch.nn.functional as F

    bf = torch.bfloat16
    xb = x.permute(0, 3, 1, 2).to(bf).requires_grad_(True)
    kb1, kb2, bb1, bb2 = (t.to(bf) for t in (k1, k2, b1, b2))

    def lib_fwd():
        y1 = torch.relu(F.conv2d(xb, kb1, bb1, padding=1))
        return y1, torch.relu(F.conv2d(y1, kb2, bb2, padding=1))

    ly1, ly2 = lib_fwd()
    gb = [g.permute(0, 3, 1, 2).to(bf) for g in (g1, g2)]

    flops = 2.0 * b * h * w * 64 * (27 + 576)
    wbytes = 4.0 * (64 * 27 + 64 + 64 * 576 + 64)
    fwd_bytes = b * h * w * (3 + 2 * 64) * 4.0 + wbytes
    bwd_bytes = b * h * w * (4 * 64 + 3) * 4.0 + wbytes
    dy1_dev = device_ms(bwd, ("block1_dy1_kernel",))
    dx_dev = device_ms(bwd, ("block1_dx_kernel",))
    out = {
        "fwd": {"shape": [b, h, w], "tap1_err": e1, "tap2_err": e2,
                "max_abs_err": float(max((t1 - p1).abs().max(),
                                         (t2 - p2).abs().max())),
                "ms": time_ms(lambda: B.block1_fwd(x, k1, b1, k2, b2)),
                "device_ms": device_ms(lambda: B.block1_fwd(x, k1, b1, k2,
                                                            b2),
                                       ("block1_fwd_kernel",)),
                "singles_ms": time_ms(singles_fwd),
                "plain_ms": time_ms(lambda: B.block1_plain(x, k1, b1, k2,
                                                           b2)),
                "library_ms": time_ms(lib_fwd),
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(flops, fwd_bytes, rates, "bf16")))},
        "bwd": {"shape": [b, h, w], "dx_err": edx,
                "max_abs_err": float((dx - pdx).abs().max()),
                "ms": time_ms(bwd),
                "device_ms": (dy1_dev + dx_dev if isinstance(dy1_dev, float)
                              and isinstance(dx_dev, float)
                              else "not measured"),
                "singles_ms": time_ms(singles_bwd),
                "plain_ms": time_ms(lambda: B.block1_bwd_plain(
                    t1, t2, g1, g2, k1, k2)),
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    (ly1, ly2), [xb], gb, retain_graph=True)),
                **dict(zip(("bound_ms", "bound_by"),
                           bound_ms(flops, bwd_bytes, rates, "bf16")))},
    }
    emit({"phase": "kernel", "name": "block1_batch", **out})
    return out


def _sinkhorn_rows(seed, n, m, c, distance):
    """x (n, c) and y (m, c) for a Sinkhorn check. Cosine: y_j = a_j
    x_pi(j) + sqrt(1 - a_j^2) e_j with a_j uniform in [-1, 1], so matched
    pairs span every distance from 0 to 2 and lam * d spans 0 to 20 at
    lam = 10. C = 3 ('both' on YUV): positive uniform rows, as in the REMD
    check. Otherwise independent normal rows (lam * d ~ 24 for 'both');
    near-duplicate rows there would measure the float32 cancellation of
    the L2 expansion, not the kernel."""
    import torch

    if c == 3 or distance != "cosine":
        return (_inputs(seed, (n, c), positive=(c == 3)),
                _inputs(seed + 1, (m, c), positive=(c == 3)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c))
    a = rng.uniform(-1.0, 1.0, (m, 1))
    y = a * x[rng.integers(0, n, m)] + np.sqrt(1 - a * a) * (
        rng.standard_normal((m, c)))
    return (torch.tensor(x, dtype=torch.float32, device="cuda"),
            torch.tensor(y, dtype=torch.float32, device="cuda"))


def _lse64(x, y, logv, lam, distance, rows=2048):
    """LSE_j(-lam d_ij + logv_j) in float64, ``rows`` rows at a time."""
    import torch

    return torch.cat([torch.logsumexp(
        -lam * _dist64(x[i:i + rows], y, distance) + logv.double()[None, :],
        dim=1) for i in range(0, x.shape[0], rows)])


def check_lse(n, m, c, distance, seed, rates, reps, prep_check=False):
    """K4 against its plain version at one shape, lam = 10, logv spanning
    tens of units, the operands prepared once as a solve prepares them
    (``prep_check``: the preparation kernel held to ``prepare_plain``);
    returns measurements. ``library_ms`` times one PyTorch call of the
    same function that the port never makes: logsumexp over the
    materialized distances, x and y normalized beforehand, TF32 off."""
    import torch

    from strotss_torch.ops.kernels import sinkhorn

    lam = 10.0
    x, y = _sinkhorn_rows(seed, n, m, c, distance)
    logv = 5.0 * _inputs(seed + 2, (m,))
    prep = sinkhorn.prepare(x, y)
    if prep_check:
        for got, want in zip(prep, (sinkhorn.prepare_plain(x),
                                    sinkhorn.prepare_plain(y))):
            check(torch.equal(got.parts, want.parts),
                  f"sinkhorn_prep {n}x{m}x{c}: parts differ from the plain "
                  "layout")
            check(_grad_err(got.norms, want.norms) <= 1e-6,
                  f"sinkhorn_prep {n}x{m}x{c}: norms "
                  f"{_grad_err(got.norms, want.norms)} of max from plain")
            del want

    def call():
        return sinkhorn.lse_pass(x, y, logv, lam, distance, prep)

    out = call()
    check(torch.equal(out, call()),
          f"sinkhorn_lse {n}x{m}x{c}: two runs differ")
    check(torch.equal(out, sinkhorn.lse_pass(x, y, logv, lam, distance)),
          f"sinkhorn_lse {n}x{m}x{c}: the prepared operands give other bits "
          "than a call that prepares its own")
    plain = sinkhorn.lse_pass_plain(x, y, logv, lam, distance)
    ref = _lse64(x, y, logv, lam, distance)
    # 1e-5 of max|out| against the plain version (float32 sums in another
    # order), or, where the distance is ill-conditioned in float32 ('both'
    # at C = 3), no further from float64 than twice the plain version
    err, err64, plain64 = (_grad_err(a, b) for a, b in
                           ((out, plain), (out, ref), (plain, ref)))
    check(err <= 1e-5 or err64 <= max(1e-5, 2.0 * plain64),
          f"sinkhorn_lse {n}x{m}x{c} {distance}: err {err} of max|out| "
          f"(vs float64 {err64}, plain float32 vs float64 {plain64})")
    del ref
    torch.cuda.empty_cache()
    ms = time_ms(call, reps, 1)
    dev_ms = device_ms(call, ("sinkhorn_lse_", "sinkhorn_combine"),
                       min(reps, 20))
    prep_ms = time_ms(lambda: sinkhorn.prepare(x, y), reps, 1)
    plain_ms = time_ms(lambda: sinkhorn.lse_pass_plain(x, y, logv, lam,
                                                       distance), reps, 1)
    torch.cuda.empty_cache()
    xn = x * torch.rsqrt((x * x).sum(1, keepdim=True).clamp(min=1e-12))
    yn = y * torch.rsqrt((y * y).sum(1, keepdim=True).clamp(min=1e-12))
    scale = 1.0 / c ** 0.5

    def lib():
        d = 0.0
        if distance != "l2":
            d = 1.0 - xn @ yn.T
        if distance != "cosine":
            d = d + torch.cdist(x, y) * scale
        return torch.logsumexp(logv[None, :] - lam * d, 1)

    library_ms = time_ms(lib, reps, 1)
    del xn, yn
    torch.cuda.empty_cache()
    # one dot product of length C per pair serves both distances of
    # 'both'; per pair about 8 more operations (distance, z, max, sum) and
    # one expf, plus one sqrtf for the L2 part. On the tensor-core route
    # each product is three TF32 products.
    route = sinkhorn.route(c)
    flops = 2.0 * n * m * c + 8.0 * n * m
    sfu = float(n) * m * (1 if distance == "cosine" else 2)
    nbytes = 4.0 * (n * c + m * c + m + n)
    fp32_ms, fp32_by = bound_ms(flops, nbytes, rates)
    times = {"fp32": fp32_ms, "sfu": sfu / rates["sfu"] * 1e3}
    if route == "tensor_cores":
        times = {"3xtf32": 6.0 * n * m * c / rates["tf32"] * 1e3,
                 "fp32": 8.0 * n * m / rates["fp32"] * 1e3,
                 "sfu": times["sfu"]}
    kind = max(times, key=times.get)
    b_ms, b_by = times[kind], "operations"
    if fp32_by == "bytes" and fp32_ms > b_ms:
        b_ms, b_by, kind = fp32_ms, "bytes", "bytes"
    res = {"shape": [n, m, c], "distance": distance, "route_taken": route,
           "split": sinkhorn.lse_split(n, m, c,
                                       torch.cuda.get_device_properties(0)
                                       .multi_processor_count),
           "max_abs_err": float((out - plain).abs().max()),
           "err_of_max": err, "err_of_max_vs_f64": err64,
           "plain_err_of_max_vs_f64": plain64, "ms": ms, "device_ms": dev_ms,
           "prep_ms": prep_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bound_ops": kind,
           "bound_fp32_cores_ms": max(fp32_ms, times["sfu"])}
    emit({"phase": "kernel", "name": "sinkhorn_lse", **res})
    return res


def check_streamed(n, c, distance, seed):
    """The streamed Sinkhorn loss (K4, 60 launches) and its Danskin
    gradient against the plain materialized path at N = M = n, lam = 10,
    30 iterations: the loss to rtol 1e-4 (the JAX package's tolerance for
    its compiled streamed kernel against XLA), the gradient to 1e-4 of
    max|g| against the gradient of the plain read-out with its plan held
    fixed. The cosine with the plain path's unrolled gradient is reported,
    not checked (~0.9 is expected: the estimators differ)."""
    import torch

    from strotss_torch.ops import losses

    lam, iters = 10.0, 30
    x, y = _sinkhorn_rows(seed, n, n, c, distance)
    yk = y.clone().requires_grad_(True)
    before = _launches()
    val = losses.sinkhorn(x, yk, distance, lam, iters, impl="kernel")
    (gk,) = torch.autograd.grad(val, [yk])
    made = _launches(before)
    launches, preps = made["sinkhorn_lse"], made["sinkhorn_prep"]
    yp = y.clone().requires_grad_(True)
    plain = losses.sinkhorn(x, yp, distance, lam, iters, impl="plain")
    (gu,) = torch.autograd.grad(plain, [yp])
    # the plain path's potentials, then its read-out with the plan frozen
    d = losses.dist_metrics[distance](x, y)
    log_k = -lam * d
    log_u, log_v = torch.zeros_like(d[:, 0]), torch.zeros_like(d[0])
    log_p = torch.full_like(log_u, -float(np.log(n)))
    for _ in range(iters):
        log_u = log_p - torch.logsumexp(log_k + log_v[None, :], dim=1)
        log_v = log_p - torch.logsumexp(log_k + log_u[:, None], dim=0)
    yf = y.clone().requires_grad_(True)
    df = losses.dist_metrics[distance](x, yf)
    t = torch.exp(log_u[:, None] - lam * d + log_v[None, :])
    (gf,) = torch.autograd.grad(torch.sum(t * df), [yf])
    val, plain = float(val.detach()), float(plain.detach())
    rel = abs(val - plain) / abs(plain)
    gerr = _grad_err(gk, gf)
    cos = float(torch.nn.functional.cosine_similarity(
        gk.double().flatten(), gu.double().flatten(), dim=0))
    res = {"n": n, "c": c, "distance": distance, "launches": launches,
           "prep_launches": preps, "loss": val, "plain_loss": plain,
           "rel_err": rel,
           "grad_err_vs_frozen_plan": gerr, "cos_vs_unrolled_grad": cos}
    emit({"phase": "kernel", "name": "sinkhorn_streamed", **res})
    check(launches == 2 * iters and preps == 1,
          f"sinkhorn_streamed: {launches} launches, {preps} preparations")
    check(rel <= 1e-4, f"sinkhorn_streamed {distance}: loss rel err {rel}")
    check(gerr <= 1e-4, f"sinkhorn_streamed {distance}: grad err {gerr}")
    return res


def phase_kernels(rates):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    remd_main = check_remd(1024, 1024, 2179, "cosine", 1, rates)
    remd_yuv = check_remd(1024, 1024, 3, "both", 3, rates)
    check_remd(1000, 777, 2179, "both", 5, rates)
    check(remd_main["route_taken"] == "tensor_cores"
          and remd_yuv["route_taken"] == "cuda_cores",
          f"remd_mins routes: {remd_main['route_taken']} at C = 2179, "
          f"{remd_yuv['route_taken']} at C = 3")
    ss_main = check_selfsim(1024, 2179, 7, rates)
    check_selfsim(1000, 2179, 9, rates)
    # K2a with 2 blocks a tile pair (1024 and 1000 take 4; 32769 takes 1)
    ss_1500 = check_selfsim(1500, 2179, 29, rates, reps=10)
    check(ss_main["fwd"]["split"] == 4 and ss_1500["fwd"]["split"] == 2,
          f"selfsim_fwd splits: {ss_main['fwd']['split']} at N = 1024, "
          f"{ss_1500['fwd']['split']} at N = 1500")
    # the 512 px content and style scales, and the smallest content scale
    b1_main = check_block1(384, 512, 11, rates)
    check_block1(512, 398, 13, rates)
    check_block1(48, 64, 15, rates)
    check_block1(5, 7, 16, rates)  # smaller than one of K3a's tiles
    # the pair axis: the batch phase's first and last content scales, and
    # a batch of images each smaller than one tile
    b1_batch = {"b8_48x64": check_block1_batch(8, 48, 64, 33, rates),
                "b8_384x512": check_block1_batch(8, 384, 512, 35, rates)}
    check_block1_batch(3, 5, 7, 37, rates)
    # the --sinkhorn path above the memory gate: N = M = 32769 for the
    # feature term (C = 2179) and the YUV term (C = 3); a ragged shape
    lse_main = check_lse(32769, 32769, 2179, "cosine", 17, rates, reps=3,
                         prep_check=True)
    lse_yuv = check_lse(32769, 32769, 3, "both", 19, rates, reps=5,
                        prep_check=True)
    lse_ragged = check_lse(4099, 3001, 2179, "both", 21, rates, reps=10)
    # just above the route threshold (C = 32)
    lse_35 = check_lse(4099, 3001, 35, "cosine", 22, rates, reps=10)
    check([r["route_taken"] for r in (lse_main, lse_yuv, lse_ragged, lse_35)]
          == ["tensor_cores", "cuda_cores", "tensor_cores", "tensor_cores"],
          "sinkhorn_lse routes by C")
    check_streamed(4096, 2179, "cosine", 23)
    check_streamed(4096, 3, "both", 25)
    # self-similarity at the path's N = 32769, its first run above 1024
    ss_big = check_selfsim(32769, 2179, 27, rates, reps=2, exact=True)
    check(ss_big["fwd"]["split"] == 1,
          f"selfsim_fwd split at N = 32769: {ss_big['fwd']['split']}")
    torch.cuda.empty_cache()
    return {"remd_mins": (remd_main, remd_yuv), "selfsim": ss_main,
            "selfsim_32769": ss_big, "block1": b1_main,
            "block1_batch": b1_batch,
            "sinkhorn_lse": (lse_main, lse_yuv)}


#: the 512 px scale's hypercolumn as the default run samples it: the image
#: and block1's taps NHWC float32, blocks 2-5 NHWC views of NCHW bf16 maps
#: (h, w, C, bf16 and NCHW-backed)
_K5_MAPS = ((384, 512, 3, False), (384, 512, 64, False),
            (384, 512, 64, False), (192, 256, 128, True),
            (192, 256, 128, True), (96, 128, 256, True), (96, 128, 256, True),
            (96, 128, 256, True), (48, 64, 512, True), (24, 32, 512, True))
#: K5's kernels, by the names a profile gives them
_K5_KERNELS = ("gather_fwd_kernel", "gather_sort_kernel",
               "gather_acc_kernel")


def _k5_maps(seed: int):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    maps = []
    for h, w, c, low in _K5_MAPS:
        if low:
            m = torch.randn(1, c, h, w, generator=gen, device="cuda")
            maps.append(m.to(torch.bfloat16).permute(0, 2, 3, 1))
        else:
            maps.append(torch.randn(1, h, w, c, generator=gen,
                                    device="cuda"))
    return maps


def _k5_grads_hold(coords, ys, g, grads, name):
    """Each map's gradient bit for bit its mirror's, and within
    ``gather.sum_bound`` of the float64 gradient (one unit in the last
    place of the map's dtype plus float32's summation bound); returns the
    largest error in units of that bound, the plain route's, and K5's
    largest absolute error."""
    import torch

    from strotss_torch.ops import sampling
    from strotss_torch.ops.kernels import gather

    side = sampling._side(ys, True, True)
    y64 = [y.detach().double().requires_grad_() for y in ys]
    rows64 = sampling.sample_hypercolumn(y64, coords, True, True)
    want = torch.autograd.grad(rows64, y64, g.double(), retain_graph=True)
    mags = torch.autograd.grad(rows64, y64, g.double().abs())
    plain = torch.autograd.grad(
        sampling.sample_hypercolumn(ys, coords, True, True), ys, g)
    worst, worst_plain, abs_err, col = 0.0, 0.0, 0.0, 0
    for y, got, pl, w64, a64, fac, near in zip(ys, grads, plain, want, mags,
                                               side.factors, side.nearest):
        h, w, c = y.shape[-3:]
        mirror = gather.grad_mirror(g[:, col:col + c].contiguous(), coords,
                                    (h, w, c), fac, near, y.dtype)
        check(torch.equal(got.reshape(h, w, c), mirror),
              f"{name}: map {col}:{col + c} differs from its mirror")
        bound = gather.sum_bound(
            w64.reshape(h, w, c), a64.reshape(h, w, c),
            gather.term_counts(coords, (h, w, c), fac, near), y.dtype)
        for grad, acc in ((got, "k"), (pl, "p")):
            err = (grad.reshape(h, w, c).double() - w64.reshape(h, w, c))
            ratio = (err.abs() / bound.clamp_min(1e-300)).max().item()
            ratio = 0.0 if ratio != ratio else ratio
            if acc == "k":
                worst = max(worst, ratio)
                abs_err = max(abs_err, err.abs().max().item())
            else:
                worst_plain = max(worst_plain, ratio)
        col += c
    check(worst <= 1.0, f"{name}: a gradient lies {worst} bounds from the "
          "float64 one")
    return worst, worst_plain, abs_err


def phase_gather(rates):
    """K5 at the main path's 512 px scale (the 10 maps of VGG16's default
    taps in their layouts, 1024 samples): the rows of both sides bit for
    bit the plain route's in one launch, the style targets likewise; each
    map's gradient bit for bit its mirror and within one unit in the last
    place (plus float32's summation bound) of the float64 gradient,
    bitwise the same in a second call, two launches; n = 32769 likewise
    against the mirror. Then the times of the forward, the backward and
    both against the plain route's, and the host time of the wrapper's
    map table built anew against its cached plan. Returns the kernels
    line's ``fwd`` and ``bwd`` entries."""
    import torch

    from strotss_torch.ops import sampling

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    xs = _k5_maps(1)
    ys = [m.requires_grad_() for m in _k5_maps(2)]
    coords = sampling.strided_grid_coords(gen, (384, 512), 1024, dev)
    g = torch.randn(1024, 2179, generator=gen, device=dev)
    before = _launches()
    rows = sampling.sample_paired(coords, xs, ys, "kernel")
    grads = torch.autograd.grad(rows[1], ys, g)
    torch.cuda.synchronize()
    launches = _launches(before)
    check(launches == {**dict.fromkeys(KERNELS, 0), **_k5_want(1, 0)},
          f"gather: launches {launches} for one call and its backward")
    want = sampling.sample_paired(coords, xs, ys, "plain")
    check(torch.equal(rows[0], want[0]) and torch.equal(rows[1], want[1]),
          "gather: rows differ from the plain route's")
    full = sampling.full_grid_coords(gen, (384, 512), 1024, dev)
    check(torch.equal(sampling.sample_style(full, ys, "kernel"),
                      sampling.sample_style(full, ys, "plain")),
          "gather: style rows differ from the plain route's")
    again = torch.autograd.grad(
        sampling.sample_paired(coords, xs, ys, "kernel")[1], ys, g)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "gather: two backward calls differ")
    ulps, ulps_plain, abs_err = _k5_grads_hold(coords, ys, g, grads,
                                               "gather")
    big = sampling.strided_grid_coords(gen, (384, 512), 32769, dev)
    g_big = torch.randn(32769, 2179, generator=gen, device=dev)
    rows_big = sampling.sample_paired(big, xs, ys, "kernel")
    want_big = sampling.sample_paired(big, xs, ys, "plain")
    check(torch.equal(rows_big[0], want_big[0])
          and torch.equal(rows_big[1], want_big[1]),
          "gather n=32769: rows differ from the plain route's")
    ulps_big, _, _ = _k5_grads_hold(big, ys, g_big, torch.autograd.grad(
        rows_big[1], ys, g_big), "gather n=32769")
    del rows_big, want_big

    def step(impl):
        def fn():
            r = sampling.sample_paired(coords, xs, ys, impl)
            torch.autograd.grad(r[1], ys, g)
        return fn

    def forward(impl):
        def fn():
            with torch.no_grad():
                sampling.sample_paired(coords, xs, ys, impl)
        return fn

    def backward(impl):
        r = sampling.sample_paired(coords, xs, ys, impl)[1]
        return lambda: torch.autograd.grad(r, ys, g, retain_graph=True)

    def host_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return ms

    # the least traffic: each side's rows written; a float32 map (factor
    # 1, nearest) read a row a sample, a bf16 map four corner rows a
    # sample, and no map more than once whole
    nbytes_fwd = 2 * (1024 * 2179 * 4 + sum(
        min(h * w, 4 * 1024) * c * 2 if low else min(h * w, 1024) * c * 4
        for h, w, c, low in _K5_MAPS))
    # the cotangent read and every map's dense gradient written
    nbytes_bwd = 1024 * 2179 * 4 + sum(h * w * c * (2 if low else 4)
                                       for h, w, c, low in _K5_MAPS)
    fwd, bwd = {"max_abs_err": 0.0}, {"max_abs_err": abs_err}
    for entry, fn, nbytes, kernels in (
            (fwd, forward, nbytes_fwd, _K5_KERNELS[:1]),
            (bwd, backward, nbytes_bwd, _K5_KERNELS[1:])):
        entry.update(ms=time_ms(fn("kernel")),
                     plain_ms=time_ms(fn("plain")),
                     host_ms=host_ms(fn("kernel")),
                     plain_host_ms=host_ms(fn("plain")),
                     device_ms=device_ms(step("kernel"), kernels),
                     library_ms=None)
        entry["bound_ms"], entry["bound_by"] = bound_ms(0, nbytes, rates)
    for name in _K5_KERNELS[1:]:
        bwd[name + "_device_ms"] = device_ms(step("kernel"), (name,))
    bwd.update(grad_err_in_bounds=ulps, plain_grad_err_in_bounds=ulps_plain,
               grad_err_in_bounds_n32769=ulps_big)
    both = {"ms": time_ms(step("kernel")), "plain_ms": time_ms(step("plain")),
            "host_ms": host_ms(step("kernel")),
            "plain_host_ms": host_ms(step("plain")),
            "device_ms": device_ms(step("kernel"), _K5_KERNELS)}
    both["bound_ms"], both["bound_by"] = bound_ms(
        0, nbytes_fwd + nbytes_bwd, rates)
    bwd["fwd_bwd"] = both
    fwd["table_host_us"] = _k5_table_us(xs, ys)
    emit({"phase": "gather", "launches": launches, "fwd": fwd, "bwd": bwd})
    return {"fwd": fwd, "bwd": bwd}


def _k5_table_us(xs, ys, reps=2000):
    """Host microseconds of the wrapper's set-up of one paired call: the
    sides' factors and lookups (``sampling._side``), and the map table
    with the backward's, made anew (``gather._Plan``) against the cached
    plan's hit (``gather._plan``)."""
    from strotss_torch.ops import sampling
    from strotss_torch.ops.kernels import gather

    def us(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    sides = [sampling._side(xs, True, True), sampling._side(ys, True, True)]
    dev = xs[0].get_device()
    need = tuple(range(len(xs), len(xs) + len(ys)))
    return {"sides": us(lambda: [sampling._side(f, True, True)
                                 for f in (xs, ys)]),
            "plan_cached": us(lambda: gather._plan(sides, dev)
                              .backward(need)),
            "plan_anew": us(lambda: gather._Plan(sides, dev)
                            .backward(need))}


def _smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """(1, h, w, 3) float32 in [0, 1]: random 16-px blocks smoothed by an
    18-px box blur, so the VGG features are not white noise."""
    rng = np.random.default_rng(seed)
    blocks = rng.random((h // 16 + 2, w // 16 + 2, 3))
    img = np.kron(blocks, np.ones((16, 16, 1)))[:h, :w]
    k = 9
    pad = np.pad(img, ((k, k), (k, k), (0, 0)), mode="edge")
    cs = pad.cumsum(0).cumsum(1)
    box = (cs[2 * k:, 2 * k:] - cs[:-2 * k, 2 * k:] - cs[2 * k:, :-2 * k]
           + cs[:-2 * k, :-2 * k]) / (2 * k) ** 2
    return box[None, :h, :w].astype(np.float32)


def phase_slice(vgg_params):
    """The 64 px scale for 10 steps, kernels against plain versions, from
    the same state and the same sample coordinates.

    Free-running trajectories cannot be held close: RMSprop's first
    updates are nearly sign(g) * 10 lr, so any rounding difference grows,
    and cuDNN's and the gathers' backward passes are not bitwise
    reproducible (the plain path run twice differs by ~2% in loss after
    10 bf16 steps). So each step is evaluated with the kernels and with
    the plain versions from the same pyramid and coordinates, and the run
    goes on with the kernels' gradient. The kernels' gradients are held
    to their plain versions in the kernel phase. Each step holds:

    - the plain losses on the kernel route's features to rtol 1e-3 (K1,
      K2a: float32 sums in another order);
    - the block1 taps of the kernel and of its plain version to 1e-5
      (tap1) and 1e-3 (tap2) of their largest values, as in the kernel
      phase;
    - the all-plain loss to rtol 2^-8. Blocks 2-5 run in bf16, so where
      block1's rounding flips an entry of tap2 by one bf16 step, the deep
      taps differ by one bf16 step in some entries (3e-3 to 5e-3 of their
      largest values at the 64 px scale) and the loss moves by up to ~5e-4
      (the cuDNN route differs from the kernel route by as much).
    """
    import torch

    import strotss_torch
    from strotss_torch import programs, solve
    from strotss_torch.models.vgg import VGG
    from strotss_torch.ops import sampling
    from strotss_torch.ops.image import fold_laplacian_pyramid
    from strotss_torch.ops.losses import moment_stats

    content = _smooth_image(480, 640, 11)
    style = _smooth_image(720, 560, 12)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=10)
    spec_k = programs.spec_from_config(cfg, "cuda")
    spec_p = spec_k._replace(remd_impl="plain", selfsim_impl="plain",
                             block1_impl="plain")
    check(spec_k.block1_impl == "pallas",
          f"slice: block1 route {spec_k.block1_impl!r}, want 'pallas'")
    programs.set_precision(spec_k)
    # The plain block1 runs float32 convolutions on bf16-rounded operands:
    # exact products only without TF32, whose Winograd-type algorithms
    # round transformed operands (the kernel route uses no cuDNN there).
    torch.backends.cudnn.allow_tf32 = False
    c = torch.tensor(content, device="cuda")
    s = torch.tensor(style, device="cuda")
    mode, chw, shw = solve.scale_mode_shapes(cfg, c.shape, s.shape, 0, 64)
    params = {k: {n: t.cuda() for n, t in p.items()}
              for k, p in vgg_params.items()}
    vgg, vgg_p, vgg_x = (VGG(params, taps=spec_k.taps,
                             compute_dtype=spec_k.compute_dtype,
                             block1_impl=b1)
                         for b1 in (spec_k.block1_impl, "plain", "xla"))
    n = cfg.sample_size
    with torch.no_grad():
        scl_c, scl_s, pyramid = programs.scale_seed(
            mode, chw, shw, cfg.pyramid_levels, c, s, None)
        content_feats = programs.extract_hypercolumn(vgg, scl_c)
        targets = sampling.sample_style(
            sampling.full_grid_coords(gen, shw, n, "cuda"),
            programs.extract_hypercolumn(vgg, scl_s))[None]
        moments = [moment_stats(targets[0])]
    pyramid = [p.contiguous() for p in pyramid]
    opt = programs.RMSprop(pyramid, cfg.lr)
    alpha = cfg.initial_alpha()
    err = {k: [] for k in ("loss_rel_err", "losses_rel_err", "tap1_err",
                           "tap2_err", "deep_taps_err",
                           "cudnn_route_loss_rel_err")}
    forced = []
    for t in range(cfg.max_iter):
        step_coords = sampling.strided_grid_coords(gen, chw, n, "cuda")[None]
        leaves = [p.requires_grad_(True) for p in pyramid]
        pred = programs.extract_hypercolumn(vgg,
                                            fold_laplacian_pyramid(leaves))
        loss, _, _ = programs.step_losses(spec_k, content_feats, pred,
                                          targets, moments, alpha,
                                          step_coords)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            plain_losses, _, _ = programs.step_losses(
                spec_p, content_feats, pred, targets, moments, alpha,
                step_coords)
            pred_p = programs.extract_hypercolumn(
                vgg_p, fold_laplacian_pyramid(pyramid))
            plain, _, _ = programs.step_losses(spec_p, content_feats, pred_p,
                                               targets, moments, alpha,
                                               step_coords)
            # yardstick, not checked: block1 on cuDNN (no TF32 here)
            cudnn, _, _ = programs.step_losses(
                spec_k, content_feats, programs.extract_hypercolumn(
                    vgg_x, fold_laplacian_pyramid(pyramid)),
                targets, moments, alpha, step_coords)
        lk = float(loss.detach())
        forced.append(lk)
        err["loss_rel_err"].append(abs(lk - float(plain)) / abs(float(plain)))
        err["losses_rel_err"].append(abs(lk - float(plain_losses))
                                     / abs(float(plain_losses)))
        err["tap1_err"].append(_grad_err(pred[1].detach(), pred_p[1]))
        err["tap2_err"].append(_grad_err(pred[2].detach(), pred_p[2]))
        err["deep_taps_err"].append(max(_grad_err(a.detach(), b) for a, b
                                        in zip(pred[3:], pred_p[3:])))
        err["cudnn_route_loss_rel_err"].append(abs(lk - float(cudnn))
                                               / abs(lk))
        opt.step(grads)

    emit({"phase": "slice", "scale": 64, "steps": cfg.max_iter,
          "loss": forced, **err})
    check(bool(np.all(np.isfinite(forced))), "slice: non-finite loss")
    limits = {"loss_rel_err": 2.0 ** -8, "losses_rel_err": 1e-3,
              "tap1_err": 1e-5, "tap2_err": 1e-3}
    for k, limit in limits.items():
        check(max(err[k]) <= limit,
              f"slice: {k} {max(err[k])} > {limit} at the same state")


#: the kernels whose wrappers count their launches (``launch.<name>``),
#: by the kernel's name in the kernels line
KERNELS = ("remd_mins", "selfsim_fwd", "selfsim_bwd", "block1_fwd",
           "block1_bwd", "sinkhorn_lse", "sinkhorn_prep", "gather_fwd",
           "gather_bwd")


def _k5_want(paired: int, style: int) -> dict:
    """K5's launches in a run of ``paired`` ``sample_paired`` calls (one a
    region a pair a step), each with its backward's two launches, and
    ``style`` style-target calls (one a region, or a style, a pair a
    scale; no backward)."""
    return {"gather_fwd": paired + style, "gather_bwd": 2 * paired}


def _launches(since=None):
    """Each kernel's launches so far, less those of ``since`` (an earlier
    reading)."""
    from strotss_torch.utils import timing

    now = timing.counters()
    return {k: now.get("launch." + k, 0) - (since or {}).get(k, 0)
            for k in KERNELS}


def _unlaunch(saved):
    """Set the launch counters back to ``saved`` (an earlier reading), so
    that a check's own launches do not count."""
    from strotss_torch.utils import timing

    for k, n in _launches(saved).items():
        timing.count("launch." + k, -n)


def _run_counted(content, style, cfg, **kw):
    """One stylization through strotss_torch.stylize (``kw``: its keyword
    arguments: region masks, style weights, a warm start, a progress
    callback), weights resolved as a user's run resolves them (on a machine
    without pretrained weights: the seeded random init, with a warning),
    with every launch count set to 0 just before and read just after.
    Returns (image, info, launches, summary)."""
    import torch

    import strotss_torch

    before = _launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, info = strotss_torch.stylize(content, style, cfg, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(before)
    summary = {"content": list(content.shape),
               "style": ([list(x.shape) for x in style]
                         if isinstance(style, list) else list(style.shape)),
               "output": list(img.shape), "seconds": seconds,
               "stylize_seconds": info["seconds"],
               "scales": [{"scale": s["scale"], "seconds": s["seconds"],
                           "first_loss": float(s["curve"][0, 0]),
                           "last_loss": float(s["curve"][-1, 0])}
                          for s in info["scales"]],
               "launches": launches,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    return img, info, launches, summary


def _check_curves(name, info, falls):
    for s in info["scales"]:
        check(bool(np.all(np.isfinite(s["curve"]))),
              f"{name}: non-finite loss at scale {s['scale']}")
        if falls:
            check(s["curve"][-1, 0] < s["curve"][0, 0],
                  f"{name}: scale {s['scale']} loss did not fall")


def phase_main():
    """The default stylization through strotss_torch.stylize."""
    import torch

    import strotss_torch

    cfg = strotss_torch.StrotssConfig()
    img, info, launches, summary = _run_counted(
        _smooth_image(480, 640, 21), _smooth_image(720, 560, 22), cfg)
    steps = cfg.levels * cfg.max_iter
    emit({"phase": "main", "config": "StrotssConfig() defaults: VGG16, 9 "
          "taps (2179 channels), 1024 samples, 4 scales to 512 px, "
          "bfloat16 policy", "max_iter": cfg.max_iter, "steps": steps,
          **summary})
    _check_curves("main", info, falls=True)
    check(img.dtype == torch.uint8 and tuple(img.shape) == (384, 512, 3),
          f"main: output {img.dtype} {tuple(img.shape)}, want uint8 "
          "(384, 512, 3)")
    # block1's forward also runs once for the content and once for the
    # style at each scale
    want = {"remd_mins": 2 * steps, "selfsim_fwd": steps,
            "selfsim_bwd": steps, "block1_fwd": steps + 2 * cfg.levels,
            "block1_bwd": steps, "sinkhorn_lse": 0, "sinkhorn_prep": 0,
            **_k5_want(steps, cfg.levels)}
    check(launches == want, f"main: launches {launches}, want {want}")
    return launches, info


def phase_sinkhorn(cosine_pass_ms):
    """The --sinkhorn path through strotss_torch.stylize, on both sides of
    the memory gate N * M = 2**30.

    (a) BASELINE config 5 (1024 px, Sinkhorn, more samples) at reduced
    depth: 5 scales to 1024 px, 2048 samples, 10 steps a scale. Plain
    materialized Sinkhorn with the unrolled gradient; K4 is not launched.
    (b) 32769 samples, just above the gate: one step a scale at full
    width (VGG16, 9 taps, 2179 channels, 30 iterations), every
    half-update through K4 (2 terms x 30 iterations x 2 passes a step),
    the Danskin gradient. 4 scales, or 2 if one cosine pass takes more
    than 0.4 s. The first step's style loss is held to the plain
    materialized loss on the same features at rtol 1e-4.
    """
    import torch

    import strotss_torch
    from strotss_torch import programs
    from strotss_torch.ops.image import resize_max_hw
    from strotss_torch.ops.losses import style_loss

    cfg_a = strotss_torch.StrotssConfig(use_sinkhorn=True, levels=5,
                                        max_size=1024, sample_size=2048,
                                        max_iter=10)
    img, info, launches, summary = _run_counted(
        _smooth_image(768, 1024, 41), _smooth_image(1024, 800, 42), cfg_a)
    emit({"phase": "sinkhorn", "run": "a", "config": "BASELINE config 5 at "
          "reduced depth: use_sinkhorn, 5 scales to 1024 px, 2048 samples, "
          "10 steps a scale, plain materialized Sinkhorn", **summary})
    _check_curves("sinkhorn (a)", info, falls=True)
    steps_a = cfg_a.levels * cfg_a.max_iter
    check(launches["sinkhorn_lse"] == 0 and launches["sinkhorn_prep"] == 0
          and launches["remd_mins"] == 0
          and {k: launches[k] for k in ("gather_fwd", "gather_bwd")}
          == _k5_want(steps_a, cfg_a.levels),
          f"sinkhorn (a): launches {launches}, want no sinkhorn_lse, "
          f"sinkhorn_prep or remd_mins, K5 {_k5_want(steps_a, cfg_a.levels)}")
    check(img.dtype == torch.uint8 and max(img.shape[:2]) == 1024,
          f"sinkhorn (a): output {img.dtype} {tuple(img.shape)}")

    cfg_b = strotss_torch.StrotssConfig(
        use_sinkhorn=True, sample_size=32769, max_iter=1,
        levels=4 if cosine_pass_ms <= 400 else 2)
    content = _smooth_image(480, 640, 43)
    style = _smooth_image(720, 560, 44)
    first = {}

    def recording_style_loss(target, prediction, alpha, **kw):
        out = style_loss(target, prediction, alpha, **kw)
        if not first:
            first.update(args=(target.detach().clone(),
                               prediction.detach().clone(), alpha),
                         kw=kw, loss=float(out.detach()))
        return out

    programs.style_loss = recording_style_loss
    try:
        img, info, launches, summary = _run_counted(content, style, cfg_b)
    finally:
        programs.style_loss = style_loss
    steps = cfg_b.levels * cfg_b.max_iter
    with torch.no_grad():
        plain = float(style_loss(*first["args"], **dict(
            first["kw"], remd_impl="plain")))
    rel = abs(first["loss"] - plain) / abs(plain)
    emit({"phase": "sinkhorn", "run": "b", "config": "use_sinkhorn, 32769 "
          f"samples, {cfg_b.levels} scales x 1 step, VGG16 9 taps, 30 "
          "iterations; streamed through K4", "levels": cfg_b.levels,
          "cosine_pass_ms": cosine_pass_ms,
          "first_style_loss": first["loss"], "plain_style_loss": plain,
          "style_loss_rel_err": rel, **summary})
    _check_curves("sinkhorn (b)", info, falls=False)
    want = {"remd_mins": 0, "selfsim_fwd": steps, "selfsim_bwd": steps,
            "block1_fwd": steps + 2 * cfg_b.levels, "block1_bwd": steps,
            "sinkhorn_lse": steps * 2 * cfg_b.sinkhorn_iters * 2,
            "sinkhorn_prep": steps * 2, **_k5_want(steps, cfg_b.levels)}
    check(launches == want, f"sinkhorn (b): launches {launches}, want {want}")
    hw = resize_max_hw(*content.shape[1:3], cfg_b.scale_sizes()[-1])
    check(img.dtype == torch.uint8 and tuple(img.shape) == (*hw, 3),
          f"sinkhorn (b): output {img.dtype} {tuple(img.shape)}, want "
          f"uint8 {(*hw, 3)}")
    check(rel <= 1e-4, f"sinkhorn (b): first style loss {first['loss']} "
          f"against plain {plain}, rel err {rel}")
    return launches


def _mask_pngs(tmp, content_hw, style_hw):
    """Two-colour mask images written as PNGs: the content's top half red
    and bottom half green, the style's left half red and right half
    green. Returns their paths."""
    from PIL import Image

    paths = []
    for name, (h, w), axis in (("content", content_hw, 0),
                               ("style", style_hw, 1)):
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 0] = 255
        second = (slice(h // 2, None), slice(None)) if axis == 0 else (
            slice(None), slice(w // 2, None))
        img[second] = (0, 255, 0)
        paths.append(f"{tmp}/{name}_mask.png")
        Image.fromarray(img).save(paths[-1])
    return paths


def _masked_step(vgg_params, content, style, cmasks_raw, smasks_raw):
    """One masked step at the 64 px scale of the full-width configuration,
    its losses with the kernels and with the plain versions from the same
    state: the same VGG features, region masks, targets and coordinates.
    The REMD and self-similarity routes compute the same function (float32
    sums in another order), so (loss, loss_c, loss_s) agree to rtol 1e-3,
    as in the slice phase. Returns the launches the kernel route made and
    the relative errors."""
    import torch

    import strotss_torch
    from strotss_torch import programs, solve
    from strotss_torch.models.vgg import VGG
    from strotss_torch.ops import sampling
    from strotss_torch.ops.image import fold_laplacian_pyramid
    from strotss_torch.ops.losses import moment_stats

    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=1)
    spec_k = programs.spec_from_config(cfg, "cuda", masked=True)
    spec_p = spec_k._replace(remd_impl="plain", selfsim_impl="plain")
    check((spec_k.remd_impl, spec_k.selfsim_impl) == ("auto", "auto"),
          f"masked: step routes {spec_k}")
    programs.set_precision(spec_k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c = torch.tensor(content, device="cuda")
    s = torch.tensor(style, device="cuda")
    mode, chw, shw = solve.scale_mode_shapes(cfg, c.shape, s.shape, 0, 64)
    params = {k: {n: t.cuda() for n, t in p.items()}
              for k, p in vgg_params.items()}
    vgg = VGG(params, taps=spec_k.taps, compute_dtype=spec_k.compute_dtype,
              block1_impl=spec_k.block1_impl)
    n = cfg.sample_size
    with torch.no_grad():
        scl_c, scl_s, pyramid = programs.scale_seed(
            mode, chw, shw, cfg.pyramid_levels, c, s, None)
        content_feats = programs.extract_hypercolumn(vgg, scl_c)
        style_feats = programs.extract_hypercolumn(vgg, scl_s)
        cmasks = [sampling.prepare_mask(m.cuda(), chw) for m in cmasks_raw]
        targets = torch.stack([sampling.sample_style(
            sampling.full_grid_coords(gen, shw, n, "cuda",
                                      mask=sampling.prepare_mask(m.cuda(),
                                                                 shw)),
            style_feats) for m in smasks_raw])
        moments = [moment_stats(t) for t in targets]
    coords = torch.stack([sampling.strided_grid_coords(gen, chw, n, "cuda",
                                                       mask=m)
                          for m in cmasks])
    leaves = [p.contiguous().requires_grad_(True) for p in pyramid]
    pred = programs.extract_hypercolumn(vgg, fold_laplacian_pyramid(leaves))
    before = _launches()
    got = programs.step_losses(spec_k, content_feats, pred, targets, moments,
                               cfg.initial_alpha(), coords)
    grads = torch.autograd.grad(got[0], leaves)
    launched = _launches(before)
    with torch.no_grad():
        want = programs.step_losses(spec_p, content_feats, pred, targets,
                                    moments, cfg.initial_alpha(), coords)
    errs = [abs(float(a.detach()) - float(b)) / abs(float(b))
            for a, b in zip(got, want)]
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "masked: non-finite gradient in the 64 px step")
    return launched, errs


def phase_masked(vgg_params):
    """BASELINE config 3, mask-guided transfer, at full width:
    ``StrotssConfig()`` (VGG16, 9 taps, 2179 channels, 1024 samples, 4
    scales x 200 steps, bf16 policy) with two regions, through
    ``strotss_torch.stylize``. The masks are PNGs loaded by
    ``strotss_torch.ops.masks.load_mask`` at the images' sizes. A step
    runs K1 twice, K2a and K2b once for each region, block1 once."""
    import tempfile

    import torch

    import strotss_torch
    from strotss_torch.ops.masks import load_mask

    content = _smooth_image(480, 640, 21)
    style = _smooth_image(720, 560, 22)
    with tempfile.TemporaryDirectory() as tmp:
        cm, sm = load_mask(*_mask_pngs(tmp, (480, 640), (720, 560)))
    check(tuple(cm.shape) == (2, 480, 640, 1)
          and tuple(sm.shape) == (2, 720, 560, 1),
          f"masked: masks {tuple(cm.shape)} {tuple(sm.shape)}")
    step_launches, errs = _masked_step(vgg_params, content, style, cm, sm)
    emit({"phase": "masked", "check": "one 64 px step, kernel against plain "
          "losses from the same state", "launches": step_launches,
          "loss_rel_err": errs[0], "loss_c_rel_err": errs[1],
          "loss_s_rel_err": errs[2]})
    check(max(errs) <= 1e-3, f"masked: kernel losses against plain {errs}")
    check(step_launches["remd_mins"] == 4
          and step_launches["selfsim_fwd"] == 2
          and step_launches["selfsim_bwd"] == 2,
          f"masked: the 64 px step launched {step_launches}")

    cfg = strotss_torch.StrotssConfig()
    img, info, launches, summary = _run_counted(
        content, style, cfg, content_masks=cm, style_masks=sm)
    steps = cfg.levels * cfg.max_iter
    k = int(cm.shape[0])
    emit({"phase": "masked", "config": "BASELINE config 3 at full width: "
          "StrotssConfig() defaults with 2 regions (content top/bottom, "
          "style left/right)", "regions": info["n_regions"],
          "seconds_per_step": summary["seconds"] / steps, "steps": steps,
          **summary})
    print(f"masked: {summary['seconds']:.2f} s wall, "
          f"{summary['seconds'] / steps:.4f} s per step", flush=True)
    _check_curves("masked", info, falls=True)
    check(info["n_regions"] == k == 2, f"masked: {info['n_regions']} regions")
    check(img.dtype == torch.uint8 and tuple(img.shape) == (384, 512, 3),
          f"masked: output {img.dtype} {tuple(img.shape)}, want uint8 "
          "(384, 512, 3)")
    want = {"remd_mins": 2 * k * steps, "selfsim_fwd": k * steps,
            "selfsim_bwd": k * steps, "block1_fwd": steps + 2 * cfg.levels,
            "block1_bwd": steps, "sinkhorn_lse": 0, "sinkhorn_prep": 0,
            **_k5_want(k * steps, k * cfg.levels)}
    check(launches == want, f"masked: launches {launches}, want {want}")
    return launches


def _run_batch_counted(contents, styles, cfg, **kw):
    """One batched stylization through strotss_torch.parallel.stylize_batch
    (weights resolved as a user's run resolves them), launch counts set to
    0 just before and read just after. Returns (images, info, launches,
    summary)."""
    import torch

    from strotss_torch.parallel import stylize_batch

    before = _launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs, info = stylize_batch(contents, styles, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(before)
    summary = {"contents": list(contents.shape),
               "styles": list(styles.shape), "output": list(imgs.shape),
               "seconds": seconds, "stylize_seconds": info["seconds"],
               "scales": [{"scale": sc["scale"], "seconds": sc["seconds"],
                           "alpha": sc["alpha"],
                           "first_loss": sc["curve"][0, :, 0].tolist(),
                           "last_loss": sc["curve"][-1, :, 0].tolist()}
                          for sc in info["scales"]],
               "launches": launches,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    return imgs, info, launches, summary


def _check_batch_curves(name, info, falls):
    for sc in info["scales"]:
        curve = sc["curve"]  # (n, B, 3)
        check(bool(np.all(np.isfinite(curve))),
              f"{name}: non-finite loss at scale {sc['scale']}")
        if falls:
            fell = curve[-1, :, 0] < curve[0, :, 0]
            check(bool(np.all(fell)), f"{name}: scale {sc['scale']} loss "
                  f"did not fall for pairs {np.flatnonzero(~fell).tolist()}")


def _batch_step_check(vgg_params, contents, styles, alphas, seeds, steps=10):
    """The 64 px scale of the batch, ``steps`` steps: the batched step
    (``programs.batch_steps``, one VGG pass for all pairs) against each
    pair's single step from the same pyramid and the same coordinates,
    and the run goes on with the batched update. Per pair (loss, loss_c,
    loss_s) to rtol 1e-3, the slice phase's rule: cuDNN picks other
    algorithms for blocks 2-5 on a batch than on one image, and
    trajectories are chaotic, so free-running curves are never compared.
    Returns the largest relative error of each term."""
    import dataclasses

    import torch

    import strotss_torch
    from strotss_torch import programs, solve
    from strotss_torch.models.vgg import VGG
    from strotss_torch.ops.image import fold_laplacian_pyramid
    from strotss_torch.ops.sampling import strided_grid_coords
    from strotss_torch.parallel import batch as PB

    b = len(seeds)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=steps)
    spec = programs.spec_from_config(cfg, "cuda", batched=True)
    programs.set_precision(spec)
    c = torch.tensor(contents, device="cuda")
    s = torch.tensor(styles, device="cuda")
    mode, chw, shw = solve.scale_mode_shapes(cfg, c.shape, s.shape, 0, 64)
    vgg = VGG({k: {n: t.cuda() for n, t in p.items()}
               for k, p in vgg_params.items()}, taps=spec.taps,
              compute_dtype=spec.compute_dtype, block1_impl=spec.block1_impl)
    gens = [solve.scale_generators(sd, 0, "cuda") for sd in seeds]
    pyramid, content_feats, targets, moments, _ = PB.prepare_scale_batch(
        spec, mode, chw, shw, cfg.pyramid_levels, vgg, c, s, c,
        [g[0] for g in gens], 0, [[0]] * b)
    opt = programs.RMSprop(pyramid, cfg.lr)
    alpha = [dataclasses.replace(cfg, alpha=a).initial_alpha()
             for a in alphas]
    pairs = [programs.PairTerms(targets[i], moments[i], alpha[i])
             for i in range(b)]
    errs = np.zeros(3)
    for _ in range(steps):
        coords = [strided_grid_coords(g[1], chw, cfg.sample_size,
                                      "cuda")[None] for g in gens]
        with torch.no_grad():
            single = []
            for i in range(b):
                pred = programs.extract_hypercolumn(
                    vgg, fold_laplacian_pyramid([p[i:i + 1]
                                                 for p in pyramid]))
                single.append(torch.stack(programs.step_losses(
                    spec, [f[i:i + 1] for f in content_feats], pred,
                    targets[i], moments[i], alpha[i], coords[i])))
            single = torch.stack(single).cpu().numpy()
        rows = programs.batch_steps(spec, 1, vgg, content_feats, pairs,
                                    pyramid, opt,
                                    lambda i, t: coords[i])[0].cpu().numpy()
        errs = np.maximum(errs, (np.abs(rows - single)
                                 / np.abs(single)).max(axis=0))
    return errs.tolist()


def phase_batch(main_info):
    """BASELINE config 4, batched stylization, at full width: 8 pairs
    (numpy-made contents 480x640 and styles 720x560, one shape bucket) of
    ``StrotssConfig(max_iter=10)`` (VGG16, 9 taps, 2179 channels, 1024
    samples, 4 scales to 512 px, bf16 policy; the depth cut from 4 x 100
    steps, which took 82 s, to 4 x 50 and then, to make room for the
    multi phase within 8 minutes, to 4 x 10) through
    ``strotss_torch.parallel.stylize_batch``, alphas {0.5, 1, 2, 4} twice
    and 8 distinct pair seeds. A step runs K3a and K3b once for all pairs
    and K1 twice, K2a and K2b once a pair. Then the batched step against
    each pair's single step from the same state at 64 px, and a masked
    batch of 2 pairs with one padded region."""
    import tempfile

    import torch

    import strotss_torch
    from strotss_torch.models.weights import random_params
    from strotss_torch.ops.masks import load_mask

    b = 8
    contents = np.concatenate([_smooth_image(480, 640, 40 + i)
                               for i in range(b)])
    styles = np.concatenate([_smooth_image(720, 560, 60 + i)
                             for i in range(b)])
    alphas = [0.5, 1.0, 2.0, 4.0] * 2
    seeds = [1001 + 7 * i for i in range(b)]
    cfg = strotss_torch.StrotssConfig(max_iter=10)
    imgs, info, launches, summary = _run_batch_counted(
        contents, styles, cfg, alphas=alphas, pair_seeds=seeds)
    steps = cfg.levels * cfg.max_iter
    main_step = main_info["seconds"] / (len(main_info["scales"])
                                        * main_info["scales"][0]["curve"]
                                        .shape[0])
    per_pair_step = summary["seconds"] / (steps * b)
    emit({"phase": "batch", "config": "BASELINE config 4 at full width: 8 "
          "pairs, StrotssConfig(max_iter=10), alphas 0.5/1/2/4 twice, 8 "
          "pair seeds", "steps": steps, "pairs": b,
          "seconds_per_step": summary["seconds"] / steps,
          "seconds_per_pair_step": per_pair_step,
          "main_seconds_per_step": main_step,
          "pair_step_over_main_step": per_pair_step / main_step,
          **summary})
    print(f"batch: {summary['seconds']:.2f} s wall for {b} pairs x {steps} "
          f"steps, {per_pair_step:.4f} s per pair-step against "
          f"{main_step:.4f} s per step in the main phase, peak "
          f"{summary['peak_mem_gib']:.2f} GiB", flush=True)
    _check_batch_curves("batch", info, falls=True)
    check(imgs.dtype == torch.uint8 and tuple(imgs.shape) == (b, 384, 512, 3),
          f"batch: output {imgs.dtype} {tuple(imgs.shape)}")
    check(info["scales"][0]["alpha"] == [16.0 * a for a in alphas],
          f"batch: alphas {info['scales'][0]['alpha']}")
    want = {"remd_mins": 2 * b * steps, "selfsim_fwd": b * steps,
            "selfsim_bwd": b * steps, "block1_fwd": steps + 2 * cfg.levels,
            "block1_bwd": steps, "sinkhorn_lse": 0, "sinkhorn_prep": 0,
            **_k5_want(b * steps, b * cfg.levels)}
    check(launches == want, f"batch: launches {launches}, want {want}")
    del imgs, info
    torch.cuda.empty_cache()

    vgg_params = random_params("16", seed=0)
    errs = _batch_step_check(vgg_params, contents, styles, alphas, seeds)
    emit({"phase": "batch", "check": "10 steps at 64 px, the batched step "
          "against each pair's single step from the same state",
          "loss_rel_err": errs[0], "loss_c_rel_err": errs[1],
          "loss_s_rel_err": errs[2]})
    check(max(errs) <= 1e-3, f"batch: batched against single steps {errs}")

    # masked x batched: pair 0 two regions, pair 1 one region padded to two
    with tempfile.TemporaryDirectory() as tmp:
        cm, sm = load_mask(*_mask_pngs(tmp, (480, 640), (720, 560)))
    cms = np.zeros((2, 2, 480, 640, 1), np.float32)
    sms = np.zeros((2, 2, 720, 560, 1), np.float32)
    cms[0], sms[0] = cm.numpy(), sm.numpy()
    cms[1, 0], sms[1, 0] = 1.0, 1.0
    valid = np.array([[1, 1], [1, 0]], np.float32)
    mcfg = strotss_torch.StrotssConfig(max_iter=10)
    imgs, info, mlaunches, msummary = _run_batch_counted(
        contents[:2], styles[:2], mcfg, content_masks=cms, style_masks=sms,
        region_valid=valid, pair_seeds=seeds[:2])
    msteps = mcfg.levels * mcfg.max_iter
    emit({"phase": "batch", "config": "masked x batched: 2 pairs, pair 0 "
          "with 2 regions, pair 1 with 1 region padded to 2, 4 scales x 10 "
          "steps", **msummary})
    _check_batch_curves("batch masked", info, falls=False)
    check(tuple(imgs.shape) == (2, 384, 512, 3),
          f"batch masked: output {tuple(imgs.shape)}")
    mwant = {"remd_mins": 2 * 3 * msteps, "selfsim_fwd": 3 * msteps,
             "selfsim_bwd": 3 * msteps,
             "block1_fwd": msteps + 2 * mcfg.levels, "block1_bwd": msteps,
             "sinkhorn_lse": 0, "sinkhorn_prep": 0,
             **_k5_want(3 * msteps, 3 * mcfg.levels)}
    check(mlaunches == mwant,
          f"batch masked: launches {mlaunches}, want {mwant}")
    torch.cuda.empty_cache()
    return launches


def phase_serve():
    """``python -m strotss_torch.serve`` as a user runs it, in a process of
    its own: ``--batch 4 --max_iter 20 --warmup 480x640:720x560`` on 6
    jobs: 4 of one shape bucket with their own seeds and alphas (one batch
    of 4), one whose content file is missing, and one warm job whose init
    is job 1's output (run singly after the batch). Every stdout line must
    parse as JSON; the 5 good jobs must say ``"ok": true`` (the serving
    loop turns any failure into a job's error and exits 0, so the exit
    code alone proves nothing) and the bad one ``"ok": false``."""
    import os
    import tempfile

    from PIL import Image

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, img in (("c", _smooth_image(480, 640, 81)),
                          ("s", _smooth_image(720, 560, 82))):
            paths[name] = os.path.join(tmp, f"{name}.png")
            Image.fromarray((img[0] * 255).astype(np.uint8)).save(
                paths[name])
        outs = [os.path.join(tmp, f"out{i}.png") for i in range(6)]
        jobs = [{"content": paths["c"], "style": paths["s"],
                 "output": outs[i], "seed": 11 + i, "alpha": a}
                for i, a in enumerate((0.5, 1.0, 2.0, 4.0))]
        jobs.append({"content": os.path.join(tmp, "missing.png"),
                     "style": paths["s"], "output": outs[4]})
        jobs.append({"content": paths["c"], "style": paths["s"],
                     "output": outs[5], "init": outs[1]})
        jp = os.path.join(tmp, "jobs.jsonl")
        with open(jp, "w") as f:
            f.writelines(json.dumps(j) + "\n" for j in jobs)
        cmd = [sys.executable, "-m", "strotss_torch.serve", "--jobs", jp,
               "--batch", "4", "--max_iter", "20",
               "--warmup", "480x640:720x560"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=600,
                              env=dict(os.environ, PYTHONPATH=root))
        seconds = time.perf_counter() - t0
        tail = proc.stderr[-2000:]
        check(proc.returncode == 0,
              f"serve: exit {proc.returncode}; stderr ends: {tail}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        try:
            results = [json.loads(ln) for ln in lines]
        except ValueError:
            raise PhaseError(f"serve: stdout is not pure JSONL: {lines}")
        shapes = [list(np.asarray(Image.open(o)).shape)
                  if os.path.exists(o) else None for o in outs]
    emit({"phase": "serve", "command": " ".join(cmd[1:]),
          "seconds": seconds, "results": results, "output_shapes": shapes,
          "job_seconds": [r.get("seconds") for r in results]})
    by_out = {r.get("output"): r for r in results}
    check(len(results) == 6, f"serve: {len(results)} result lines, want 6")
    good = [by_out.get(o, {}) for o in outs[:4] + outs[5:]]
    check(all(r.get("ok") is True for r in good),
          f"serve: good jobs {good}")
    check(all(by_out[o].get("batched") == 4 for o in outs[:4]),
          "serve: the 4 same-shape jobs did not run as one batch of 4")
    check("batched" not in by_out[outs[5]], "serve: the warm job batched")
    check(by_out.get(outs[4], {}).get("ok") is False
          and "FileNotFoundError" in by_out[outs[4]].get("error", ""),
          f"serve: the bad job {by_out.get(outs[4])}")
    check(all(sh == [384, 512, 3] for i, sh in enumerate(shapes) if i != 4),
          f"serve: output shapes {shapes}, want 384x512 (the content's "
          "aspect)")
    per_job = [r["seconds"] for r in good]
    print(f"serve: {seconds:.2f} s wall for the process (warm-up "
          f"included); seconds per job {per_job}", flush=True)


def phase_parity():
    """Seed 0 of both whole-run parity protocols of
    ``tools/parity_torch.py`` (default: 600 steps; masked: 240) in
    bfloat16 with the kernels. Each metric's tail-mean must lie within
    4 s_jax sqrt(1 + 1/n) of the mean of the JAX package's n seeds
    (``tools/parity_jax_band.json``, ``parity_torch.single_draw``). One
    draw resolves no more than the JAX package's own spread of a draw:
    the phase catches gross faults, and the tool's many seeds a side
    measure parity."""
    from tools import parity_torch as P

    with open(P.BAND) as f:
        band = json.load(f)
    for protocol in P.PROTOCOLS:
        got = P.torch_cell(protocol, "bfloat16", [0], "cuda")
        cell = band["cells"][P.cell_name(protocol, "bfloat16")]
        res = {m: P.single_draw(cell, m, got[m][0]) for m in P.METRICS}
        emit({"phase": "parity", "protocol": protocol, "dtype": "bfloat16",
              "seed": 0, "seconds": got["seconds"],
              "launches": got["launches"], "rule": P.SINGLE_RULE, **res})
        engaged = ("remd_mins", "selfsim_fwd", "selfsim_bwd", "block1_fwd",
                   "block1_bwd")
        check(all(got["launches"][k] > 0 for k in engaged),
              f"parity {protocol}: kernels not engaged {got['launches']}")
        for m, r in res.items():
            check(r["pass"], f"parity {protocol} {m}: {r['value']} against "
                  f"the JAX mean {r['mean_jax']} (limit {r['limit']})")


def _device_rows(prof):
    """(kernel name, device ms, count) rows of a profile, largest first."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their kernels are rows of their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def phase_profile(vgg_params):
    """Where a step's time goes: torch.profiler over 10 steps at each of
    the 4 scales. Device kernel time by name, and its share of the wall
    clock of the same run made without the profiler. Reports "not
    measured" if the profiler sees no device time. Scale set-up (two VGG
    forwards, target sampling) is inside the 40 steps' wall time.

    The same is measured with block1 on cuDNN (``block1_impl='xla'``) as
    a yardstick for the fused kernel, unprofiled runs in the order kernel,
    cuDNN, cuDNN, kernel on one card."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    import strotss_torch

    cfgs = {"kernel": strotss_torch.StrotssConfig(max_iter=10)}
    cfgs["xla"] = dataclasses.replace(cfgs["kernel"], block1_impl="xla")
    content = _smooth_image(480, 640, 31)
    style = _smooth_image(720, 560, 32)
    steps = cfgs["kernel"].levels * cfgs["kernel"].max_iter

    def run(cfg):
        t0 = time.perf_counter()
        _, info = strotss_torch.stylize(content, style, cfg,
                                        vgg_params=vgg_params)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, info

    walls = {"kernel": [], "xla": []}
    for route in ("kernel", "xla", "xla", "kernel"):
        walls[route].append(run(cfgs[route])[0])  # after the build warm-up
    out = {}
    for route, cfg in cfgs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_profiled, info = run(cfg)
        rows = _device_rows(prof)
        device_ms = sum(r[1] for r in rows)
        wall = statistics.mean(walls[route])
        out[route] = {
            "wall_s": walls[route], "wall_ms_per_step": wall * 1e3 / steps,
            "wall_ms_per_step_profiled": wall_profiled * 1e3 / steps,
            "device_ms_per_step": (device_ms / steps) if rows
            else "not measured",
            "device_busy_share": (device_ms / 1e3 / wall) if rows
            else "not measured",
            "scale_seconds": [s["seconds"] for s in info["scales"]],
            "rows": rows}
    # every kernel the default path launches: a renamed or missing one
    # would read 0 here
    ours = {"remd_tc_kernel", "remd_tile_kernel", "remd_reduce_kernel",
            *_K2A_KERNELS, *_K2B_KERNELS, "block1_fwd_kernel",
            "block1_dy1_kernel", "block1_dx_kernel"}
    rows = out["kernel"].pop("rows")
    by_kernel = {o: sum(r[1] for r in rows if o in r[0]) / steps
                 for o in sorted(ours)}
    if rows:
        missing = sorted(o for o, ms in by_kernel.items() if ms <= 0)
        check(not missing, f"profile: no device time in {missing}")
    emit({"phase": "profile", "steps": steps, **out["kernel"],
          "port_kernels_ms_per_step": sum(by_kernel.values()),
          "port_kernel_ms_per_step": by_kernel,
          "top_device": [{"name": k[:80], "ms": ms, "count": n}
                         for k, ms, n in rows[:15]],
          "block1_cudnn_route": {k: v for k, v in out["xla"].items()
                                 if k != "rows"}})


def _chi2_two_sample(a, b, draws=None):
    """(statistic, p) of the two-sample test that counts ``a`` and ``b``
    come from one law. ``draws=None``: multinomial counts, the Pearson
    statistic sum (a - b)^2 / (a + b). Otherwise per-point counts of
    ``draws`` draws that each pick a point at most once: a point's count
    is binomial over the draws, with probability q estimated from both,
    and each term is divided by (1 - q) too. Chi-square with one degree
    of freedom fewer than the points either side reached."""
    from scipy.stats import chi2

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = a + b
    keep = n > 0
    var = n[keep]
    if draws is not None:
        keep &= n < 2 * draws
        var = n[keep] * (1 - n[keep] / (2 * draws))
    stat = float((((a - b)[keep] ** 2) / var).sum())
    return stat, float(chi2.sf(stat, int(keep.sum()) - 1))


def _draw_counts(device, kind, hw, mask, draws, n):
    """``draws`` draws of ``n`` coordinates from one generator on
    ``device``: the counts of each point of the sampler's grid (each
    pixel for the full grid; each strided-grid point, its offsets taken
    out) and of each draw's grid offsets."""
    import torch

    from strotss_torch.ops import sampling
    from strotss_torch.solve import scale_generators

    gen = scale_generators(0, 0, device)[0 if kind == "full" else 1]
    draw = (sampling.full_grid_coords if kind == "full"
            else sampling.strided_grid_coords)
    sx, sy = ((1, 1) if kind == "full"
              else sampling.strided_grid_params(*hw)[:2])
    m = None if mask is None else mask.to(device)
    gh, gw = -(-hw[0] // sx), -(-hw[1] // sy)
    points = torch.zeros(gh * gw, dtype=torch.int64, device=device)
    offsets = torch.zeros(sx * sy, dtype=torch.int64, device=device)
    for _ in range(draws):
        xy = draw(gen, hw, n, device, mask=m).long()
        points += torch.bincount((xy[:, 0] // sx) * gw + xy[:, 1] // sy,
                                 minlength=gh * gw)
        offsets[(xy[0, 0] % sx) * sy + xy[0, 1] % sy] += 1
    return points.cpu().numpy(), offsets.cpu().numpy()


def check_draw_law():
    """Do the CUDA generator's draws follow the CPU's law? 2**20
    coordinates (1024 draws of 1024) of each sampler on each device: on a
    48x64 grid (strided steps 1), unmasked and under each of two regions
    (top and bottom halves), and the strided grid at the 512 px content
    shape (384x512: steps 3 and 4, a random offset a draw). Each pair of
    grid-point counts is held by :func:`_chi2_two_sample` to p > 1e-3,
    and so are the offsets' counts where a grid has more than one."""
    import torch

    from strotss_torch.ops.sampling import prepare_mask

    n, draws = 1024, 1024
    halves = torch.zeros((2, 48, 64, 1))
    halves[0, :24] = 1.0
    halves[1, 24:] = 1.0
    cases = [("full", (48, 64), None), ("strided", (48, 64), None),
             ("strided", (384, 512), None)]
    for r in range(2):
        cases += [(kind, (48, 64), r) for kind in ("full", "strided")]
    out = []
    for kind, hw, region in cases:
        mask = (None if region is None
                else prepare_mask(halves[region], hw))
        (pa, oa), (pb, ob) = (_draw_counts(dev, kind, hw, mask, draws, n)
                              for dev in ("cuda", "cpu"))
        stat, p = _chi2_two_sample(pa, pb, draws)
        row = {"sampler": kind, "hw": list(hw), "region": region,
               "points": int(((pa + pb) > 0).sum()), "coords": n * draws,
               "chi2": stat, "p": p}
        if len(oa) > 1:
            row["offsets_chi2"], row["offsets_p"] = _chi2_two_sample(oa, ob)
        out.append(row)
    return out


def phase_features(main_info, max_iter=200):
    """The rest of the single-pair run, through ``strotss_torch.stylize``
    and the CLI at full width (VGG16, 9 taps, 2179 channels, 1024
    samples, bf16 policy):

    - a blend of the main phase's style (720x560) with a second style
      (600x800) at 0.7/0.3 (717/307 samples), 4 scales x ``max_iter``
      (200) steps, with ``checkpoint_dir`` and ``log_every`` half of it; a
      progress callback copies the checkpoint aside at scale 256, step
      100;
    - a resume from that copy: the state restored bit for bit, the first
      loss after it the blended run's step 101, to rtol 1e-5;
    - a refine of the main phase's result (``start_level=3``,
      ``init_image=info["stylized"]``), without and with ``remat``, the
      peak memory of each;
    - the CLI at ``--level 1 --max_iter 5 --profile_dir``: the trace names
      K1's, K2's and K3's kernels;
    - the law of the CUDA generator's draws against the CPU's
      (:func:`check_draw_law`)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    import strotss_torch
    from strotss_torch import cli, solve
    from strotss_torch.programs import style_sample_counts
    from strotss_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    content = _smooth_image(480, 640, 21)
    style = _smooth_image(720, 560, 22)
    style2 = _smooth_image(600, 800, 23)
    weights = [0.7, 0.3]
    counts = style_sample_counts(weights, 1024)
    check(counts == (717, 307), f"features: counts {counts}")
    tmp = tempfile.mkdtemp(prefix="strotss_features_")
    try:
        ck, aside = os.path.join(tmp, "ck"), os.path.join(tmp, "aside")
        half = max_iter // 2
        cfg = strotss_torch.StrotssConfig(max_iter=max_iter,
                                          checkpoint_dir=ck, log_every=half)
        steps = cfg.levels * cfg.max_iter
        losses = {}

        def progress(scl, done, total, metrics):
            losses[(scl, done)] = metrics["loss"]
            if (scl, done) == (256, half):
                shutil.copytree(ck, aside)

        img, info, launches, summary = _run_counted(
            content, [style, style2], cfg, style_weights=weights,
            progress_cb=progress)
        emit({"phase": "features", "run": "blended", "config":
              "StrotssConfig() with 2 styles at 0.7/0.3 (717/307 samples), "
              f"checkpoint_dir, log_every={half}", "counts": list(counts),
              "steps": steps, **summary})
        _check_curves("features blended", info, falls=True)
        check(img.dtype == torch.uint8 and tuple(img.shape) == (384, 512, 3),
              f"features: blended output {img.dtype} {tuple(img.shape)}")
        want = {"remd_mins": 2 * steps, "selfsim_fwd": steps,
                "selfsim_bwd": steps, "block1_fwd": steps + 3 * cfg.levels,
                "block1_bwd": steps, "sinkhorn_lse": 0, "sinkhorn_prep": 0,
                **_k5_want(steps, 2 * cfg.levels)}
        check(launches == want,
              f"features: blended launches {launches}, want {want}")
        blended = launches

        # the resume: hold what restore_state hands back to the saved file
        with np.load(os.path.join(aside, "state.npz")) as data:
            saved = {f[len("leaf_"):]: data[f] for f in data.files
                     if f.startswith("leaf_")}
        meta = ckpt.load_meta(aside)
        restored = {}
        real = solve.ckpt.restore_state

        def spy(directory, template):
            out = real(directory, template)
            restored.update({k: v.cpu().numpy() for k, v in out.items()})
            return out

        solve.ckpt.restore_state = spy
        try:
            _, info_r, launches_r, summary_r = _run_counted(
                content, [style, style2],
                dataclasses.replace(cfg, checkpoint_dir=aside),
                style_weights=weights)
        finally:
            solve.ckpt.restore_state = real
        first = float(info_r["scales"][0]["curve"][0, 0])
        want_first = losses[(256, half + 1)]
        bitwise = (set(restored) == set(saved) and all(
            np.array_equal(restored[k], saved[k]) for k in saved))
        emit({"phase": "features", "run": "resume", "from": {
            "scale_index": meta["scale_index"], "done_steps":
            meta["done_steps"]}, "first_loss": first,
            "blended_loss_after_the_copy": want_first,
            "rel_err": abs(first - want_first) / abs(want_first),
            "leaves_restored": len(restored), "bitwise": bitwise,
            **summary_r})
        check((meta["scale_index"], meta["done_steps"]) == (2, half),
              f"features: checkpoint copied at {meta}")
        check(bitwise, "features: restored state differs from the saved")
        check(abs(first - want_first) <= 1e-5 * abs(want_first),
              f"features: first loss after the resume {first}, the blended "
              f"run's step {half + 1} {want_first}")
        rest = 2 * cfg.max_iter - half  # scale 256's rest and scale 512
        want = {"remd_mins": 2 * rest, "selfsim_fwd": rest,
                "selfsim_bwd": rest, "block1_fwd": rest + 3 * 2,
                "block1_bwd": rest, "sinkhorn_lse": 0, "sinkhorn_prep": 0,
                **_k5_want(rest, 2 * 2)}
        check(launches_r == want,
              f"features: resume launches {launches_r}, want {want}")
        _check_curves("features resume", info_r, falls=False)

        # the refine, without and with remat
        refine = strotss_torch.StrotssConfig(max_iter=max_iter,
                                             start_level=3)
        main_alpha = main_info["scales"][-1]["alpha"]
        first_losses, peaks = [], []
        for remat in (False, True):
            _, info_f, launches_f, summary_f = _run_counted(
                content, style, dataclasses.replace(refine, remat=remat),
                init_image=main_info["stylized"])
            emit({"phase": "features", "run": "refine", "remat": remat,
                  "start_level": 3, "alpha": info_f["scales"][0]["alpha"],
                  "main_alpha": main_alpha, **summary_f})
            want = {"remd_mins": 2 * max_iter, "selfsim_fwd": max_iter,
                    "selfsim_bwd": max_iter,
                    "block1_fwd": (2 if remat else 1) * max_iter + 2,
                    "block1_bwd": max_iter, "sinkhorn_lse": 0,
                    "sinkhorn_prep": 0, **_k5_want(max_iter, 1)}
            check(launches_f == want, f"features: refine (remat {remat}) "
                  f"launches {launches_f}, want {want}")
            check([s["scale"] for s in info_f["scales"]] == [512]
                  and info_f["scales"][0]["alpha"] == main_alpha,
                  f"features: refine scales {info_f['scales']}")
            # a refine starts near a minimum with fresh RMSprop slots, so
            # its first steps may raise the loss: finite only
            _check_curves("features refine", info_f, falls=False)
            first_losses.append(float(info_f["scales"][0]["curve"][0, 0]))
            peaks.append(summary_f["peak_mem_gib"])
        print(f"features: refine peak memory {peaks[0]:.3f} GiB, with remat "
              f"{peaks[1]:.3f} GiB", flush=True)
        check(abs(first_losses[1] - first_losses[0])
              <= 1e-5 * abs(first_losses[0]),
              f"features: refine first losses {first_losses}")

        # --profile_dir through the CLI
        from PIL import Image

        paths = []
        for name, arr in (("c.png", content), ("s.png", style)):
            paths.append(os.path.join(tmp, name))
            Image.fromarray((arr[0] * 255).astype(np.uint8)).save(paths[-1])
        prof = os.path.join(tmp, "prof")
        rc = cli.main(paths + ["-o", os.path.join(tmp, "out.jpg"),
                               "--level", "1", "--max_iter", "5",
                               "--profile_dir", prof])
        traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
        names = set()
        for t in traces:
            with open(os.path.join(prof, t)) as f:
                names |= {e.get("name", "") for e in
                          json.load(f).get("traceEvents", [])}
        kernels = {k: any(k in nm for nm in names) for k in (
            "remd_tc_kernel", "remd_tile_kernel", *_K2A_KERNELS,
            *_K2B_KERNELS, "block1_fwd_kernel", "block1_dy1_kernel",
            "block1_dx_kernel")}
        emit({"phase": "features", "run": "profile_dir", "rc": rc,
              "traces": traces, "kernels_named": kernels})
        check(rc == 0 and traces and all(kernels.values()),
              f"features: profile trace {traces} names {kernels}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    law = check_draw_law()
    emit({"phase": "features", "run": "draw_law", "cases": law})
    ps = [p for c in law for p in (c["p"], c.get("offsets_p"))
          if p is not None]
    print("features: draw law p-values " + ", ".join(
        f"{c['sampler']} {c['hw'][0]}x{c['hw'][1]} region {c['region']}: "
        f"{c['p']:.4g}" + (f" (offsets {c['offsets_p']:.4g})"
                           if "offsets_p" in c else "") for c in law),
        flush=True)
    check(all(p > 1e-3 for p in ps),
          f"features: the CUDA draws' law differs from the CPU's: {ps}")
    emit({"phase": "features", "seconds": time.perf_counter() - t0,
          "refine_peak_mem_gib": peaks[0],
          "refine_remat_peak_mem_gib": peaks[1]})
    return blended


def _rank_collectives():
    """(a) The collectives the port runs, on CUDA tensors, over this
    run's backend: all_gather_into_tensor, all_reduce with SUM and with
    MAX (the sharded Sinkhorn's column maxima), broadcast. Returns
    what failed (empty: all is well); nothing is staged through the CPU
    here."""
    import torch
    import torch.distributed as dist

    r, p = dist.get_rank(), dist.get_world_size()
    bad = []
    probes = (
        ("all_gather_into_tensor",
         lambda: dist.all_gather_into_tensor(
             out[0], torch.full((3,), float(r), device="cuda")),
         lambda: [float(k) for k in range(p) for _ in range(3)]),
        # the halo exchanges of shard_spatial move bytes
        ("all_gather_into_tensor (uint8)",
         lambda: dist.all_gather_into_tensor(
             out[0], torch.full((5,), r + 7, dtype=torch.uint8,
                                device="cuda")),
         lambda: [k + 7 for k in range(p) for _ in range(5)]),
        ("all_reduce", lambda: dist.all_reduce(out[0]),
         lambda: [p * (p + 1) / 2.0] * 4),
        ("all_reduce (MAX)",
         lambda: dist.all_reduce(out[0], op=dist.ReduceOp.MAX),
         lambda: [float(p - 1), -1.0, 2.5]),
        ("broadcast", lambda: dist.broadcast(out[0], 0),
         lambda: [0.0] * 2))
    starts = (torch.empty(3 * p, device="cuda"),
              torch.empty(5 * p, dtype=torch.uint8, device="cuda"),
              torch.full((4,), r + 1.0, device="cuda"),
              torch.tensor([float(r), -1.0 - r, 2.5], device="cuda"),
              torch.full((2,), float(r), device="cuda"))
    for (name, run, want), start in zip(probes, starts):
        out = [start]
        try:
            run()
            torch.cuda.synchronize()
            if out[0].tolist() != want():
                bad.append(f"{name} gave {out[0].tolist()}, want {want()}")
        except Exception as e:  # reported, and the phase fails on it
            bad.append(f"{name}: {type(e).__name__}: {e}")
    return bad


def _rank_remd(cases):
    """(b) Each rank runs K1 on its shard of y's rows. Per (n, m, c,
    distance, seed): whether the gathered row minima and their argmins
    and the column minima and argmins are the unsharded K1's bit for bit;
    the loss of ``transport.remd_over_group`` against the unsharded
    ``relaxed_emd`` (relative); its x and y gradients, after the
    all-reduces, against the unsharded ones (over max|g|, the larger: a
    step's prediction is the y, split); and the K1 launches of the sharded
    loss on this rank."""
    import torch
    import torch.distributed as dist

    from strotss_torch.ops.kernels import remd
    from strotss_torch.ops.losses import relaxed_emd
    from strotss_torch.parallel.transport import remd_over_group

    r, p = dist.get_rank(), dist.get_world_size()
    out = []
    for n, m, c, distance, seed in cases:
        x = _inputs(seed, (n, c), positive=(c == 3))
        y = _inputs(seed + 1, (m, c), positive=(c == 3))
        full = remd.mins(x, y, distance)
        lo = sum(len(t) for t in torch.tensor_split(y, p)[:r])
        local = remd.mins(x, torch.tensor_split(y, p)[r].contiguous(),
                          distance)

        def gathered(t):
            g = t.new_empty((p * t.numel(),))
            dist.all_gather_into_tensor(g, t.contiguous())
            return g.view(p, -1)

        rows = gathered(local[0])
        row_min, win = torch.min(rows, dim=0)
        row_arg = (gathered(local[2] + lo).gather(0, win[None])[0])
        col_min = gathered(local[1]).view(-1)
        col_arg = gathered(local[3]).view(-1)
        same = {"rowmin": torch.equal(row_min, full[0]),
                "rowarg": torch.equal(row_arg, full[2]),
                "colmin": torch.equal(col_min, full[1]),
                "colarg": torch.equal(col_arg, full[3])}
        xs, ys = (t.clone().requires_grad_(True) for t in (x, y))
        before = _launches()
        loss = remd_over_group(xs, ys, dist.group.WORLD, distance)
        launches = _launches(before)["remd_mins"]
        gx, gy = torch.autograd.grad(loss, (xs, ys))
        xu, yu = (t.clone().requires_grad_(True) for t in (x, y))
        ref = relaxed_emd(xu, yu, distance)
        gxu, gyu = torch.autograd.grad(ref, (xu, yu))
        out.append({"shape": [n, m, c], "distance": distance,
                    "shard_rows": [lo, lo + local[1].numel()],
                    "bitwise": same,
                    "loss_rel_err": abs(loss.item() - ref.item())
                    / abs(ref.item()),
                    "grad_err": max(_grad_err(gx, gxu), _grad_err(gy, gyu)),
                    "k1_launches": launches})
    return out


def _rank_sinkhorn(cases):
    """(i) ``transport.sinkhorn_over_group`` with x's rows split over the
    ranks, per (n, m, c, distance, seed), at the config's lam and
    iterations: its value and both gradients against the unsharded
    materialized ``_sinkhorn_plain`` on the same inputs (relative; over
    max|g|), and a digest of the value and gradients (the ranks' must be
    equal)."""
    import hashlib

    import torch
    import torch.distributed as dist

    import strotss_torch
    from strotss_torch.ops.losses import _sinkhorn_plain
    from strotss_torch.parallel.transport import sinkhorn_over_group

    cfg = strotss_torch.StrotssConfig()
    lam, n_iter = cfg.sinkhorn_lambda, cfg.sinkhorn_iters
    p, r = dist.get_world_size(), dist.get_rank()
    out = []
    for n, m, c, distance, seed in cases:
        x = _inputs(seed, (n, c), positive=(c == 3))
        y = _inputs(seed + 1, (m, c), positive=(c == 3))
        xs, ys = (t.clone().requires_grad_(True) for t in (x, y))
        t0 = time.perf_counter()
        loss = sinkhorn_over_group(xs, ys, dist.group.WORLD, distance, lam,
                                   n_iter)
        gx, gy = torch.autograd.grad(loss, (xs, ys))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        xu, yu = (t.clone().requires_grad_(True) for t in (x, y))
        ref = _sinkhorn_plain(xu, yu, distance, lam, n_iter)
        gxu, gyu = torch.autograd.grad(ref, (xu, yu))
        rows = torch.tensor_split(torch.arange(n), p)[r]
        out.append({"shape": [n, m, c], "distance": distance,
                    "shard_rows": [int(rows[0]), int(rows[-1]) + 1],
                    "loss_rel_err": abs(loss.item() - ref.item())
                    / abs(ref.item()),
                    "grad_x_err": _grad_err(gx, gxu),
                    "grad_y_err": _grad_err(gy, gyu),
                    "seconds_fwd_bwd": seconds,
                    "digest": hashlib.sha256(b"".join(
                        t.detach().cpu().numpy().tobytes()
                        for t in (loss, gx, gy))).hexdigest()})
    return out


def _rank_shard_samples(content, style, cfg):
    """(c), (j) ``stylize(mesh=...)`` under ``cfg`` (``shard_samples``,
    with REMD or Sinkhorn) at full width on a
    'sample' mesh of every rank: every step's (loss, loss_c, loss_s) and
    the loss's gradient with respect to the VGG taps (through the
    transport's backward, all-reduce included) held to the unsharded
    step's from the same state (the same prediction and coordinates; those
    comparison launches are taken back off the counts), a digest of the
    pyramid after each scale, and this rank's launches of each kernel.
    Then the same run again, timed alone."""
    import hashlib

    import torch
    import torch.distributed as dist

    import strotss_torch
    from strotss_torch import programs, solve
    from strotss_torch.parallel import make_mesh

    mesh = make_mesh((dist.get_world_size(),), ("sample",), devices="cuda")
    held, digests, grad_errs = [], [], []
    step_losses, optimization_steps = (programs.step_losses,
                                       solve.optimization_steps)

    def held_step(spec, *a, **k):
        out = step_losses(spec, *a, **k)
        saved = _launches()
        # the gradients with respect to float32 copies of the taps (a bf16
        # tap's gradient would round each side to bf16 apart); the losses
        # sample the taps in float32, so the values are the step's
        pred = [t.detach().float().requires_grad_(True) for t in a[1]]
        g = torch.autograd.grad(step_losses(spec, a[0], pred, *a[2:],
                                            **k)[0], pred)
        k.pop("sample_group", None)
        ref = step_losses(spec._replace(shard_samples=False), a[0], pred,
                          *a[2:], **k)
        gu = torch.autograd.grad(ref[0], pred)
        grad_errs.append(_grad_err(torch.cat([t.reshape(-1) for t in g]),
                                   torch.cat([t.reshape(-1) for t in gu])))
        ref = [t.detach() for t in ref]
        _unlaunch(saved)
        held.append((torch.stack(out).detach(), torch.stack(ref)))
        return out

    def steps_then_digest(*a):
        rows = optimization_steps(*a)
        digests.append(hashlib.sha256(b"".join(
            t.detach().cpu().numpy().tobytes() for t in a[7])).hexdigest())
        return rows

    programs.step_losses = held_step
    solve.optimization_steps = steps_then_digest
    try:
        before = _launches()
        _, info = strotss_torch.stylize(content, style, cfg, mesh=mesh)
        torch.cuda.synchronize()
        launches = _launches(before)
    finally:
        programs.step_losses = step_losses
        solve.optimization_steps = optimization_steps
    got = torch.stack([h[0] for h in held]).cpu().numpy()
    ref = torch.stack([h[1] for h in held]).cpu().numpy()
    errs = (np.abs(got - ref) / np.abs(ref)).max(axis=0).tolist()
    falls = [bool(sc["curve"][-1, 0] < sc["curve"][0, 0])
             for sc in info["scales"]]
    dist.barrier()
    t0 = time.perf_counter()
    strotss_torch.stylize(content, style, cfg, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"steps": len(held), "loss_rel_err": errs,
            "grad_err": max(grad_errs), "pyramid_digests": digests, "falls": falls,
            "launches": launches, "seconds": seconds,
            "seconds_per_step": seconds / (cfg.levels * cfg.max_iter)}


def _rank_batch(contents, styles, steps, seeds, alphas, halves=False):
    """(d) ``stylize_batch`` on a 'data' mesh of every rank: the images,
    float images and curves (each rank returns the whole batch), the
    seconds and this rank's launches. With ``halves``, also each half of
    the batch alone: the batches two ranks run. A 'data' mesh holds no
    replicas and runs under the caller's switches: for the bitwise
    comparison every run here takes PyTorch's deterministic algorithms,
    as ``programs.precision`` sets them for replicas."""
    import torch
    import torch.distributed as dist
    import torch.utils.deterministic

    import strotss_torch
    from strotss_torch.parallel import make_mesh, stylize_batch

    mesh = make_mesh((dist.get_world_size(),), ("data",), devices="cuda")
    cfg = strotss_torch.StrotssConfig(max_iter=steps)
    dist.barrier()
    before = _launches()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        t0 = time.perf_counter()
        imgs, info = stylize_batch(contents, styles, cfg, mesh=mesh,
                                   pair_seeds=seeds, alphas=alphas)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    out = {"images": imgs.cpu().numpy(),
           "stylized": info["stylized"].cpu().numpy(),
           "curves": [sc["curve"] for sc in info["scales"]],
           "seconds": seconds,
           "launches": _launches(before)}
    if halves:
        b = len(seeds) // 2
        out["halves"] = [_rank_batch(contents[h], styles[h], steps,
                                     seeds[h], alphas[h])
                         for h in (slice(0, b), slice(b, None))]
    return out


def check_block1_slabs(h, w, seed):
    """(f) K3a and K3b on the 'spatial' slabs of an (h, w) image split in
    two (units of 16 rows), in this process: each slab is the rank's rows
    with 4 extra a side (``Slab.fused_block1``'s extended slab). K3a's taps
    on the slab's own rows against the whole image's launch, and K3b's dx
    on its own rows from the whole image's cotangents on 2 rows more a
    side (what the rank fetches from its neighbours), the slabs' rows put
    together, against the whole image's K3b. Returns the distances (of
    max|ref|) and whether each is bit for bit."""
    import torch

    from strotss_torch.models.weights import random_params
    from strotss_torch.ops.kernels import block1 as B
    from strotss_torch.parallel.spatial import EXTRA, slab_bounds

    p = random_params("16", seed)
    k1 = p["block1_conv1"]["kernel"].cuda()
    k2 = p["block1_conv2"]["kernel"].cuda()
    b1 = 0.1 * _inputs(seed + 1, (64,))
    b2 = 0.1 * _inputs(seed + 2, (64,))
    x = _inputs(seed + 3, (1, h, w, 3))
    g1 = _inputs(seed + 4, (1, h, w, 64))
    g2 = _inputs(seed + 5, (1, h, w, 64))
    t1, t2 = B.block1_fwd(x, k1, b1, k2, b2)
    dx = B.block1_bwd(t1, t2, g1, g2, k1, k2)
    s1, s2, sdx = torch.empty_like(t1), torch.empty_like(t2), \
        torch.zeros_like(dx)
    bounds = slab_bounds(h, 2, 4)
    for s, e in bounds:
        lo, hi = max(0, s - EXTRA), min(h, e + EXTRA)
        e1, e2 = B.block1_fwd(x[:, lo:hi].contiguous(), k1, b1, k2, b2)
        s1[:, s:e], s2[:, s:e] = e1[:, s - lo:e - lo], e2[:, s - lo:e - lo]
        c1, c2 = torch.zeros_like(e1), torch.zeros_like(e2)
        a, b = max(0, s - 2), min(h, e + 2)
        c1[:, a - lo:b - lo], c2[:, a - lo:b - lo] = g1[:, a:b], g2[:, a:b]
        sdx[:, s:e] = B.block1_bwd(e1, e2, c1, c2, k1, k2)[:, s - lo:e - lo]
    torch.cuda.synchronize()
    out = {"shape": [h, w], "rows": bounds,
           "tap1_err": _grad_err(s1, t1), "tap2_err": _grad_err(s2, t2),
           "dx_err": _grad_err(sdx, dx),
           "bitwise": {"tap1": torch.equal(s1, t1),
                       "tap2": torch.equal(s2, t2),
                       "dx": torch.equal(sdx, dx)}}
    check(out["tap1_err"] <= 1e-5 and out["tap2_err"] <= 1e-3
          and out["dx_err"] <= 1e-3,
          f"multi (f): K3 on slabs against the whole image: {out}")
    return out


def _rank_spatial(content, style, steps, **cfg_kw):
    """(g) ``stylize(mesh=...)`` under ``shard_spatial`` at full width on a
    'spatial' mesh of every rank: every step's (loss, loss_c, loss_s) and
    the pyramid's gradient held to the unsharded step's from the same
    pyramid and coordinates (those comparison launches are taken back off
    the counts), a digest of the pyramid after each scale, and this
    rank's launches of each kernel. Then the same run again, timed
    alone."""
    import hashlib

    import torch
    import torch.distributed as dist

    import strotss_torch
    from strotss_torch import programs, solve
    from strotss_torch.ops.image import fold_laplacian_pyramid
    from strotss_torch.parallel import make_mesh

    mesh = make_mesh((dist.get_world_size(),), ("spatial",), devices="cuda")
    cfg = strotss_torch.StrotssConfig(max_iter=steps, shard_spatial=True,
                                      **cfg_kw)
    held, digests = [], []
    run_steps = solve.optimization_steps

    def grads(spec, vgg, feats, pyramid, args, coords, spatial, group):
        leaves = [p.detach().clone().requires_grad_(True) for p in pyramid]
        pred = programs.extract_for_grad(
            spec, vgg, fold_laplacian_pyramid(leaves), spatial)
        loss = programs.step_losses(spec, feats, pred, *args, coords,
                                    sample_group=group)
        g = torch.autograd.grad(loss[0], leaves)
        return (torch.stack(loss).detach(),
                torch.cat([t.reshape(-1) for t in g]))

    def held_steps(spec, n, vgg, content_feats, targets, moments, alpha,
                   pyramid, opt, coords_fn, group=None, spatial=None):
        saved = _launches()
        whole = programs.extract_hypercolumn(vgg, content_feats.image)
        rows = []
        for t in range(n):
            coords = coords_fn(t)
            args = (targets, moments, alpha)
            got, g = grads(spec, vgg, content_feats, pyramid, args, coords,
                           spatial, group)
            ref, gu = grads(spec, vgg, whole, pyramid, args, coords, None,
                            None)
            held.append((got, ref, float((g - gu).abs().max()
                                         / gu.abs().max())))
            _unlaunch(saved)
            rows.append(run_steps(spec, 1, vgg, content_feats, targets,
                                  moments, alpha, pyramid, opt,
                                  lambda s, c=coords: c, group, spatial))
            saved = _launches()
        digests.append(hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes() for p in pyramid)).hexdigest())
        return torch.cat(rows)

    solve.optimization_steps = held_steps
    try:
        before = _launches()
        _, info = strotss_torch.stylize(content, style, cfg, mesh=mesh)
        torch.cuda.synchronize()
        launches = _launches(before)
    finally:
        solve.optimization_steps = run_steps
    got = torch.stack([h[0] for h in held]).cpu().numpy()
    ref = torch.stack([h[1] for h in held]).cpu().numpy()
    errs = (np.abs(got - ref) / np.abs(ref)).max(axis=0).tolist()
    falls = [bool(sc["curve"][-1, 0] < sc["curve"][0, 0])
             for sc in info["scales"]]
    dist.barrier()
    t0 = time.perf_counter()
    strotss_torch.stylize(content, style, cfg, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"steps": len(held), "loss_rel_err": errs,
            "grad_err": max(h[2] for h in held),
            "grad_errs": [h[2] for h in held],
            "pyramid_digests": digests, "falls": falls,
            "launches": launches, "seconds": seconds,
            "seconds_per_step": seconds / (cfg.levels * steps)}


def _rank_spatial_memory(content, style):
    """(h) One step at the 2048 px scale (content 1536x2048 from
    ``levels=6, start_level=5, max_iter=1`` with a warm ``init_image``):
    this rank's peak allocated memory under ``shard_spatial`` on every
    rank, and on rank 0 the same step unsharded, one rank alone (the
    other waits). Returns (sharded peak, one-rank peak or None, the
    sharded run's last loss, the one-rank run's)."""
    import torch
    import torch.distributed as dist

    import strotss_torch
    from strotss_torch.parallel import make_mesh

    mesh = make_mesh((dist.get_world_size(),), ("spatial",), devices="cuda")
    kw = dict(levels=6, start_level=5, max_iter=1)
    out = {}
    for name, cfg, m in (
            ("sharded", strotss_torch.StrotssConfig(shard_spatial=True, **kw),
             mesh),
            ("one_rank", strotss_torch.StrotssConfig(**kw), None)):
        dist.barrier()
        if m is None and dist.get_rank() != 0:
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, info = strotss_torch.stylize(content, style, cfg, mesh=m,
                                        init_image=content)
        torch.cuda.synchronize()
        out[name] = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "before_gib": base / 2 ** 30,
                     "loss": float(info["scales"][-1]["curve"][-1, 0]),
                     "hw": list(info["stylized"].shape[1:3])}
    dist.barrier()
    return out


def _rank_pair(remd_cases, content, style, contents, styles, steps, seeds,
               alphas, sinkhorn_cfg, spatial_steps):
    """One of two ranks sharing the card over gloo: (a), (b), (c), (d),
    (g), (h), (i), (j)."""
    import torch.distributed as dist

    import strotss_torch

    out = {"backend": dist.get_backend(), "collectives": _rank_collectives()}
    if out["collectives"]:
        return out  # the phase fails on it; no run stages through the CPU
    out["remd"] = _rank_remd(remd_cases)
    out["shard_samples"] = _rank_shard_samples(
        content, style, strotss_torch.StrotssConfig(max_iter=steps,
                                                    shard_samples=True))
    out["sinkhorn"] = _rank_sinkhorn(remd_cases)
    out["shard_samples_sinkhorn"] = _rank_shard_samples(content, style,
                                                        sinkhorn_cfg)
    out["batch"] = _rank_batch(contents, styles, steps, seeds, alphas)
    out["spatial"] = _rank_spatial(content, style, spatial_steps)
    # float32 (block1 on F.conv2d, blocks 2-5 in float32): the split itself
    out["spatial_f32"] = _rank_spatial(content, style, 2,
                                       compute_dtype="float32")
    out["spatial_memory"] = _rank_spatial_memory(content, style)
    return out


def _rank_one(content, style, contents, styles, steps, seeds, alphas,
              sinkhorn_cfg):
    """The one-rank side on a world-size-1 NCCL mesh (this process, see
    :func:`_in_process_rank`): the collectives, the unsharded run of (c)
    timed after a one-step warm-up run (under a mesh, so with the same
    deterministic switches) and of (j), the batch of (d), (g) on the
    whole image and (j) at one step a scale, every all-reduce over
    NCCL."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import strotss_torch
    from strotss_torch.parallel import make_mesh

    out = {"backend": dist.get_backend(), "collectives": _rank_collectives()}
    mesh = make_mesh((1,), ("data",))
    cfg = strotss_torch.StrotssConfig(max_iter=steps)
    strotss_torch.stylize(content, style, dataclasses.replace(
        cfg, max_iter=1), mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strotss_torch.stylize(content, style, cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["single_seconds"] = time.perf_counter() - t0
    out["single_seconds_per_step"] = out["single_seconds"] / (
        cfg.levels * steps)
    # (j)'s run unsharded, the materialized Sinkhorn whole on one rank
    unsharded = dataclasses.replace(sinkhorn_cfg, shard_samples=False)
    t0 = time.perf_counter()
    strotss_torch.stylize(content, style, unsharded, mesh=mesh)
    torch.cuda.synchronize()
    out["single_sinkhorn_seconds_per_step"] = (
        time.perf_counter() - t0) / (unsharded.levels * unsharded.max_iter)
    out["batch"] = _rank_batch(contents, styles, steps, seeds, alphas,
                               halves=True)
    # shard_spatial on a world of one, every exchange over NCCL: the same
    # code on the whole image, held to the unsharded step
    out["spatial"] = _rank_spatial(content, style, 2)
    out["shard_samples_sinkhorn"] = _rank_shard_samples(
        content, style, dataclasses.replace(sinkhorn_cfg, max_iter=1))
    return out


def _in_process_rank(fn, *args):
    """``fn(*args)`` as rank 0 of a world of one on cuda:0, this process
    joining NCCL itself (saves a process's start); the process group is
    gone again when it returns."""
    import os
    import tempfile

    import torch.distributed as dist

    from strotss_torch.parallel.launch import init_rank

    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, ["cuda:0"], os.path.join(tmp, "store"), timeout=600)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()


def _serve_nccl():
    """(e) ``python -m strotss_torch.serve --batch 2 --data_devices 1``:
    rank 0 alone on a world-size-1 NCCL mesh, 2 jobs as one group (one
    64 px scale of 10 steps: the process's start dominates)."""
    import os
    import tempfile

    from PIL import Image

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, img in (("c", _smooth_image(240, 320, 91)),
                          ("s", _smooth_image(320, 280, 92))):
            paths.append(os.path.join(tmp, f"{name}.png"))
            Image.fromarray((img[0] * 255).astype(np.uint8)).save(paths[-1])
        outs = [os.path.join(tmp, f"out{i}.png") for i in range(2)]
        jp = os.path.join(tmp, "jobs.jsonl")
        with open(jp, "w") as f:
            f.writelines(json.dumps({"content": paths[0], "style": paths[1],
                                     "output": o, "seed": i}) + "\n"
                         for i, o in enumerate(outs))
        cmd = [sys.executable, "-m", "strotss_torch.serve", "--jobs", jp,
               "--batch", "2", "--data_devices", "1", "--level", "1",
               "--max_iter", "10"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=300,
                              env=dict(os.environ, PYTHONPATH=root))
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"multi (e): serve exit "
              f"{proc.returncode}; stderr ends: {proc.stderr[-2000:]}")
        results = [json.loads(ln) for ln in proc.stdout.splitlines()
                   if ln.strip()]
        written = [os.path.exists(o) for o in outs]
    check(len(results) == 2 and all(r.get("ok") is True
                                    and r.get("data_devices") == 1
                                    for r in results),
          f"multi (e): serve results {results}")
    check(all(written), f"multi (e): outputs written {written}")
    check("nccl" in proc.stderr, "multi (e): serve did not say it runs "
          "NCCL")
    return {"command": " ".join(cmd[1:]), "seconds": seconds,
            "results": results}


def phase_multi():
    """The multi-device half on a one-card machine: (a) two ranks sharing
    the card over gloo, whose collectives must take CUDA tensors, and a
    world-size-1 NCCL mesh; (b) REMD at 1024 x 1024 x 2179 cosine and
    1024 x 1024 x 3 'both' with K1 on each rank's 512-column shard: the
    minima and argmins bit for bit the unsharded K1's, the loss to rtol
    1e-6, both gradients to 1e-4 of max|g|, one K1 launch a rank a call;
    (c) a full-width ``shard_samples`` run (VGG16, 9 taps, 1024 samples,
    4 scales x 10 steps) on both ranks: every step's losses within rtol
    1e-3 and its gradient with respect to the taps within 1e-4 of max|g|
    of the unsharded step from the same state, and both ranks' pyramids
    bit for bit equal after each scale; (d) 4 pairs at full width (4 x 10
    steps) on a 2-rank 'data' mesh, bit for bit the one rank's runs of
    the same two halves (both sides under the deterministic switches),
    and its distance from the one rank's 4-pair batch; (e) serve over
    NCCL at ``--data_devices 1``; (f) K3a and K3b on the two 'spatial'
    slabs of a 384x512 image against the whole image's launches (tap1 to
    1e-5 of max, tap2 and dx 1e-3); (g) a full-width ``shard_spatial``
    run (4 scales x 5 steps) on both ranks: every step's losses within
    rtol 1e-3 and the pyramid's gradient within 5e-2 of max|g| of the
    unsharded step from the same state (bf16; float32, 4 x 2 steps: 1e-5
    and 1e-5), both ranks' pyramids bit for bit equal after each scale,
    40/20/20/28/20/0/0 launches a rank, and 2 steps a scale on a
    world-size-1 'spatial' mesh over NCCL, held the same way; (h) one
    step at the 2048 px scale: each sharded rank's peak memory below
    0.75x the one-rank peak; (i) the sample-sharded Sinkhorn at the
    shapes of (b), x's rows split, against the unsharded materialized
    Sinkhorn: the value to rtol 1e-5, both gradients to 1e-4 of max|g|,
    the ranks' bits equal; (j) a full-width ``shard_samples`` +
    ``use_sinkhorn`` run (4 scales x 3 steps) on both ranks, held as (c)
    is to the unsharded materialized-Sinkhorn step, with 0 launches of
    K1 and K4 and one of K2a and K2b a step, and 1 step a scale on a
    world-size-1 'sample' mesh over NCCL, held the same way. Two ranks on
    one card with gloo staging through the host say nothing of scaling
    across cards. Returns rank 0's launches in (c), (g) and (j)."""
    import strotss_torch
    from strotss_torch.parallel.launch import launch

    t0 = time.perf_counter()
    # (g) takes 5 steps a scale, so that the script keeps to its time
    steps, spatial_steps = 10, 5
    sinkhorn_cfg = strotss_torch.StrotssConfig(
        max_iter=3, shard_samples=True, use_sinkhorn=True)
    content, style = _smooth_image(480, 640, 21), _smooth_image(720, 560, 22)
    contents = np.concatenate([_smooth_image(480, 640, 40 + i)
                               for i in range(4)])
    styles = np.concatenate([_smooth_image(720, 560, 60 + i)
                             for i in range(4)])
    seeds, alphas = [1001, 1008, 1015, 1022], [0.5, 1.0, 2.0, 4.0]
    remd_cases = [(1024, 1024, 2179, "cosine", 101),
                  (1024, 1024, 3, "both", 103)]
    slabs = check_block1_slabs(384, 512, 111)
    pair = launch(_rank_pair, ["cuda:0", "cuda:0"],
                  args=(remd_cases, content, style, contents, styles, steps,
                        seeds, alphas, sinkhorn_cfg, spatial_steps),
                  timeout=600)
    check(all(r["backend"] == "gloo" for r in pair),
          f"multi: backends {[r['backend'] for r in pair]}")
    bad = [r["collectives"] for r in pair]
    check(not any(bad), f"multi (a): gloo on CUDA tensors failed: {bad}")
    one = _in_process_rank(_rank_one, content, style, contents, styles,
                           steps, seeds, alphas, sinkhorn_cfg)
    check(one["backend"] == "nccl" and not one["collectives"],
          f"multi (a): NCCL world of 1: {one['backend']} "
          f"{one['collectives']}")
    # (b)
    for case in (c for r in pair for c in r["remd"]):
        check(all(case["bitwise"].values()),
              f"multi (b): {case['shape']} {case['distance']} not bit for "
              f"bit: {case['bitwise']}")
        check(case["loss_rel_err"] <= 1e-6,
              f"multi (b): loss rel err {case['loss_rel_err']}")
        check(case["grad_err"] <= 1e-4,
              f"multi (b): grad err {case['grad_err']}")
        check(case["k1_launches"] == 1,
              f"multi (b): {case['k1_launches']} K1 launches a rank")
    # (c)
    sh = [r["shard_samples"] for r in pair]
    check(all(s["steps"] == 4 * steps for s in sh),
          f"multi (c): held {[s['steps'] for s in sh]} steps")
    err = max(max(s["loss_rel_err"]) for s in sh)
    check(err <= 1e-3, f"multi (c): sharded against unsharded steps {err}")
    gerr = max(s["grad_err"] for s in sh)
    check(gerr <= 1e-4, f"multi (c): sharded against unsharded step "
          f"gradients {gerr} of max|g|")
    check(sh[0]["pyramid_digests"] == sh[1]["pyramid_digests"],
          "multi (c): the ranks' pyramids differ")
    check(all(all(s["falls"]) for s in sh), "multi (c): a loss did not fall")
    want = {"remd_mins": 2 * 4 * steps, "selfsim_fwd": 4 * steps,
            "selfsim_bwd": 4 * steps, "block1_fwd": 4 * steps + 8,
            "block1_bwd": 4 * steps, "sinkhorn_lse": 0, "sinkhorn_prep": 0,
            **_k5_want(4 * steps, 4)}
    check(all(s["launches"] == want for s in sh),
          f"multi (c): launches {[s['launches'] for s in sh]}, want {want}")
    # (d): each rank runs 2 pairs, so the one rank's runs of the same 2
    # pairs are the bitwise reference. cuDNN picks other algorithms for a
    # batch of 4 at 384x512 (block5_conv3's forward and the input
    # gradient differ: tools/determinism_probe.py), so the 4-pair batch is
    # the same function to rounding, and chaotic from there: its distance
    # is reported.
    two = [r["batch"] for r in pair]
    ref = one["batch"]
    halves = {k: np.concatenate([h[k] for h in ref["halves"]])
              for k in ("images", "stylized")}
    halves["curves"] = [np.concatenate([h["curves"][j]
                                        for h in ref["halves"]], axis=1)
                        for j in range(len(ref["curves"]))]
    for r in two:
        check(np.array_equal(r["images"], halves["images"])
              and np.array_equal(r["stylized"], halves["stylized"])
              and all(np.array_equal(a, b)
                      for a, b in zip(r["curves"], halves["curves"])),
              "multi (d): the 2-rank batch is not the 1-rank runs of its "
              "halves bit for bit")
    whole = {
        "max_image_diff": int(np.abs(two[0]["images"].astype(int)
                                     - ref["images"].astype(int)).max()),
        "max_stylized_diff": float(np.abs(two[0]["stylized"]
                                          - ref["stylized"]).max()),
        "first_scale_curve_rel_diff": float(np.max(
            np.abs(two[0]["curves"][0] - ref["curves"][0])
            / np.abs(ref["curves"][0]))),
        "bitwise": bool(np.array_equal(two[0]["stylized"],
                                       ref["stylized"]))}
    check(bool(np.all(np.isfinite(ref["stylized"]))),
          "multi (d): non-finite one-rank batch")
    # (g). In bf16 the pyramid gradient is 5e-2 of max|g| from the
    # unsharded step's: cuDNN rounds blocks 2-5's bf16 convolutions by
    # shape, and the one-rank 'spatial' mesh (the same code on the whole
    # image, no split) is itself up to 1.9e-2 away (PERF.md, PR 15). In
    # float32 the split is held to 1e-5.
    sp = [r["spatial"] for r in pair]
    check(all(s["steps"] == 4 * spatial_steps for s in sp),
          f"multi (g): held {[s['steps'] for s in sp]} steps")
    err = max(max(s["loss_rel_err"]) for s in sp)
    check(err <= 1e-3, f"multi (g): spatial against unsharded steps {err}")
    gerr = max(s["grad_err"] for s in sp)
    check(gerr <= 5e-2, f"multi (g): spatial against unsharded pyramid "
          f"gradients {gerr} of max|g|")
    f32 = [r["spatial_f32"] for r in pair]
    check(all(max(s["loss_rel_err"]) <= 1e-5 and s["grad_err"] <= 1e-5
              for s in f32),
          f"multi (g): float32 spatial against unsharded steps "
          f"{[(s['loss_rel_err'], s['grad_err']) for s in f32]}")
    check(f32[0]["pyramid_digests"] == f32[1]["pyramid_digests"],
          "multi (g): the ranks' float32 pyramids differ")
    check(sp[0]["pyramid_digests"] == sp[1]["pyramid_digests"]
          and len(sp[0]["pyramid_digests"]) == 4,
          "multi (g): the ranks' pyramids differ")
    check(all(all(s["falls"]) for s in sp), "multi (g): a loss did not fall")
    n = 4 * spatial_steps
    # K5 samples the image's column alone, of the content and of the
    # prediction apart: two forward launches a step, one backward
    want = {"remd_mins": 2 * n, "selfsim_fwd": n, "selfsim_bwd": n,
            "block1_fwd": n + 8, "block1_bwd": n, "sinkhorn_lse": 0,
            "sinkhorn_prep": 0, "gather_fwd": 2 * n + 4,
            "gather_bwd": 2 * n}
    check(all(s["launches"] == want for s in sp),
          f"multi (g): launches {[s['launches'] for s in sp]}, want {want}")
    floor = one["spatial"]
    check(max(floor["loss_rel_err"]) <= 1e-3
          and len(floor["pyramid_digests"]) == 4,
          f"multi (g): the one-rank 'spatial' mesh: {floor['loss_rel_err']}")
    # (h)
    mem = [r["spatial_memory"] for r in pair]
    one_peak = mem[0]["one_rank"]["peak_gib"]
    ratios = [m["sharded"]["peak_gib"] / one_peak for m in mem]
    check(max(ratios) < 0.75, f"multi (h): a sharded rank's peak is "
          f"{ratios} of the one-rank peak {one_peak} GiB")
    check(all(np.isfinite(m["sharded"]["loss"]) for m in mem)
          and mem[0]["sharded"]["hw"] == [1536, 2048],
          f"multi (h): {mem}")
    # (i)
    for case in (c for r in pair for c in r["sinkhorn"]):
        check(case["loss_rel_err"] <= 1e-5,
              f"multi (i): {case['shape']} {case['distance']} loss rel err "
              f"{case['loss_rel_err']}")
        check(max(case["grad_x_err"], case["grad_y_err"]) <= 1e-4,
              f"multi (i): {case['shape']} {case['distance']} grad errs "
              f"{case['grad_x_err']} {case['grad_y_err']} of max|g|")
    check([c["digest"] for c in pair[0]["sinkhorn"]]
          == [c["digest"] for c in pair[1]["sinkhorn"]],
          "multi (i): the ranks' Sinkhorn values or gradients differ")
    # (j), and its one step a scale over NCCL
    sk = [r["shard_samples_sinkhorn"] for r in pair]
    sk_one = one["shard_samples_sinkhorn"]
    for runs, per in ((sk, sinkhorn_cfg.max_iter), ([sk_one], 1)):
        n = sinkhorn_cfg.levels * per
        check(all(s["steps"] == n for s in runs),
              f"multi (j): held {[s['steps'] for s in runs]} steps, want {n}")
        err = max(max(s["loss_rel_err"]) for s in runs)
        check(err <= 1e-3, f"multi (j): sharded Sinkhorn against unsharded "
              f"steps {err}")
        gerr = max(s["grad_err"] for s in runs)
        check(gerr <= 1e-4, f"multi (j): sharded Sinkhorn against unsharded "
              f"step gradients {gerr} of max|g|")
        check(all(len(s["pyramid_digests"]) == 4 for s in runs),
              "multi (j): a scale left no pyramid digest")
        want = {"remd_mins": 0, "selfsim_fwd": n, "selfsim_bwd": n,
                "block1_fwd": n + 8, "block1_bwd": n, "sinkhorn_lse": 0,
                "sinkhorn_prep": 0, **_k5_want(n, 4)}
        check(all(s["launches"] == want for s in runs),
              f"multi (j): launches at {per} steps a scale "
              f"{[s['launches'] for s in runs]}, want {want}")
    check(sk[0]["pyramid_digests"] == sk[1]["pyramid_digests"],
          "multi (j): the ranks' pyramids differ")
    check(all(np.all(np.isfinite(s["loss_rel_err"])) for s in sk + [sk_one]),
          "multi (j): a non-finite loss")
    served = _serve_nccl()
    d_steps = 4 * steps
    emit({"phase": "multi", "seconds": time.perf_counter() - t0,
          "remd": [c for r in pair for c in r["remd"]],
          "shard_samples": {
              "config": "StrotssConfig(max_iter=10, shard_samples=True), "
                        "480x640 / 720x560, 2 ranks on one card (gloo)",
              "loss_rel_err": [s["loss_rel_err"] for s in sh],
              "grad_err": [s["grad_err"] for s in sh],
              "launches_per_rank": [s["launches"] for s in sh],
              "seconds_per_step": [s["seconds_per_step"] for s in sh],
              "one_rank_seconds_per_step": one["single_seconds_per_step"]},
          "batch": {
              "config": "4 pairs 480x640 / 720x560, StrotssConfig("
                        "max_iter=10), 2 ranks (gloo) against 1 (NCCL)",
              "bitwise_against_one_rank_halves": True,
              "against_one_rank_whole_batch": whole,
              "seconds_per_step": [r["seconds"] / d_steps for r in two],
              "one_rank_seconds_per_step": ref["seconds"] / d_steps,
              "launches_per_rank": [r["launches"] for r in two],
              "one_rank_launches": ref["launches"]},
          "serve": served,
          "block1_slabs": slabs,
          "spatial": {
              "config": f"StrotssConfig(max_iter={spatial_steps}, "
                        "shard_spatial=True), "
                        "480x640 / 720x560, 2 ranks on one card (gloo)",
              "rows": "content 384x512 at 512 px: 192/192",
              "loss_rel_err": [s["loss_rel_err"] for s in sp],
              "grad_err": [s["grad_err"] for s in sp],
              "grad_errs_rank0": sp[0]["grad_errs"],
              "launches_per_rank": [s["launches"] for s in sp],
              "seconds_per_step": [s["seconds_per_step"] for s in sp],
              "one_rank_seconds_per_step": one["single_seconds_per_step"],
              "float32": {k: [s[k] for s in f32] for k in (
                  "loss_rel_err", "grad_err", "seconds_per_step")},
              "one_rank_spatial_mesh": {k: floor[k] for k in (
                  "loss_rel_err", "grad_err", "grad_errs", "launches",
                  "seconds_per_step")}},
          "spatial_memory": {
              "config": "StrotssConfig(levels=6, start_level=5, max_iter=1)"
                        " with init_image, content 1536x2048",
              "one_rank": mem[0]["one_rank"],
              "sharded": [m["sharded"] for m in mem],
              "ratio": ratios},
          "sinkhorn": [{k: v for k, v in c.items() if k != "digest"}
                       for r in pair for c in r["sinkhorn"]],
          "shard_samples_sinkhorn": {
              "config": "StrotssConfig(max_iter=3, shard_samples=True, "
                        "use_sinkhorn=True), 480x640 / 720x560, 2 ranks on "
                        "one card (gloo)",
              "loss_rel_err": [s["loss_rel_err"] for s in sk],
              "grad_err": [s["grad_err"] for s in sk],
              "launches_per_rank": [s["launches"] for s in sk],
              "falls": [s["falls"] for s in sk],
              "seconds_per_step": [s["seconds_per_step"] for s in sk],
              "one_rank_seconds_per_step": one[
                  "single_sinkhorn_seconds_per_step"],
              "one_rank_nccl": {k: sk_one[k] for k in (
                  "loss_rel_err", "grad_err", "launches",
                  "seconds_per_step")}}})
    return sh[0]["launches"], sp[0]["launches"], sk[0]["launches"]


_TIMES = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
#: K1's own fields in the kernels line, beside the common ones
_K1_FIELDS = ("route_taken", "host_ms", "tile_device_ms", "reduce_device_ms",
              "bound_fp32_cores_ms")
#: K2's own fields in the kernels line (``fwd_bwd``: K2a and K2b together)
_K2_FIELDS = ("host_ms", "bound_fp32_cores_ms", "sign_flips", "split")


#: K4's own fields in the kernels line
_K4_FIELDS = ("library_ms", "split", "prep_ms", "prep_launches")
#: K5's own fields in the kernels line
_K5_FIELDS = ("plain_host_ms", "table_host_us", "gather_sort_kernel_device_ms",
              "gather_acc_kernel_device_ms", "grad_err_in_bounds",
              "plain_grad_err_in_bounds", "grad_err_in_bounds_n32769")


def _with_yuv(main, yuv):
    """The feature term's row, with the YUV term's times beside it."""
    entry = dict(main, max_abs_err=max(main["max_abs_err"],
                                       yuv["max_abs_err"]))
    entry["yuv_both_c3"] = {k: yuv[k] for k in _TIMES + _K1_FIELDS
                            + _K4_FIELDS if k in yuv}
    return entry


def kernels_line(meas, launches, masked, features, batched, multi,
                 spatial, multi_sinkhorn):
    """``launches``: the main path's counts (K4's from the sinkhorn
    phase's run (b)); ``masked``: the masked phase's, as
    ``launches_masked``; ``features``: the features phase's blended run's,
    as ``launches_blended``; ``batched``: the batch phase's 8-pair run's,
    as ``launches_batched``; ``multi``: rank 0's in the multi phase's
    ``shard_samples`` run, as ``launches_multi_per_rank``; ``spatial``:
    rank 0's in its ``shard_spatial`` run, as
    ``launches_spatial_per_rank``; ``multi_sinkhorn``: rank 0's in its
    ``shard_samples`` + ``use_sinkhorn`` run, as
    ``launches_multi_sinkhorn_per_rank``. The block1 rows
    carry the pair axis's times
    (B = 8 images at the batch's 64 px and 512 px content shapes: one
    launch, and B one-image launches as ``singles_ms``); the gather rows
    (K5) the gather phase's, at the 512 px scale's 10 maps and 1024
    samples."""
    ss_big = meas["selfsim_32769"]
    rows = [("remd_mins", _with_yuv(*meas["remd_mins"]))]
    for name in ("fwd", "bwd"):
        row = dict(meas["selfsim"][name], n_32769={
            k: ss_big[name][k] for k in _TIMES + _K2_FIELDS
            if k in ss_big[name]})
        if name == "bwd":
            row["fwd_bwd"] = meas["selfsim"]["fwd_bwd"]
            row["n_32769"]["fwd_bwd"] = ss_big["fwd_bwd"]
        rows.append((f"selfsim_{name}", row))
    for d in ("fwd", "bwd"):
        rows.append((f"block1_{d}", dict(meas["block1"][d], batched={
            case: {k: m[d][k] for k in _TIMES + ("singles_ms", "library_ms",
                                                  "shape")}
            for case, m in meas["block1_batch"].items()})))
    rows.append(("sinkhorn_lse", dict(_with_yuv(*meas["sinkhorn_lse"]),
                                      prep_launches=launches[
                                          "sinkhorn_prep"])))
    rows += [(f"gather_{d}", meas["gather"][d]) for d in ("fwd", "bwd")]
    out = []
    for name, m in rows:
        out.append({
            "name": name, "route": "cuda", "source": _SOURCES[name],
            "replaces": _REPLACES[name], "launches": launches[name],
            "launches_masked": masked[name],
            "launches_blended": features[name],
            "launches_batched": batched[name],
            "launches_multi_per_rank": multi[name],
            "launches_spatial_per_rank": spatial[name],
            "launches_multi_sinkhorn_per_rank": multi_sinkhorn[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "device_ms": m["device_ms"],
            **{k: v for k, v in m.items() if k in (
                "yuv_both_c3", "n_32769", "fwd_bwd", "batched") + _K1_FIELDS
               + _K2_FIELDS + _K4_FIELDS[1:] + _K5_FIELDS},
        })
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
        import strotss_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the strotss_torch package is missing ({e}); run "
              "this script from the root of the repository", file=sys.stderr)
        return 2
    try:
        name = phase_card()
        _, rates = peaks(name)
        phase_build()
        meas = phase_kernels(rates)
        meas["gather"] = phase_gather(rates)
        from strotss_torch.models.weights import random_params

        # seeded random weights: the card's machine has no pretrained VGG
        vgg_params = random_params("16", seed=0)
        phase_slice(vgg_params)
        launches, main_info = phase_main()
        masked = phase_masked(vgg_params)
        batched = phase_batch(main_info)
        phase_serve()
        multi, spatial, multi_sinkhorn = phase_multi()
        features = phase_features(main_info)
        phase_profile(vgg_params)
        cosine_pass_ms = meas["sinkhorn_lse"][0]["ms"]
        sk = phase_sinkhorn(cosine_pass_ms)
        launches.update(sinkhorn_lse=sk["sinkhorn_lse"],
                        sinkhorn_prep=sk["sinkhorn_prep"])
        phase_parity()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(kernels_line(meas, launches, masked, features,
                                  batched, multi, spatial, multi_sinkhorn)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
