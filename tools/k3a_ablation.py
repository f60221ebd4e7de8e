#!/usr/bin/env python3
"""Where kernel K3a's time goes: variants of its source timed beside it.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=. python tools/k3a_ablation.py

It compiles ``strotss_torch/csrc/block1.cu`` as it is and four edited
copies, each into its own library under ``build/k3a_ablation/``, and times
each one's forward launch (CUDA events over 200 back-to-back launches, the
weight layouts and outputs made once) at the 512 px content and style
shapes, in the order as-is, variants, variants reversed, as-is:

- ``tap_unroll1``: the conv2 tap loop not unrolled;
- ``no_conv2``: conv2's tensor-core routine left out (tap2 = relu(b2));
- ``no_conv1_mma``: conv1's `mma` left out (its fragments still built);
- ``no_stores``: no tap1 or tap2 stores.

Only the unedited source is checked against ``block1_plain``; the variants
compute something else and are timing probes only. Prints one JSON line
per shape; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402
from strotss_torch.models.weights import random_params  # noqa: E402
from strotss_torch.ops.kernels import block1 as B  # noqa: E402
from strotss_torch.ops.kernels import build  # noqa: E402

_OUT = os.path.join(os.path.dirname(build.BUILD_ROOT), "k3a_ablation")

#: variant -> (text of block1.cu to replace, replacement)
_EDITS = {
    "tap_unroll1": (
        "#pragma unroll\n  for (int tap = 0; tap < 9; ++tap) {",
        "#pragma unroll 1\n  for (int tap = 0; tap < 9; ++tap) {"),
    "no_conv2": ("    conv64_mma(y1a, k2a, warp, lane, acc);\n", ""),
    "no_conv1_mma": (
        "          mma_bf16(acc[nb], a, kb[nb][ks][0], kb[nb][ks][1]);",
        "          acc[nb][0] += __uint_as_float(a[nb & 3]);"),
}


def _no_stores(src: str) -> str:
    out = src.replace(
        "          if (own) *reinterpret_cast<float2*>(t1 + nb * 8) = "
        "make_float2(v0, v1);", "")
    out = out.replace(
        "          *reinterpret_cast<float2*>(t2 + nb * 8) =\n"
        "              make_float2(fmaxf(acc[mb][nb][2 * hh] + bb.x, 0.f),\n"
        "                          fmaxf(acc[mb][nb][2 * hh + 1] + bb.y, "
        "0.f));",
        # keeps conv2's sums live without writing them
        "          if (acc[mb][nb][2 * hh] == 12345.f) t2[nb * 8] = bb.x;")
    return out


def _variants():
    path = os.path.join(build.CSRC, "block1.cu")
    with open(path) as fh:
        src = fh.read()
    out = {"as_is": src}
    for name, (old, new) in _EDITS.items():
        if old not in src:
            raise RuntimeError(f"{name}: block1.cu no longer has {old!r}")
        out[name] = src.replace(old, new)
    out["no_stores"] = _no_stores(src)
    if out["no_stores"].count("12345") != 1 or "if (own)" in out["no_stores"]:
        raise RuntimeError("no_stores: block1.cu's stores have changed")
    return out


def _compile(variants):
    os.makedirs(_OUT, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = os.path.join(_OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(_OUT, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build._NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, regs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        at = max(i for i, ln in enumerate(lines) if "block1_fwd_kernel" in ln)
        regs[name] = [ln.strip() for ln in lines[at:at + 4]
                      if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(so).block1_fwd
        fn.argtypes = build._SIGNATURES["block1_fwd"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("k3a_ablation: no CUDA card", file=sys.stderr)
        return 2
    S.phase_card()
    fns, regs = _compile(_variants())
    print(json.dumps({"ptxas": regs}), flush=True)
    p = random_params("16", 0)
    k1 = p["block1_conv1"]["kernel"].cuda()
    k2 = p["block1_conv2"]["kernel"].cuda()
    b1, b2 = 0.1 * S._inputs(1, (64,)), 0.1 * S._inputs(2, (64,))
    lay = [t.data_ptr() for t in B.cached_fwd_layouts(k1, b1, k2, b2)]
    order = list(fns)
    order = order + order[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    for h, w in ((384, 512), (512, 398)):
        x = S._inputs(h + w, (h, w, 3))
        t1 = torch.empty((h, w, 64), device="cuda")
        t2 = torch.empty_like(t1)
        ms = {}
        for name in order:
            def call(fn=fns[name]):
                err = fn(x.data_ptr(), *lay, h, w,
                         t1.data_ptr(), t2.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "as_is":
                p1, p2 = B.block1_plain(x, k1, b1, k2, b2)
                e1, e2 = S._grad_err(t1, p1), S._grad_err(t2, p2)
                S.check(e1 <= 1e-5 and e2 <= 1e-3,
                        f"as_is {h}x{w}: tap1 {e1}, tap2 {e2}")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                call()
            stop.record()
            torch.cuda.synchronize()
            ms.setdefault(name, []).append(start.elapsed_time(stop) / 200)
        print(json.dumps({"shape": [h, w], "ms_per_launch": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
