#!/usr/bin/env python3
"""Where the time of K1's tensor-core route goes: variants of its source
timed beside it.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=. python tools/k1_ablation.py

It compiles ``strotss_torch/csrc/remd.cu`` as it is and edited copies,
each into its own library under ``build/k1_ablation/``, and times each
one's tensor-core route (the C entry with the route forced: tile kernel
plus reduction; CUDA events over 200 back-to-back launches, scratch and
outputs made once) at 1024 x 1024 cosine with C = 2179 (rows 4-byte
aligned: 4-byte ``cp.async``) and C = 2048 (16-byte ``cp.async``), in the
order as-is, variants, variants reversed, as-is:

- ``cvt_rounding``: the TF32 split by ``cvt.rna.tf32.f32`` instead of the
  same rounding on the integer pipe;
- ``no_promote``: the products summed over all of C on the tensor cores,
  not a stage at a time and then on the CUDA cores;
- ``no_split``: no split at all (big = small = the f32 bits);
- ``big_only``: one TF32 product (big.big) a fragment pair, not three;
- ``loads_only``: no mma (the stages still load, wait and synchronise,
  and the fragments are still read and split; the epilogue runs on
  whatever the sums hold);
- ``no_chunk8``: the ninth 16-byte chunk of a misaligned row's stage not
  loaded (its last channels read whatever the buffer holds).

Only the unedited source and ``cvt_rounding`` are checked against
``mins_plain`` (rtol 1e-5); the minima's largest relative distance from it
is reported for every variant (``no_promote`` computes the same function
less accurately; the others compute something else and are timing probes
only). Prints ptxas's registers per variant, then one JSON line per
shape; imports nothing of JAX.
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
from strotss_torch.ops.kernels import build, remd  # noqa: E402

_OUT = os.path.join(os.path.dirname(build.BUILD_ROOT), "k1_ablation")
_THREE = ("        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_small[nb]);\n"
          "      else\n"
          "        mma_tf32(part[mb][nb], f.a_big[mb], f.b_small[nb]);\n"
          "      mma_tf32(part[mb][nb], f.a_small[mb], f.b_big[nb]);\n"
          "      mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n")
_ONE = ("        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n"
        "      else\n"
        "        mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n")

#: variant -> [(text of remd.cu to replace, every time, replacement)]
_EDITS = {
    "cvt_rounding": [(
        "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n",
        "  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(v));\n"
        "  return r;\n")],
    "no_promote": [
        ("      tc_mma(part, f, kk == 0);", "      tc_mma(acc, f, false);"),
        ("        for (int i = 0; i < 4; ++i) acc[mb][nb][i] += part[mb][nb][i];",
         "        for (int i = 0; i < 4; ++i) {}")],
    "no_split": [(
        "  big = tf32_rna(v);\n  small = tf32_rna(v - __uint_as_float(big));",
        "  big = __float_as_uint(v);\n  small = big;")],
    "big_only": [(_THREE, _ONE)],
    "loads_only": [("      tc_mma(part, f, kk == 0);\n", "")],
    "no_chunk8": [("  if (with8 && L.ok8) {\n", "  if (false) {\n")],
}
_CHECKED = ("as_is", "cvt_rounding")


def _variants():
    """remd.cu with tc.cuh written in place of its include (the split and
    the mma step live there), as-is and edited."""
    with open(os.path.join(build.CSRC, "remd.cu")) as fh:
        src = fh.read()
    with open(os.path.join(build.CSRC, "tc.cuh")) as fh:
        src = src.replace('#include "tc.cuh"\n', fh.read(), 1)
    out = {"as_is": src}
    for name, edits in _EDITS.items():
        out[name] = src
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: remd.cu and tc.cuh no longer have "
                                   f"{old!r}")
            out[name] = out[name].replace(old, new)
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
            [build._nvcc(), *build._NVCC_FLAGS, "-I", build.CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns, regs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        at = max(i for i, ln in enumerate(lines) if "remd_tc_kernel" in ln)
        regs[name] = [ln.strip() for ln in lines[at:at + 4]
                      if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(so).remd_mins
        fn.argtypes = build._SIGNATURES["remd_mins"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    fns, regs = _compile(_variants())
    print(json.dumps({"ptxas": regs}), flush=True)
    order = list(fns)
    order = order + order[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    n = m = 1024
    for c in (2179, 2048):
        x, y = S._inputs(c, (n, c)), S._inputs(c + 1, (m, c))
        parts = remd._scratch_ptrs(x.device, n, m, stream)
        out = torch.empty(2 * (n + m), dtype=torch.int32, device="cuda")
        rmin, cmin = out[:n].view(torch.float32), out[n:n + m].view(
            torch.float32)
        ptrs = (rmin.data_ptr(), out[n + m:].data_ptr(), cmin.data_ptr(),
                out[2 * n + m:].data_ptr())
        want = remd.mins_plain(x, y, "cosine")
        ms, errs = {}, {}
        for name in order:
            def call(fn=fns[name]):
                err = fn(x.data_ptr(), y.data_ptr(), n, m, c, 0, 1, *parts,
                         ptrs[0], ptrs[1], ptrs[2], ptrs[3], stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = max(S._rel(rmin, want[0]), S._rel(cmin, want[1]))
            errs[name] = err
            if name in _CHECKED:
                S.check(err <= 1e-5, f"{name} C={c}: minima rel err {err}")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                call()
            stop.record()
            torch.cuda.synchronize()
            ms.setdefault(name, []).append(start.elapsed_time(stop) / 200)
        print(json.dumps({"shape": [n, m, c], "ms_per_launch": ms,
                          "minima_rel_err_vs_plain": errs}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.PhaseError as e:
        print(f"k1_ablation: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
