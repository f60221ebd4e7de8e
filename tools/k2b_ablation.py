#!/usr/bin/env python3
"""Where the time of K2b (the self-similarity backward) goes: variants of
its source timed beside it.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=. python tools/k2b_ablation.py

It compiles ``strotss_torch/csrc/selfsim.cu`` (``tc.cuh`` written in
place of its include) as it is and edited copies, each into its own
library under ``build/k2b_ablation/``, and times each one's C entry
``selfsim_bwd`` (CUDA events over 200 back-to-back launches, inputs,
signs and outputs made once) at N = 1024, C = 2179, in the order as-is,
variants, variants reversed, as-is:

- ``big_only``: one TF32 product (big.big) a fragment pair, not three;
- ``no_mma``: no products at all (the stages still load, H is still
  built and split, the fragments still read and x^ split: their bits are
  folded into the sums instead);
- ``no_h_build``: H built for the first stage only (the loop's builds
  left out; the products run on whatever the buffers hold);
- ``no_tables``: the tables of G's values made for the first two stages
  only;
- ``no_x_loads``: no x^ copies (the sign tiles still load);
- ``stages4``: a 4-deep ring and one block an SM (the register budget of
  one block) instead of 3 deep and two blocks an SM.

Only the unedited source and ``stages4`` compute the function: they are
held to ``selfsim_bwd_plain`` on the same signs (after the pull-back's
projection, 1e-4 of max|u| in all but 1% of the rows); the others are
timing probes. Prints ptxas's registers and spills per variant, then one
JSON line; imports nothing of JAX.
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
from strotss_torch.ops.kernels import build, selfsim  # noqa: E402

_OUT = os.path.join(os.path.dirname(build.BUILD_ROOT), "k2b_ablation")
_THREE = ("        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_small[nb]);\n"
          "      else\n"
          "        mma_tf32(part[mb][nb], f.a_big[mb], f.b_small[nb]);\n"
          "      mma_tf32(part[mb][nb], f.a_small[mb], f.b_big[nb]);\n"
          "      mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n")
_ONE = ("        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n"
        "      else\n"
        "        mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n")

# the fragments folded into one sum instead of the products, so that their
# reads and splits stay live
_NO_MMA = ("        {\n"
           "          uint32_t z = 0;\n"
           "#pragma unroll\n"
           "          for (int q = 0; q < 8; ++q)\n"
           "            z ^= f.a_big[q / 4][q % 4] ^ f.a_small[q / 4][q % 4] ^\n"
           "                 f.b_big[q / 2][q % 2] ^ f.b_small[q / 2][q % 2];\n"
           "#pragma unroll\n"
           "          for (int q = 0; q < 32; ++q)\n"
           "            part[q / 16][(q / 4) % 4][q % 4] =\n"
           "                (kk == 0 ? 0.f : part[q / 16][(q / 4) % 4][q % 4])"
           " +\n"
           "                __uint_as_float(z + q);\n"
           "        }\n")

#: variant -> [(text of the source to replace, every time, replacement)]
_EDITS = {
    "big_only": [(_THREE, _ONE)],
    "no_mma": [("        tc_mma(part, f, kk == 0);\n", _NO_MMA)],
    "no_tables": [("    if (tab) {\n      const int j = (s + 2) * SB_KC",
                   "    if (false) {\n      const int j = (s + 2) * SB_KC")],
    "no_x_loads": [("    cp_async4z(xs + (k0 + 2 * q) * SB_LDX + ch,",
                    "    if (false) cp_async4z(xs + (k0 + 2 * q) * SB_LDX + "
                    "ch,")],
    "no_h_build": [("    if (s + 1 < nst)\n      sb_build_h(",
                    "    if (false)\n      sb_build_h(")],
    "stages4": [("#define SB_STAGES 3\n", "#define SB_STAGES 4\n"),
                ("#define SB_MIN_BLOCKS 2 ", "#define SB_MIN_BLOCKS 1 ")],
}
_CHECKED = ("as_is", "stages4")


def _variants():
    with open(os.path.join(build.CSRC, "selfsim.cu")) as fh:
        src = fh.read()
    with open(os.path.join(build.CSRC, "tc.cuh")) as fh:
        src = src.replace('#include "tc.cuh"\n', fh.read(), 1)
    out = {"as_is": src}
    for name, edits in _EDITS.items():
        out[name] = src
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: selfsim.cu and tc.cuh no longer "
                                   f"have {old!r}")
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
        at = max(i for i, ln in enumerate(lines)
                 if "selfsim_bwd_kernel" in ln)
        regs[name] = [ln.strip() for ln in lines[at:at + 4]
                      if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(so).selfsim_bwd
        fn.argtypes = build._SIGNATURES["selfsim_bwd"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def _rows_off(u, pu, h) -> int:
    def project(a):
        return a - torch.sum(a * h, dim=1, keepdim=True) * h

    return S._rows_off(project(u), project(pu))


def main() -> int:
    if not torch.cuda.is_available():
        print("k2b_ablation: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    fns, regs = _compile(_variants())
    print(json.dumps({"ptxas": regs}), flush=True)
    order = list(fns)
    order = order + order[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    n, c = 1024, 2179
    x, y = S._inputs(7, (n, c)), S._inputs(8, (n, c))
    xh, yh, _, _, cx, cy = selfsim._prep(x, y)
    _, tx, ty, signs = selfsim.selfsim_fwd(xh, yh, cx, cy)
    want = selfsim.selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)
    u = torch.empty((2, n, c), dtype=torch.float32, device="cuda")
    args = (xh.data_ptr(), yh.data_ptr(), cx.data_ptr(), cy.data_ptr(),
            tx.data_ptr(), ty.data_ptr(), signs.data_ptr(), signs.stride(0),
            n, c, u[0].data_ptr(), u[1].data_ptr(), stream)
    ms, rows_off = {}, {}
    for name in order:
        def call(fn=fns[name]):
            err = fn(*args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        u.zero_()
        call()
        torch.cuda.synchronize()
        rows_off[name] = max(_rows_off(u[i], want[i], h)
                             for i, h in ((0, xh), (1, yh)))
        if name in _CHECKED:
            S.check(rows_off[name] <= n // 100,
                    f"{name}: {rows_off[name]} rows off the plain version")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            call()
        stop.record()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append(start.elapsed_time(stop) / 200)
    print(json.dumps({"shape": [n, c], "ms_per_launch": ms,
                      "rows_off_vs_plain": rows_off}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.PhaseError as e:
        print(f"k2b_ablation: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
