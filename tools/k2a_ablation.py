#!/usr/bin/env python3
"""Where the time of K2a (the self-similarity forward) goes: variants of
its source timed beside it.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=. python tools/k2a_ablation.py

It compiles ``strotss_torch/csrc/selfsim.cu`` (``tc.cuh`` written in
place of its include) as it is and edited copies, each into its own
library under ``build/k2a_ablation/``, and times each one's C entry
``selfsim_fwd`` (Gram tiles and reduction; CUDA events over 200
back-to-back launches, inputs, scratch and outputs made once) at
N = 1024, C = 2179 with each of the C entry's splits (1, 2 or 4 blocks a
tile pair, a cluster that adds its partial Gram tiles), in the order
as-is, variants, variants reversed, as-is:

- ``big_only``: one TF32 product (big.big) a fragment pair, not three;
- ``no_mma``: no products at all (the stages still load, the fragments
  are still read and split: their bits are folded into the sums instead);
- ``no_epilogue``: P and Q meet in shared memory, and then the block
  stops: no orientations, t partials, loss or sign stores;
- ``no_sign_stores``: the epilogue runs, the two sign tiles are not
  stored;
- ``one_block``: one block an SM (the register budget of one block: no
  spills) with the same 3-deep ring;
- ``one_block_4deep``: one block an SM with a 4-deep ring, K1's shape.

Then it times the unedited source's C entry with each split at N from
512 to 8192 (C = 2179; CUDA events over 50 back-to-back launches, splits
in the order 1, 2, 4, 4, 2, 1), the measurements
``selfsim.fwd_split``'s rule is held to.

Only the unedited source and the ``one_block`` variants compute the
function: they are held to ``selfsim_fwd_plain`` (loss to rtol 1e-5;
signs that differ only where |A - B| is within 1e-5 of its largest value);
the others are timing probes. Prints ptxas's registers and spills per
variant, then one JSON line; imports nothing of JAX.
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

_OUT = os.path.join(os.path.dirname(build.BUILD_ROOT), "k2a_ablation")
_THREE = ("        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_small[nb]);\n"
          "      else\n"
          "        mma_tf32(part[mb][nb], f.a_big[mb], f.b_small[nb]);\n"
          "      mma_tf32(part[mb][nb], f.a_small[mb], f.b_big[nb]);\n"
          "      mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n")
_ONE = ("        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n"
        "      else\n"
        "        mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);\n")
_K2A_MMA = ("      tc_read_split<false>(st, kk, a_off, b_off, f, nullptr, "
            "nullptr);\n      tc_mma(part, f, kk == 0);\n")
# the fragments folded into one sum instead of the products, so that their
# reads and splits stay live
_NO_MMA = ("      tc_read_split<false>(st, kk, a_off, b_off, f, nullptr, "
           "nullptr);\n"
           "      {\n"
           "        uint32_t z = 0;\n"
           "#pragma unroll\n"
           "        for (int q = 0; q < 8; ++q)\n"
           "          z ^= f.a_big[q / 4][q % 4] ^ f.a_small[q / 4][q % 4] ^\n"
           "               f.b_big[q / 2][q % 2] ^ f.b_small[q / 2][q % 2];\n"
           "#pragma unroll\n"
           "        for (int q = 0; q < 32; ++q)\n"
           "          part[q / 16][(q / 4) % 4][q % 4] =\n"
           "              (kk == 0 ? 0.f : part[q / 16][(q / 4) % 4][q % 4]) +\n"
           "              __uint_as_float(z + q);\n"
           "      }\n")
_EPI = "  const float* P = smem;\n"

#: variant -> [(text of the source to replace, every time, replacement)]
_EDITS = {
    "big_only": [(_THREE, _ONE)],
    "no_mma": [(_K2A_MMA, _NO_MMA)],
    "no_epilogue": [(_EPI, "  if (tid == 0) total_part[blockIdx.x] = "
                           "smem[lane];\n  return;\n" + _EPI)],
    "no_sign_stores": [("    if (ri0 + r < n)\n", "    if (false)\n"),
                       ("    if (!diag && j0 + j < n)\n", "    if (false)\n")],
    "one_block": [("#define SF_MIN_BLOCKS 2 ", "#define SF_MIN_BLOCKS 1 ")],
    "one_block_4deep": [("#define SF_MIN_BLOCKS 2 ", "#define SF_MIN_BLOCKS 1 "),
                        ("#define SF_STAGES 3\n", "#define SF_STAGES 4\n")],
}
_CHECKED = ("as_is", "one_block", "one_block_4deep")


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
        # the kernel's three instances (1, 2 and 4 blocks a pair)
        regs[name] = [ln.strip() for at, head in enumerate(lines)
                      if "Compiling entry" in head
                      and "selfsim_fwd_kernel" in head
                      for ln in lines[at + 1:at + 4]
                      if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(so).selfsim_fwd
        fn.argtypes = build._SIGNATURES["selfsim_fwd"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2a_ablation: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns, regs = _compile(_variants())
    print(json.dumps({"ptxas": regs}), flush=True)
    order = list(fns)
    order = order + order[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    n, c = 1024, 2179
    x, y = S._inputs(7, (n, c)), S._inputs(8, (n, c))
    xh, yh, _, _, cx, cy = selfsim._prep(x, y)
    p_loss, _, _, p_signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    amb = ((1.0 - xh @ xh.T) / cx[None, :]
           - (1.0 - yh @ yh.T) / cy[None, :]).abs()
    amb = amb <= 1e-5 * amb.max()
    out, signs, args = _buffers(xh, yh, cx, cy, stream)
    ms, loss_err, bad_flips = {}, {}, {}
    for name in order:
        for ks in selfsim.FWD_SPLITS:
            key = f"{name}/split{ks}"
            call = _caller(fns[name], args(ks), key)
            out.zero_()
            signs.zero_()
            call()
            torch.cuda.synchronize()
            loss_err[key] = abs(float(out[0]) - float(p_loss)) / float(p_loss)
            bad_flips[key] = int(((signs[:, :n] != p_signs) & ~amb).sum())
            if name in _CHECKED:
                S.check(loss_err[key] <= 1e-5 and bad_flips[key] == 0,
                        f"{key}: loss rel err {loss_err[key]}, "
                        f"{bad_flips[key]} signs off the plain version's")
            ms.setdefault(key, []).append(_launch_ms(call, 200))
    print(json.dumps({"shape": [n, c], "ms_per_launch": ms,
                      "loss_rel_err": loss_err,
                      "signs_off_beyond_rounding": bad_flips}), flush=True)

    sweep = {}
    for n in _SWEEP_N:
        x, y = S._inputs(n, (n, c)), S._inputs(n + 1, (n, c))
        xh, yh, _, _, cx, cy = selfsim._prep(x, y)
        _, _, args = _buffers(xh, yh, cx, cy, stream)
        row = {}
        for ks in selfsim.FWD_SPLITS + selfsim.FWD_SPLITS[::-1]:
            call = _caller(fns["as_is"], args(ks), f"N={n} split{ks}")
            call()
            row.setdefault(ks, []).append(_launch_ms(call, 50))
        sweep[n] = {"pairs": selfsim.fwd_blocks(-(-n // selfsim.SF_TILE)),
                    "rule": selfsim.fwd_split(n, sms),
                    **{f"split{ks}": v for ks, v in row.items()}}
    print(json.dumps({"sms": sms, "c": c, "split_sweep_ms_per_launch":
                      sweep}), flush=True)
    return 0


#: the sample counts of the split sweep
_SWEEP_N = (512, 768, 960, 1024, 1280, 1500, 1800, 2048, 2500, 3000, 4096,
            8192)


def _buffers(xh, yh, cx, cy, stream):
    """The outputs, the signs, and the C entry's arguments for a split."""
    n, c = xh.shape
    nt = -(-n // selfsim.SF_TILE)
    most = max(selfsim.FWD_SPLITS)
    scratch = torch.empty(most * selfsim.fwd_blocks(nt) + 2 * most * nt * n,
                          dtype=torch.float32, device="cuda")
    t0 = scratch.data_ptr()
    out = torch.empty(1 + 2 * n, dtype=torch.float32, device="cuda")
    sp = -(-n // selfsim.SIGN_PITCH) * selfsim.SIGN_PITCH
    signs = torch.empty((n, sp), dtype=torch.int8, device="cuda")

    def args(ks):
        blocks = ks * selfsim.fwd_blocks(nt)
        return (xh.data_ptr(), yh.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                n, c, t0, t0 + 4 * blocks, t0 + 4 * (blocks + ks * nt * n),
                out.data_ptr(), out[1:].data_ptr(), out[n + 1:].data_ptr(),
                signs.data_ptr(), sp, ks, stream, scratch)

    return out, signs, args


def _caller(fn, args, what):
    *args, _keep = args  # the scratch tensor stays alive with the call

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")
    call.keep = _keep
    return call


def _launch_ms(call, reps):
    """ms a launch of ``call``: CUDA events around ``reps`` launches."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.PhaseError as e:
        print(f"k2a_ablation: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
