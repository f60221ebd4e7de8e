#!/usr/bin/env python3
"""Where the time of K4 (the Sinkhorn LSE pass) goes: its tensor-core
kernel beside an edited copy that sums all of C on the tensor cores, and
its column splits.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=. python tools/k4_ablation.py

It compiles ``strotss_torch/csrc/sinkhorn.cu`` as it is and an edited
copy, each into its own library under ``build/k4_ablation/``, prints
ptxas's registers and spills of each tensor-core kernel (and any advice
on wgmma, such as C7518, which serializes them), and at the
``--sinkhorn`` path's feature shape (32769 x 32769 x 2179, cosine,
``chip_smoke._sinkhorn_rows``' rows, lam 10) calls each library's C entry
``sinkhorn_lse`` on operands prepared once:

- ``as_is``: 192-column tiles, each period of 8 stages (128 channels)
  summed on the tensor cores and then added into f32 registers;
- ``unpromoted``: 256-column tiles, all of C summed in the tensor cores'
  accumulators, no f32 registers beside them.

Each is held to the plain version (its error of max|out|, and against
float64 on 2048 rows) and timed (CUDA events, the median of 5 calls) in
the order as-is, unpromoted, unpromoted, as-is; only ``as_is`` must hold
chip_smoke's limit of 1e-5. Then it times the package's ``lse_pass`` at
each split S from 1 to 16 in the order up, down, at 32769 x 32769 x 2179,
at 32769 x 32256 x 2179 (168 column tiles, which S = 1-4, 6, 7, 8, 12 and
14 divide evenly), at 4099 x 3001 x 2179 ('both') and on the CUDA-core
route at 32769 x 32769 x 3 ('both'), beside ``sinkhorn.lse_split``'s
choice. Prints one JSON line a measurement and one at the end; imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402
from strotss_torch.ops.kernels import build, sinkhorn  # noqa: E402
from strotss_torch.ops.kernels.common import _DIST_CODE  # noqa: E402

_OUT = os.path.join(os.path.dirname(build.BUILD_ROOT), "k4_ablation")
_R3_F128 = '''#define SK_R3                                                             \\
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "  \\
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "    \\
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define SK_F128 SK_F96, SK_F32(96)
'''
#: variant -> [(text of the source to replace, replacement)]
_EDITS = {
    "unpromoted": [
        ("#define SK_BN 192 ", "#define SK_BN 256 "),
        # one period of all the item's stages, as a runtime count (a
        # constant one let ptxas serialize the wgmma: C7515)
        ("#define SK_PERIOD 8 ", "#define SK_PERIOD ksteps "),
        ("  float tot[SK_BN / 2];\n", "  float (&tot)[SK_BN / 2] = acc;\n"),
        ("#pragma unroll\n    for (int i = 0; i < SK_BN / 2; ++i) "
         "tot[i] = 0.f;\n", ""),
        ("#pragma unroll\n      for (int i = 0; i < SK_BN / 2; ++i) "
         "tot[i] += acc[i];\n", ""),
        ('SK_WGMMA(96, "192", SK_R0 ", " SK_R1 ", " SK_R2, SK_F96, "96", '
         '"97", "98")\n',
         _R3_F128 + 'SK_WGMMA(128, "256", SK_R0 ", " SK_R1 ", " SK_R2 ", " '
         'SK_R3, SK_F128, "128", "129", "130")\n'),
    ],
}
#: variant -> columns a tile
_BN = {"as_is": sinkhorn.TC_BN, "unpromoted": 256}


def _variants():
    with open(os.path.join(build.CSRC, "sinkhorn.cu")) as fh:
        src = fh.read()
    out = {"as_is": src}
    for name, edits in _EDITS.items():
        out[name] = src
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: sinkhorn.cu no longer has "
                                   f"{old!r}")
            out[name] = out[name].replace(old, new)
    return out


def _compile(variants):
    """Each variant's ``sinkhorn_lse``, and ptxas's lines on its
    tensor-core kernel (all nvcc processes started together)."""
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
    fns, ptxas = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        ptxas[name] = [ln.strip() for at, head in enumerate(lines)
                       if "Compiling entry" in head
                       and "sinkhorn_lse_tc_kernel" in head
                       for ln in lines[at + 1:at + 4]
                       if "registers" in ln or "spill" in ln] + [
            ln.strip() for ln in lines if "wgmma" in ln.lower()]
        fn = ctypes.CDLL(so).sinkhorn_lse
        fn.argtypes = build._SIGNATURES["sinkhorn_lse"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def _lse_inputs(n, m, c, distance, seed):
    x, y = S._sinkhorn_rows(seed, n, m, c, distance)
    return x, y, 5.0 * S._inputs(seed + 2, (m,))


def _variant_runs(fns, rates, sms):
    n = m = 32769
    c, lam = 2179, 10.0
    x, y, logv = _lse_inputs(n, m, c, "cosine", 17)
    px, py = sinkhorn.prepare(x, y)
    plain = sinkhorn.lse_pass_plain(x, y, logv, lam, "cosine")
    rows = slice(0, 2048)
    ref = S._lse64(x[rows], y, logv, lam, "cosine")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    order = list(fns) + list(fns)[::-1]
    for name in order:
        split = sinkhorn.split_for(-(-n // sinkhorn.TC_BM),
                                   -(-m // _BN[name]), sms,
                                   sinkhorn.UNEVEN_COST["tensor_cores"])
        part = torch.empty(2 * split * n, dtype=torch.float32, device="cuda")
        out = torch.empty(n, dtype=torch.float32, device="cuda")

        def call(fn=fns[name], split=split, part=part, out=out):
            err = fn(px.parts.data_ptr(), px.norms.data_ptr(),
                     px.norms.shape[1], py.parts.data_ptr(),
                     py.norms.data_ptr(), py.norms.shape[1], logv.data_ptr(),
                     n, m, c, _DIST_CODE["cosine"], lam, split,
                     part.data_ptr(), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        r = res.setdefault(name, {"variant": name, "columns": _BN[name],
                                  "split": split, "ms": []})
        r["err_of_max"] = S._grad_err(out, plain)
        r["err_of_max_vs_f64_2048_rows"] = S._grad_err(out[rows], ref)
        if name == "as_is":
            S.check(r["err_of_max"] <= 1e-5,
                    f"as_is: {r['err_of_max']} of max|out| from plain")
        r["ms"].append(S.time_ms(call, 5, 1))
    r0 = {"plain_err_of_max_vs_f64_2048_rows": S._grad_err(plain[rows], ref),
          "bound_3xtf32_ms": 6.0 * n * m * c / rates["tf32"] * 1e3,
          "bound_fp32_ms": 2.0 * n * m * c / rates["fp32"] * 1e3}
    for r in res.values():
        print(json.dumps({"phase": "variant", **r, **r0}), flush=True)
    return list(res.values()), r0


def _splits(n, m, c, distance, sms, seed=17):
    """The package's lse_pass at each split, in the order up, down."""
    x, y, logv = _lse_inputs(n, m, c, distance, seed)
    prep = sinkhorn.prepare(x, y)
    tiles = -(-m // sinkhorn.tile_shape(c)[1])
    ss = list(range(1, min(tiles, sinkhorn.MAX_SPLIT) + 1))
    ms = {s: [] for s in ss}
    reps = 3 if c > 32 and n > 10000 else 20
    for s in ss + ss[::-1]:
        ms[s].append(S.time_ms(lambda: sinkhorn.lse_pass(
            x, y, logv, 10.0, distance, prep, s), reps, 1))
    rec = {"phase": "splits", "shape": [n, m, c], "distance": distance,
           "tiles": tiles, "rule": sinkhorn.lse_split(n, m, c, sms),
           "ms": {s: statistics.mean(v) for s, v in ms.items()},
           "ms_up_down": ms}
    rec["fastest"] = min(rec["ms"], key=rec["ms"].get)
    print(json.dumps(rec), flush=True)
    del x, y, logv, prep
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_ablation: no CUDA card", file=sys.stderr)
        return 2
    name = S.phase_card()
    _, rates = S.peaks(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns, ptxas = _compile(_variants())
    print(json.dumps({"ptxas": ptxas}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    variants, r0 = _variant_runs(fns, rates, sms)
    torch.cuda.empty_cache()
    splits = [_splits(32769, 32769, 2179, "cosine", sms),
              _splits(32769, 32256, 2179, "cosine", sms),
              _splits(4099, 3001, 2179, "both", sms, 21),
              _splits(32769, 32769, 3, "both", sms, 19)]
    print(json.dumps({"k4_ablation": {"sms": sms, "ptxas": ptxas,
                                      "variants": variants, **r0,
                                      "splits": splits}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.PhaseError as e:
        print(f"k4_ablation: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
