#!/usr/bin/env python3
"""Kernel K1's two routes side by side: where the tensor cores start to pay.

Run from the repository root on a machine with one NVIDIA H100::

    PYTHONPATH=. python tools/k1_routes.py

K1's C entry (``strotss_torch/csrc/remd.cu``) takes the tensor-core route
(3xTF32 ``mma.sync``) from ``REMD_TC_MIN_C`` channels up and the CUDA-core
route below. This tool forces each route in turn at N = M = 1024 (the main
path's sample count) for a range of channel counts C, holds each against
the plain version (minima to rtol 1e-5, or, where the distance is
ill-conditioned in float32, no further from float64 than twice the plain
version), and times the route's tile kernel on the device (torch.profiler)
and the whole wrapper (CUDA events), in the order CUDA cores, tensor cores,
tensor cores, CUDA cores. Prints ptxas's report for ``remd.cu``, then one
JSON line per C and a last line with the smallest C from which the tensor
cores were faster at every larger C measured. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402
from strotss_torch.ops.kernels import build, remd  # noqa: E402

_CHANNELS = (3, 8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024, 2179)
_TILE_KERNELS = {"cuda_cores": ("remd_tile_kernel",),
                 "tensor_cores": ("remd_tc_kernel",)}


def _err(x, y, distance, route):
    """The route's minima against the plain version: (rel err, rel err vs
    float64, the plain version's rel err vs float64)."""
    got = remd.mins(x, y, distance, route)
    again = remd.mins(x, y, distance, route)
    S.check(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{route} C={x.shape[1]}: two runs differ")
    want = remd.mins_plain(x, y, distance)
    full = S._dist64(x, y, distance)
    r64, c64 = full.min(dim=1).values, full.min(dim=0).values
    err = max(S._rel(got[0], want[0]), S._rel(got[1], want[1]))
    err64 = max(S._rel(got[0], r64), S._rel(got[1], c64))
    plain64 = max(S._rel(want[0], r64), S._rel(want[1], c64))
    S.check(err <= 1e-5 or err64 <= max(1e-5, 2.0 * plain64),
            f"{route} C={x.shape[1]} {distance}: rel err {err} (vs float64 "
            f"{err64}, plain {plain64})")
    return err, err64, plain64


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_routes: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    S.phase_build()
    print(build.build_info.get("ptxas_remd", ""), flush=True)
    n = m = 1024
    rows = []
    for c in _CHANNELS:
        distance = "both" if c == 3 else "cosine"
        x = S._inputs(c, (n, c), positive=(c == 3))
        y = S._inputs(c + 1, (m, c), positive=(c == 3))
        res = {"n": n, "m": m, "c": c, "distance": distance,
               "route_taken": remd.route(c)}
        times = {r: {"device": [], "wrapper": []} for r in remd.ROUTES}
        for r in ("cuda_cores", "tensor_cores", "tensor_cores",
                  "cuda_cores"):
            fn = (lambda r=r: remd.mins(x, y, distance, r))
            times[r]["device"].append(S.device_ms(fn, _TILE_KERNELS[r]))
            times[r]["wrapper"].append(S.time_ms(fn))
        for r in remd.ROUTES:
            err, err64, plain64 = _err(x, y, distance, r)
            dev = [t for t in times[r]["device"] if isinstance(t, float)]
            res[r] = {"tile_device_ms": (statistics.mean(dev) if dev
                                         else "not measured"),
                      "wrapper_ms": statistics.mean(times[r]["wrapper"]),
                      "runs": times[r], "rel_err": err,
                      "rel_err_vs_f64": err64,
                      "plain_rel_err_vs_f64": plain64}
        rows.append(res)
        S.emit(res)

    def faster(row):
        """The tensor cores' tile kernel is faster (device time, or the
        wrapper's where the profiler saw no device time)."""
        key = "tile_device_ms" if all(
            isinstance(row[r]["tile_device_ms"], float)
            for r in remd.ROUTES) else "wrapper_ms"
        return row["tensor_cores"][key] < row["cuda_cores"][key]

    from_c = None
    for i in range(len(rows) - 1, -1, -1):
        if not faster(rows[i]):
            break
        from_c = rows[i]["c"]
    S.emit({"tensor_cores_faster_from_c": from_c,
            "threshold_now": remd.tc_min_c()})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.PhaseError as e:
        print(f"k1_routes: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
