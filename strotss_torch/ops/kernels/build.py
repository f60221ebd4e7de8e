"""Builds the CUDA sources under ``strotss_torch/csrc`` and loads them.

Each ``csrc/*.cu`` file becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.
The build runs at first use, from the sources in the checkout only, into
``build/strotss_torch/<hash of the sources>/`` at the repository root; the
sources are compiled in parallel, one ``nvcc`` each. Nothing here runs at
import time, so the package imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "strotss_torch")
SOURCES = ("remd", "selfsim", "block1", "sinkhorn", "gather")

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: where the CUDA toolkit installs nvcc when it is not on PATH
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of the exported functions: name -> (library, argtypes).
_SIGNATURES = {
    "remd_mins": ("remd", [_P, _P] + [_I] * 5 + [_P] * 8 + [_P]),
    "selfsim_fwd": ("selfsim", [_P] * 4 + [_I, _I] + [_P] * 7 + [_I] * 2
                    + [_P]),
    "selfsim_bwd": ("selfsim", [_P] * 7 + [_I] * 3 + [_P] * 2 + [_P]),
    "block1_fwd": ("block1", [_P] * 5 + [_I] * 3 + [_P] * 2 + [_P]),
    "block1_bwd": ("block1", [_P] * 6 + [_I] * 3 + [_P] * 2 + [_P]),
    "sinkhorn_prep": ("sinkhorn", [_P, _I, _P, _I, _I, _P, _P, _I, _P, _P,
                                   _I, _P]),
    "sinkhorn_lse": ("sinkhorn", [_P, _P, _I, _P, _P, _I, _P] + [_I] * 4
                     + [_F, _I, _P, _P, _P]),
    "gather_fwd": ("gather", [_P, _I, _P, _I, _P, _P, _P]),
    "gather_bwd": ("gather", [_P, _I, _P, _I, _P, _P, _P, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
#: what the last build did: seconds, and ptxas's report per source
build_info: Dict[str, object] = {}


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {NVCC_DEFAULT}): the "
            "CUDA kernels of strotss_torch build only where the CUDA "
            "toolkit is installed"
        )
    return path


def build_all() -> Dict[str, str]:
    """Compile every source that is not built yet; return name -> .so path."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    paths = {s: os.path.join(out_dir, f"lib{s}.so") for s in SOURCES}
    todo = [s for s in SOURCES if not os.path.exists(paths[s])]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for s in todo:
            tmp = f"{paths[s]}.{os.getpid()}.tmp"
            cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{s}.cu")]
            procs[s] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for s, (tmp, p) in procs.items():
            log, _ = p.communicate()
            build_info[f"ptxas_{s}"] = log
            if p.returncode != 0:
                failed.append(f"{s}.cu (exit {p.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[s])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0
    build_info["built"] = list(todo)
    build_info["dir"] = out_dir
    return paths


def library(lib_name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<lib_name>.cu``."""
    if lib_name not in _libs:
        for s, path in build_all().items():
            if s not in _libs:
                _libs[s] = ctypes.CDLL(path)
    return _libs[lib_name]


def function(name: str):
    """The C function ``name`` from its built library, argtypes set."""
    if name not in _fns:
        lib_name, argtypes = _SIGNATURES[name]
        fn = getattr(library(lib_name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def launch(name: str, *args) -> None:
    """Call C function ``name``; raise if it reports a CUDA error."""
    err = function(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {name}")
