"""Numerics shared by the hand-written kernels and their plain versions.

Counterpart of ``strotss_tpu/ops/kernels/common.py``. The eps floors live
here, once, and :mod:`strotss_torch.ops.losses` imports them, so a kernel
and its plain version cannot drift apart. The same floors are written into
``csrc/*.cu``.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Optional

import torch

from strotss_torch.ops.kernels import build

_L2NORM_EPS = 1e-12  # floor on squared row norms before the rsqrt
_L2DIST_EPS = 1e-6  # floor on squared L2 distances
_COLSUM_EPS = 1e-12  # floor on self-similarity column sums
#: distance -> its code in csrc/tile.cuh (DIST_COS, DIST_L2, DIST_BOTH)
_DIST_CODE = {"cosine": 0, "l2": 1, "both": 2}


def round_up(v: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``v``."""
    return -(-v // m) * m


def normalize_rows(x: torch.Tensor):
    """Row-L2-normalize with the shared eps floor.

    Returns ``(normalized, inverse_norms)``; the inverse norms are reused
    by the kernels' backward passes.
    """
    sq = torch.sum(x * x, dim=1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(sq, min=_L2NORM_EPS))
    return x * inv, inv


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """``'auto'`` -> ``'kernel'`` on a CUDA tensor, ``'plain'`` on the CPU.

    ``'kernel'`` on a CPU tensor raises: a kernel runs only on the card,
    and nothing falls back quietly.
    """
    if impl == "auto":
        return "kernel" if t.is_cuda else "plain"
    if impl == "plain":
        return impl
    if impl == "kernel":
        if not t.is_cuda:
            raise RuntimeError(
                "impl='kernel' needs CUDA tensors; this one lies on "
                f"{t.device}. Use impl='plain' or 'auto' on the CPU."
            )
        return impl
    raise ValueError(f"impl must be 'auto', 'plain' or 'kernel', got {impl!r}")


def check_cuda_f32(name: str, t: torch.Tensor, shape) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if not t.is_cuda:
        raise RuntimeError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_on(device: torch.device, *args) -> None:
    """``build.launch(*args)`` with ``device`` current, entering a device
    context only when another device is current."""
    if device.index == torch.cuda.current_device():
        build.launch(*args)
    else:
        with torch.cuda.device(device):
            build.launch(*args)


_SCRATCH_KEPT = 8  # scratch buffers kept, the least recently used dropped
_scratch: "OrderedDict[tuple, tuple]" = OrderedDict()
#: the store of the CUDA graph being captured (:func:`capturing_into`)
_graph_store: Optional[dict] = None


@contextlib.contextmanager
def capturing_into(store: dict):
    """For the body of the ``with``, in which a CUDA graph is captured:
    the kernels' wrappers keep nothing of theirs in their caches for later
    calls. Each scratch :func:`stream_scratch` hands out is made in the
    capture and kept in ``store``, which the graph's owner holds as long
    as the graph, so no later call evicts or reuses a buffer the graph
    writes; caches of values derived from other tensors (block1's weight
    layouts) are bypassed, so the graph derives them itself from what it
    reads on each replay."""
    global _graph_store
    outer, _graph_store = _graph_store, store
    try:
        yield store
    finally:
        _graph_store = outer


def graph_store() -> Optional[dict]:
    """The store of the CUDA graph being captured, or None."""
    return _graph_store


def stream_scratch(key: tuple, stream: int, numel: int, dtype,
                   device: torch.device) -> torch.Tensor:
    """A kernel's scratch of ``numel`` elements, one buffer per ``key``
    (which names the kernel, device and shape), made anew when ``stream``
    is another than the one it was made on: the kernels of one stream run
    in order, so only that stream may reuse it. While a CUDA graph is
    captured, the buffer is the graph's own (:func:`capturing_into`)."""
    if _graph_store is not None:
        key = ("scratch",) + key
        if key not in _graph_store:
            _graph_store[key] = torch.empty(numel, dtype=dtype,
                                            device=device)
        return _graph_store[key]
    hit = _scratch.get(key)
    if hit is None or hit[0] != stream:
        hit = (stream, torch.empty(numel, dtype=dtype, device=device))
        _scratch[key] = hit
    _scratch.move_to_end(key)
    while len(_scratch) > _SCRATCH_KEPT:
        _scratch.popitem(last=False)
    return hit[1]
