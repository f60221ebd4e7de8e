"""Start the ranks of a multi-device run: one process a device.

The JAX package drives a mesh from one process; the port runs one
process a device (:mod:`strotss_torch.parallel.mesh`), so something has
to start those processes. This module does, for the tests, for
``chip_smoke.py`` and for ``python -m strotss_torch.serve
--data_devices D``::

    from strotss_torch.parallel.launch import launch

    def rank_fn(a, b):              # module level: spawn imports it
        mesh = make_mesh((2,), ("data",))
        return stylize_batch(..., mesh=mesh)

    results = launch(rank_fn, ["cuda:0", "cuda:1"], args=(a, b))

Each rank is a ``spawn``-ed process. It sets its device and thread count,
meets the others through a ``FileStore`` in a fresh temporary directory
(no TCP port, so concurrent launches cannot collide) and joins the
default process group with a finite timeout: NCCL when every rank has a
card of its own, gloo otherwise. A rank that raises stops the others,
and the caller gets a :class:`RankError` with that rank's traceback; a
rank that hangs is stopped after the caller's timeout. ``torchrun``
works as well: there each rank calls ``init_process_group`` itself.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds a launch, and each collective of its ranks, may take
DEFAULT_TIMEOUT = 120.0


class RankError(RuntimeError):
    """A rank raised, died or did not finish in time."""


def choose_backend(devices: Sequence[str]) -> str:
    """'nccl' when every rank has a card of its own, else 'gloo' (CPU
    ranks, or ranks that share a card)."""
    devs = [torch.device(d) for d in devices]
    cards = {d.index or 0 for d in devs if d.type == "cuda"}
    if all(d.type == "cuda" for d in devs) and len(cards) == len(devs):
        return "nccl"
    return "gloo"


def init_rank(rank: int, devices: Sequence[str], store_path: str,
              timeout: float = DEFAULT_TIMEOUT,
              threads: Optional[int] = None) -> torch.device:
    """Join the default process group as ``rank`` of ``len(devices)``:
    select the rank's device, set its thread count, meet the other ranks
    at the ``FileStore`` ``store_path`` over :func:`choose_backend`'s
    backend. Returns the rank's device."""
    device = torch.device(devices[rank])
    if threads:
        torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, len(devices))
    dist.init_process_group(
        choose_backend(devices), store=store, rank=rank,
        world_size=len(devices),
        timeout=datetime.timedelta(seconds=timeout))
    return device


def _rank_main(rank, devices, store_path, timeout, threads, fn, args,
               kwargs, results):
    """A spawned rank: join, run ``fn``, report (rank, status, payload)."""
    try:
        init_rank(rank, devices, store_path, timeout, threads)
        report = (rank, "ok", pickle.dumps(fn(*args, **kwargs)))
    except BaseException:  # reported to the parent, which raises
        report = (rank, "error", traceback.format_exc())
    results.put(report)
    if dist.is_initialized():
        dist.destroy_process_group()


class Ranks:
    """Ranks ``ranks`` (default: all) of ``len(devices)``, each running
    ``fn(*args, **kwargs)`` in a process of its own. The caller may join
    as a rank left out (``init_rank(r, devices, ranks.store_path, ...)``),
    as serve's rank 0 does. Use as a context manager: leaving it stops
    every rank still running and removes the store."""

    def __init__(self, fn: Callable, devices: Sequence[str], args=(),
                 kwargs: Optional[Dict[str, Any]] = None,
                 timeout: float = DEFAULT_TIMEOUT,
                 threads: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None):
        import multiprocessing

        self.devices = [str(d) for d in devices]
        self.backend = choose_backend(self.devices)
        self.timeout = timeout
        self._dir = tempfile.mkdtemp(prefix="strotss_ranks_")
        self.store_path = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        ranks = range(len(self.devices)) if ranks is None else ranks
        self._procs = {
            r: ctx.Process(
                target=_rank_main, daemon=True, name=f"strotss-rank-{r}",
                args=(r, self.devices, self.store_path, timeout, threads,
                      fn, tuple(args), dict(kwargs or {}), self._results))
            for r in ranks}
        self._finished = False
        for p in self._procs.values():
            p.start()

    def check(self) -> None:
        """Raise :class:`RankError` if a rank's process has ended."""
        for r, p in self._procs.items():
            if p.exitcode is not None:
                raise RankError(f"rank {r} ended (exit code {p.exitcode})")

    def wait(self, timeout: Optional[float] = None) -> Dict[int, Any]:
        """Each rank's return value, by rank. Raises :class:`RankError`
        with the traceback of the first rank that raised, of a rank that
        ended without a result, or after ``timeout`` seconds (default:
        the launch's) with the ranks that had not finished."""
        timeout = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        out: Dict[int, Any] = {}
        gone: Dict[int, float] = {}
        while len(out) < len(self._procs):
            try:
                rank, status, payload = self._results.get(timeout=0.1)
            except queue.Empty:
                now = time.monotonic()
                for r, p in self._procs.items():
                    if r in out or p.exitcode is None:
                        continue
                    # a result put just before the exit may still be in
                    # the pipe: give it a second before calling it lost
                    if now - gone.setdefault(r, now) > 1.0:
                        raise RankError(f"rank {r} ended (exit code "
                                        f"{p.exitcode}) without a result")
                if now > deadline:
                    late = sorted(set(self._procs) - set(out))
                    raise RankError(f"rank(s) {late} did not finish within "
                                    f"{timeout:g} s")
                continue
            if status == "error":
                raise RankError(f"rank {rank} raised:\n{payload}")
            out[rank] = pickle.loads(payload)
        self._finished = True
        return out

    def close(self) -> None:
        """Stop every rank still running and remove the store. Ranks that
        all returned get a few seconds to leave the process group."""
        for p in self._procs.values():
            p.join(timeout=5 if self._finished else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        self._results.close()
        self._results.join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn: Callable, devices: Sequence[str], args=(),
           kwargs: Optional[Dict[str, Any]] = None,
           timeout: float = DEFAULT_TIMEOUT,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``len(devices)`` ranks, rank r on
    ``devices[r]`` ('cpu', 'cuda:0', ...), and return their results in
    rank order. ``fn`` must be importable (defined at a module's top
    level) and so must its results be picklable: a spawned rank re-imports
    ``fn``'s module, so keep that module light. ``timeout``: seconds for
    the whole launch and for each collective. ``threads``: each rank's
    ``torch.set_num_threads`` (default: torch's own)."""
    with Ranks(fn, devices, args, kwargs, timeout, threads) as r:
        got = r.wait()
    return [got[k] for k in range(len(devices))]
