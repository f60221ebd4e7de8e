"""Drives the program under test: whole stylizations back to back, one
call in flight, with what the check and the step metric need taken from
the step layer's calls.

The benchmark wraps the step layer (``programs.optimization_steps`` as
``solve`` calls it, ``programs.batch_steps`` as ``parallel.batch`` calls
it) from its own files, and reads its arguments by name: ``n_steps``,
``coords_fn``, ``pyramid`` (the leaves updated in place) and ``opt`` (the
RMSprop state, ``lr`` and ``nu``). Around each call it reads the host's
clock (the step never waits for the card, so this is the time to issue
the steps).

The check needs, of each scale, the pyramid it starts from, the loss rows,
the RMSprop slots after the scale's first step, the pyramid after its
``follow``-th step and the pyramid at its end. The wrapper reads them at
the step layer's call boundaries: it splits each call of a scale at the
scale's global steps 1 and ``follow``, where they fall inside the call
(steps 1 to 10 as calls of 1, 2 and 7 steps; a scale's later calls, its
``log_every`` chunks, continue the count), and copies ``opt.nu`` after the
call that ends at step 1 and the pyramid after the one that ends at step
``follow``. It passes every argument through by name and offsets only
``n_steps`` and ``coords_fn`` (its last argument, the step: ``coords_fn(t)``
of ``optimization_steps``, ``coords_fn(b, t)`` of ``batch_steps``), and
returns the calls' rows concatenated. The copies (the pyramid of one
512 px image is 2.8 MB) lie outside the timed intervals; every recorded
call is split the same way, so every call costs the same.

This holds the step layer to a contract, which a step captured as a CUDA
graph has to keep as the eager step does:

- it takes any ``n_steps >= 1`` with ``coords_fn`` offset by the steps
  already run, and runs the same steps as one call would;
- on return, the pyramid's leaves and ``opt.nu`` hold the state after the
  last step, updated in place;
- so a graph captures one step and is replayed ``n_steps`` times, never a
  whole chunk.

A scale whose calls do not show both states raises :class:`CaptureError`
rather than hand the check a misaligned capture.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Dict, List, Optional

import torch


class Stop(Exception):
    """Raised from the entry's progress callback at the first scale
    boundary after the window has closed."""


class CaptureError(RuntimeError):
    """The step layer's calls did not show the states the check needs."""


def _shifted(coords_fn, offset: int):
    """``coords_fn`` with its last argument, the step, moved by
    ``offset``."""
    if not offset:
        return coords_fn
    return lambda *a: coords_fn(*a[:-1], a[-1] + offset)


class Recorder:
    """The step layer's calls of the stylization in flight: one capture a
    scale (a scale's later calls, which share its optimizer, extend it)."""

    def __init__(self, follow: int):
        self.follow = follow
        self.scales: Optional[List[Dict]] = None
        self.host_s = 0.0
        self.steps = 0
        # the step's memory, while watched: the most that one call
        # allocated above what was allocated as it began, and the peaks
        # that the readings reset
        self.watch = False
        self.transient: Optional[int] = None
        self.peak_seen = 0

    def watch_memory(self, on: bool) -> None:
        """Read the device memory around each step call (outside the
        timed interval) while ``on``."""
        self.watch = on

    def begin(self) -> None:
        self.scales = []

    def end(self) -> List[Dict]:
        scales, self.scales = self.scales, None
        for cap in scales or ():
            cap.pop("opt", None)
        return scales

    def _capture(self, pyramid, opt) -> Dict:
        """The scale's capture: the last one when ``opt`` is its
        optimizer, else a new one."""
        last = self.scales[-1] if self.scales else None
        if last is not None and last["opt"] is opt:
            return last
        cap = {"start": [p.detach().clone() for p in pyramid],
               "lr": opt.lr, "steps": 0, "opt": opt, "rows": []}
        self.scales.append(cap)
        return cap

    def cuts(self, done: int, n: int) -> List[int]:
        """The lengths of the calls that make up ``n`` steps of a scale
        that has run ``done``: split where steps 1 and ``follow`` end."""
        ends = sorted({e for e in (1, self.follow) if done < e < done + n})
        out, at = [], done
        for e in ends + [done + n]:
            out.append(e - at)
            at = e
        return out

    def _timed(self, fn, bound) -> torch.Tensor:
        if self.watch:
            self.peak_seen = max(self.peak_seen,
                                 torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rows = fn(*bound.args, **bound.kwargs)
        self.host_s += time.perf_counter() - t0
        if self.watch:
            self.transient = max(self.transient or 0,
                                 torch.cuda.max_memory_allocated() - base)
        return rows

    def wrap(self, fn):
        rec = self
        sig = inspect.signature(fn)

        def steps(*args, **kw):
            bound = sig.bind(*args, **kw)
            a = bound.arguments
            n = int(a["n_steps"])
            if rec.scales is None or n < 1:
                rows = rec._timed(fn, bound)
                rec.steps += n
                return rows
            pyramid, opt, coords_fn = a["pyramid"], a["opt"], a["coords_fn"]
            cap = rec._capture(pyramid, opt)
            parts, offset = [], 0
            for k in rec.cuts(cap["steps"], n):
                a["n_steps"] = k
                a["coords_fn"] = _shifted(coords_fn, offset)
                parts.append(rec._timed(fn, bound))
                offset += k
                cap["steps"] += k
                if cap["steps"] == 1:
                    cap["nu1"] = [v.clone() for v in opt.nu]
                if cap["steps"] == rec.follow:
                    cap["after"] = [p.detach().clone() for p in pyramid]
            rec.steps += n
            rows = parts[0] if len(parts) == 1 else torch.cat(parts)
            cap["rows"].append(rows)
            # the scale's last call leaves these as the scale ends
            cap["final"] = [p.detach() for p in pyramid]
            return rows

        return steps


def install(recorder: Recorder) -> None:
    """Route the entries' step calls through ``recorder``."""
    from strotss_torch import solve
    from strotss_torch.parallel import batch

    # a second install wraps the entries' own functions again, not the
    # first recorder's wrappers
    orig = getattr(install, "orig", None) or (solve.optimization_steps,
                                              batch.batch_steps)
    install.orig = orig
    solve.optimization_steps = recorder.wrap(orig[0])
    batch.batch_steps = recorder.wrap(orig[1])


def checked(scales: List[Dict], levels: int, follow: int) -> List[Dict]:
    """A finished call's captures: one a scale, each with the states the
    check reads."""
    if len(scales) != levels:
        raise CaptureError(f"{len(scales)} scales seen in the step layer's "
                           f"calls; the entry ran {levels}")
    for cap in scales:
        if cap["steps"] < follow:
            # a scale of fewer than ``follow`` steps: its end
            cap.setdefault("after", cap["final"])
        missing = [k for k in ("nu1", "after") if k not in cap]
        if missing:
            raise CaptureError(
                f"a scale of {cap['steps']} steps ended without {missing}; "
                "the check needs the state after its first and its "
                "follow-th step")
    return scales


class Program:
    """One call of the entry for a job: ``stylize`` for a single pair
    (with its region masks), ``stylize_batch`` for several."""

    def __init__(self, cfg, weights, device, recorder: Recorder):
        self.cfg, self.weights, self.device = cfg, weights, device
        self.rec = recorder

    def call(self, job, cfg=None, deadline: Optional[float] = None):
        """(uint8 image(s), the step calls' captures); raises ``Stop``
        at the first scale boundary past ``deadline``."""
        import strotss_torch
        from strotss_torch.parallel import stylize_batch

        cfg = cfg or self.cfg

        def progress(*_):
            if deadline is not None and time.perf_counter() > deadline:
                raise Stop

        self.rec.begin()
        try:
            if len(job.seeds) == 1:
                out, _ = strotss_torch.stylize(
                    job.content, job.style,
                    dataclasses.replace(cfg, seed=job.seeds[0]),
                    content_masks=job.content_masks,
                    style_masks=job.style_masks, vgg_params=self.weights,
                    progress_cb=progress, device=self.device)
                out = out[None]
            else:
                out, _ = stylize_batch(
                    job.content, job.style, cfg, vgg_params=self.weights,
                    progress_cb=progress, alphas=job.alphas,
                    pair_seeds=job.seeds, device=self.device)
            torch.cuda.synchronize(self.device) if out.is_cuda else None
        finally:
            scales = self.rec.end()
        return out, checked(scales, cfg.levels - cfg.start_level,
                            self.rec.follow)
