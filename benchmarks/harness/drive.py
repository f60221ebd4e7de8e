"""Drives the program under test: whole stylizations back to back, one
call in flight, with what the check and the step metric need taken from
the step layer's calls.

The benchmark wraps the step layer (``programs.optimization_steps`` as
``solve`` calls it, ``programs.batch_steps`` as ``parallel.batch`` calls
it) from its own files, and reads its arguments by name: ``n_steps``,
``pyramid`` (the leaves updated in place) and ``opt`` (the RMSprop state,
``lr`` and ``nu``). Around each call it reads the host's clock (the step
never waits for the card, so this is the time to issue the steps). For
the check it keeps the pyramid the scale starts from, the loss rows the
call returns and the pyramid at the scale's end; and, from the
optimizer's own updates, the RMSprop slots after the first and the
pyramid after the first ``follow``. These are copies of small tensors
(the pyramid of one 512 px image is 2.8 MB), made for every call so that
every call costs the same. A call whose updates the benchmark cannot
count (fewer ``opt.step`` calls than steps) raises :class:`CaptureError`
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


class Recorder:
    """The step layer's calls of the stylization in flight: one capture a
    scale (a scale's later calls, which share its optimizer, extend it)."""

    def __init__(self, follow: int):
        self.follow = follow
        self.scales: Optional[List[Dict]] = None
        self.host_s = 0.0
        self.steps = 0

    def begin(self) -> None:
        self.scales = []

    def end(self) -> List[Dict]:
        scales, self.scales = self.scales, None
        for cap in scales or ():
            cap.pop("opt", None)
        return scales

    def _capture(self, n_steps: int, pyramid, opt) -> Dict:
        """The scale's capture, the optimizer's ``step`` counted."""
        last = self.scales[-1] if self.scales else None
        if last is not None and last["opt"] is opt:
            cap = last
        else:
            cap = {"start": [p.detach().clone() for p in pyramid],
                   "lr": opt.lr, "steps": 0, "updates": 0, "opt": opt,
                   "rows": []}
            self.scales.append(cap)
        cap["steps"] += n_steps
        step = opt.step

        def counted(*a, **k):
            out = step(*a, **k)
            cap["updates"] += 1
            if cap["updates"] == 1:
                cap["nu1"] = [v.clone() for v in opt.nu]
            if cap["updates"] == self.follow:
                cap["after"] = [p.detach().clone() for p in pyramid]
            return out

        opt.step = counted
        return cap

    def wrap(self, fn):
        rec = self
        sig = inspect.signature(fn)

        def steps(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            pyramid, opt = a["pyramid"], a["opt"]
            cap = None
            if rec.scales is not None:
                cap = rec._capture(int(a["n_steps"]), pyramid, opt)
            t0 = time.perf_counter()
            try:
                rows = fn(*args, **kw)
            finally:
                if cap is not None:
                    del opt.step  # the class's own again
            rec.host_s += time.perf_counter() - t0
            rec.steps += int(a["n_steps"])
            if cap is not None:
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


def checked(scales: List[Dict], levels: int) -> List[Dict]:
    """A finished call's captures: one a scale, each scale's updates
    counted."""
    if len(scales) != levels:
        raise CaptureError(f"{len(scales)} scales seen in the step layer's "
                           f"calls; the entry ran {levels}")
    for cap in scales:
        if cap["updates"] != cap["steps"]:
            raise CaptureError(
                f"the step layer reported {cap['steps']} steps of a scale "
                f"and made {cap['updates']} optimizer updates; the check "
                "needs the state after each update")
        # a scale of fewer than ``follow`` steps: its end
        cap.setdefault("after", cap["final"])
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
        return out, checked(scales, cfg.levels - cfg.start_level)
