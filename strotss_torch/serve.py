"""Persistent serving loop of the port: one process, many stylizations.

``python -m strotss_torch.serve --jobs jobs.jsonl``, the counterpart of
``strotss_tpu/serve.py``. One process loads the VGG weights once and
builds the CUDA kernels on its first job; every later job starts at once.

Job stream: JSON Lines, one job per line, from a file or from stdin
(``--jobs -``) for queue-fed operation:

    {"content": "c.jpg", "style": "s.jpg", "output": "out.jpg"}

Optional per-job fields: ``content_mask``/``style_mask`` (paths, both or
neither), ``alpha``, ``seed``, ``init`` (a warm-start image path: the
first scale seeds from it; chain each video frame's job with ``"init":
<previous frame's output>``; warm jobs batch with other warm jobs),
``start_level`` (skip the coarsest N scales; with ``init`` a refinement
pass), and, instead of ``style``, ``styles`` (a list of style paths) with
optional ``style_weights`` (one number each): a blend of styles. Blend
jobs run singly and flush the pending group like any job that does not
batch. Shared knobs (resolution schedule, dtype, iterations, ...) come
from the flags. One result line a job streams to ``--results`` (default
stdout) as soon as it finishes:

    {"output": "out.jpg", "ok": true, "seconds": 4.31, "loss": 0.021}

A failing job (missing file, bad mask pairing, corrupt image) emits
``{"ok": false, "error": ...}`` and the loop goes on: a serving process
does not die of one bad job.

Batching: with ``--batch N`` consecutive unmasked jobs whose loaded shapes
match run together through ``strotss_torch.parallel.stylize_batch``
(each pair's trajectory is its single run's). Per-job ``alpha`` and
``seed`` ride the pair axis, and each pair draws from its job's seed as
the single path does, so a job's result does not depend on whether the
scheduler batched it or where in the group it landed. Masks,
``start_level`` and blends opt a job out. A full batch runs the moment it
fills; a batch that fails (one bad input) is retried job by job, so its
good members still complete.

Warm-up: ``--warmup HxW[:HxW]`` (repeatable; content[:style] on-disk
sizes) runs a synthetic job of that shape bucket through the serving path
before any real job is read: the kernels' build and first launches, and
with ``--batch N`` a batch of N, are paid at deploy time.

``--data_devices`` (pairs over several cards) is ROADMAP.md Queue 1 item
13: a value above 0 is refused with exit code 2; ``--allow_cpu_devices``
is accepted for the JAX CLI's sake.

Shutdown: SIGTERM drains: a job in flight finishes (no torn output
files), queued jobs of the current batch group still run, then the
process exits 0; a SIGTERM while blocked on stdin is seen within the read
poll (~0.25 s). A second SIGTERM during the drain kills the process. A job
line read from the stream always gets exactly one result line
(``_LineReader``).

Runs on ``cuda:<--gpu_id>``; ``--cpu`` asks for the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Dict, List, Optional

from strotss_torch.config import StrotssConfig
from strotss_torch.utils.logging import make_logger

logger = make_logger("STROTSS")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="strotss_torch.serve",
        description="STROTSS serving loop on a CUDA card (JSONL jobs in, "
                    "JSONL results out; weights and kernels stay loaded)",
    )
    parser.add_argument("--jobs", type=str, default="-",
                        help="JSONL job file, or '-' to stream from stdin")
    parser.add_argument("--results", type=str, default="-",
                        help="JSONL results file, or '-' for stdout")
    parser.add_argument("--batch", type=int, default=1,
                        help="group up to N consecutive same-shape unmasked "
                             "jobs into one batched run (each pair's "
                             "trajectory is its single run's)")
    parser.add_argument("--data_devices", type=int, default=0,
                        help="shard batched groups across this many "
                             "devices: not ported (ROADMAP.md Queue 1 item "
                             "13); a value above 0 exits with code 2")
    parser.add_argument("--allow_cpu_devices", action="store_true",
                        help="accepted for the JAX CLI's sake; no effect")
    parser.add_argument("--warmup", action="append", default=[],
                        metavar="HxW[:HxW]",
                        help="run a synthetic job of this ON-DISK image "
                             "size through the serving path at startup; "
                             "'HxW:HxW' gives content and style sizes "
                             "separately (one HxW uses it for both). May be "
                             "repeated; with --batch N a batch of N is "
                             "warmed too.")
    # shared stylization knobs (same names and defaults as the CLI)
    parser.add_argument("--max_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--level", type=int, default=4)
    parser.add_argument("--max_iter", type=int, default=200)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--use_keras_weight", action="store_true")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_pallas", action="store_true")
    parser.add_argument("--sinkhorn", action="store_true")
    parser.add_argument("--sample_size", type=int, default=1024)
    parser.add_argument("--taps", type=str, default=None)
    parser.add_argument("--start_level", type=int, default=0)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--device_id", "--gpu_id", type=int, default=0,
                        dest="device_id")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    return parser


def _config(args, job: Dict) -> StrotssConfig:
    return StrotssConfig(
        lr=args.lr,
        levels=args.level,
        max_iter=args.max_iter,
        alpha=float(job.get("alpha", args.alpha)),
        max_size=args.max_size,
        sample_size=args.sample_size,
        use_keras_weight=args.use_keras_weight,
        compute_dtype=args.compute_dtype,
        seed=int(job.get("seed", args.seed)),
        start_level=int(job.get("start_level", args.start_level)),
        remat=args.remat,
        log_every=args.max_iter,  # one chunk a scale: no host wait inside
        use_pallas=not args.no_pallas,
        precompile=False,
        use_sinkhorn=args.sinkhorn,
        taps=tuple(args.taps.split(",")) if args.taps else None,
    )


def _device(args) -> str:
    return "cpu" if args.cpu else f"cuda:{args.device_id}"


def _load_job_inputs(args, job: Dict):
    from strotss_torch.ops.masks import load_mask
    from strotss_torch.utils.io import load_image

    for field in ("content", "output"):
        if field not in job:
            raise ValueError(f"job is missing required field '{field}'")
    if ("style" in job) == ("styles" in job):
        raise ValueError(
            "job needs exactly one of 'style' (a path) or 'styles' "
            "(a list of paths for multi-style blending)")
    content = load_image(job["content"], max_size=args.max_size)
    if "styles" in job:
        paths = job["styles"]
        if not isinstance(paths, list) or not paths:
            raise ValueError("'styles' must be a non-empty list of paths")
        style = [load_image(p, max_size=args.max_size) for p in paths]
        weights = job.get("style_weights")
        if weights is not None and (
                not isinstance(weights, list) or len(weights) != len(paths)):
            raise ValueError(
                f"'style_weights' must be a list of {len(paths)} numbers "
                "(one per style)")
    else:
        if "style_weights" in job:
            raise ValueError(
                "'style_weights' requires 'styles' (a list) — a single "
                "'style' path has nothing to blend with")
        style = load_image(job["style"], max_size=args.max_size)
        weights = None
    cmask = smask = None
    has_c, has_s = "content_mask" in job, "style_mask" in job
    if has_c != has_s:
        raise ValueError(
            "Either both content and style masks must be provided or "
            "neither.")
    if has_c:
        cmask, smask = load_mask(job["content_mask"], job["style_mask"],
                                 max_size=args.max_size)
    init = None
    if "init" in job:
        init = load_image(job["init"], max_size=args.max_size)
    return content, style, cmask, smask, init, weights


def _final_loss(info: Dict) -> Optional[float]:
    scales = info.get("scales") or []
    if scales and "loss" in scales[-1]:
        return float(scales[-1]["loss"])
    return None


def _run_single(args, job: Dict, vgg_params) -> Dict:
    from strotss_torch.api import stylize
    from strotss_torch.utils.io import write_image

    content, style, cmask, smask, init, weights = _load_job_inputs(args, job)
    t0 = time.perf_counter()
    img, info = stylize(content, style, _config(args, job),
                        content_masks=cmask, style_masks=smask,
                        vgg_params=vgg_params, init_image=init,
                        style_weights=weights, device=_device(args))
    write_image(img, job["output"])
    out = {"output": job["output"], "ok": True,
           "seconds": round(time.perf_counter() - t0, 3)}
    loss = _final_loss(info)
    if loss is not None:
        out["loss"] = loss
    return out


def _batchable(job: Dict) -> bool:
    """Whether a job may join a batch group. Pairs of a batch share one
    configuration: masks, ``start_level`` (it changes which scales run)
    and blends opt out. ``alpha`` and ``seed`` ride the pair axis, and
    warm jobs batch with warm jobs (the shape signature keeps groups warm
    or cold). A chain within one stream stays sequential through the main
    loop's dependency flush."""
    return not any(k in job for k in
                   ("content_mask", "style_mask", "start_level",
                    "styles", "style_weights"))


def _run_batch(args, jobs: List[Dict], vgg_params) -> List[Dict]:
    import torch

    from strotss_torch.ops.image import resize_bilinear
    from strotss_torch.parallel.batch import stylize_batch
    from strotss_torch.programs import warm_init_hw
    from strotss_torch.utils.io import write_image

    contents, styles, inits = [], [], []
    for job in jobs:
        c, s, _, _, init, _ = _load_job_inputs(args, job)
        contents.append(c)
        styles.append(s)
        if init is not None:
            inits.append(init)
    # each job runs under its own alpha and seed: pair b draws from its
    # job's seed as the single path does (scheduler invariance)
    alphas = [float(job.get("alpha", args.alpha)) for job in jobs]
    seeds = [int(job.get("seed", args.seed)) for job in jobs]
    if inits and len(inits) != len(jobs):  # pragma: no cover - sig guard
        raise ValueError("warm and cold jobs cannot share a batch group")
    if inits:
        # per-job inits may differ in size: stack them at the first
        # executed scale's resolution, the single path's one resample
        # (never through the content's shape: two resamples would part a
        # chained frame's batched trajectory from its single run)
        chw0 = warm_init_hw(contents[0].shape[1], contents[0].shape[2],
                            _config(args, {}))
        inits = [resize_bilinear(init, chw0) for init in inits]
    t0 = time.perf_counter()
    imgs, info = stylize_batch(torch.cat(contents), torch.cat(styles),
                               _config(args, {}), vgg_params=vgg_params,
                               init_images=(torch.cat(inits) if inits
                                            else None),
                               alphas=alphas, pair_seeds=seeds,
                               device=_device(args))
    per = round((time.perf_counter() - t0) / len(jobs), 3)
    scales = info.get("scales") or []
    curve = scales[-1]["curve"] if scales else None  # (n, B, 3)
    results = []
    for b, job in enumerate(jobs):
        write_image(imgs[b], job["output"])
        result = {"output": job["output"], "ok": True,
                  "seconds": per, "batched": len(jobs)}
        if curve is not None and len(curve):
            result["loss"] = float(curve[-1, b, 0])
        results.append(result)
    return results


def _warmup(args, vgg_params) -> None:
    """One synthetic job per ``--warmup HxW`` bucket through the serving
    path, its output discarded. With ``--batch N`` a batch of N too, and
    always the single path (jobs that do not batch, flushes of one, the
    retry after a failed batch)."""
    import tempfile

    import numpy as np
    from PIL import Image

    def parse_hw(part, spec):
        try:
            h, w = (int(v) for v in part.split("x"))
            return h, w
        except ValueError:
            raise ValueError(
                f"--warmup expects HxW or HxW:HxW (e.g. 512x512 or "
                f"321x481:1600x1200), got {spec!r}")

    with tempfile.TemporaryDirectory() as td:
        for i, spec in enumerate(args.warmup):
            parts = spec.lower().split(":")
            if len(parts) > 2:
                raise ValueError(
                    f"--warmup expects HxW or HxW:HxW, got {spec!r}")
            sizes = [parse_hw(p, spec) for p in parts]
            if len(sizes) == 1:
                sizes = sizes * 2  # one size: content and style share it
            rng = np.random.default_rng(0)
            paths = []
            for (h, w), name in zip(sizes, ("c", "s")):
                img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
                p = os.path.join(td, f"warm{i}_{name}.png")
                Image.fromarray(img).save(p)
                paths.append(p)
            job = {"content": paths[0], "style": paths[1],
                   "output": os.path.join(td, f"warm{i}_out.png")}
            t0 = time.perf_counter()
            if args.batch > 1:
                _run_batch(args, [dict(job) for _ in range(args.batch)],
                           vgg_params)
            _run_single(args, job, vgg_params)
            logger.info(f"Warmed shape bucket {spec} in "
                        f"{time.perf_counter() - t0:.1f}s.")


# tells "signal.signal failed (not the main thread)" from "the previous
# handler is None (installed from C, not restorable)"
_SIGNALS_UNAVAILABLE = object()


def _install_sigterm(state: Dict):
    """SIGTERM sets ``state['draining']`` and nothing else: it never
    raises, so a job line is never read and lost and a job in flight is
    never cut mid-write. Every blocking wait polls the flag
    (``_LineReader.readline``). Returns the previous handler (None for one
    installed from C), or ``_SIGNALS_UNAVAILABLE`` outside the main thread
    (then a drain means finishing the stream)."""

    def on_sigterm(signum, frame):
        state["draining"] = True

    try:
        return signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        return _SIGNALS_UNAVAILABLE


def _restore_sigterm(prev) -> None:
    if prev is _SIGNALS_UNAVAILABLE:
        return
    # a handler installed from C cannot be set again through the signal
    # module: the default action keeps "a second SIGTERM kills"
    signal.signal(signal.SIGTERM,
                  prev if prev is not None else signal.SIG_DFL)


class _LineReader:
    """Line reads from a (possibly blocking) job stream that a drain can
    interrupt without losing a line.

    A signal handler that raises out of ``readline`` can lose a line the
    stream already gave up. Instead one daemon thread reads strictly on
    request (no read-ahead to lose), and the caller waits on a queue with
    a timeout, polling the drain flag between ticks."""

    _POLL_SECONDS = 0.25

    def __init__(self, stream):
        import queue
        import threading

        self._stream = stream
        self._req = threading.Semaphore(0)
        self._lines: "queue.Queue" = queue.Queue()
        self._empty = queue.Empty
        self._outstanding = False
        t = threading.Thread(target=self._reader, daemon=True,
                             name="strotss-serve-jobs")
        t.start()

    def _reader(self):
        while True:
            self._req.acquire()
            try:
                line = self._stream.readline()
            except Exception:
                line = ""  # the stream closed under us: report EOF
            self._lines.put(line)
            if not line:
                return

    def readline(self, should_stop) -> Optional[str]:
        """The next raw line; "" at EOF; None when ``should_stop()`` turned
        true while waiting (the request stays live, so a line that comes
        later is returned by a later call, not lost)."""
        if not self._outstanding:
            self._req.release()
            self._outstanding = True
        while True:
            try:
                line = self._lines.get(timeout=self._POLL_SECONDS)
                self._outstanding = False
                return line
            except self._empty:
                if should_stop():
                    return None

    def grace_line(self, timeout: float = 0.5) -> Optional[str]:
        """A last chance for a read a drain left outstanding.

        When ``readline`` returned None the reader thread may already have
        taken a line from the stream (it was blocked in
        ``stream.readline()`` when the flag flipped). Reads go strictly on
        request, so at most one line can be in that state, and one bounded
        wait covers it. Returns the line, or None if none came within
        ``timeout``."""
        if not self._outstanding:
            return None
        try:
            line = self._lines.get(timeout=timeout)
            self._outstanding = False
            return line or None  # "" = EOF, nothing to recover
        except self._empty:
            return None


def _job_lines(path: str, should_stop=lambda: False):
    """Yield job lines; ends at EOF or when ``should_stop()`` turns true
    (checked during every blocking wait and between lines)."""
    stream = sys.stdin if path == "-" else open(path)
    reader = _LineReader(stream)
    try:
        while True:
            line = reader.readline(should_stop)
            if line is None:  # a drain while a read was pending: the
                # reader may have taken a line in that window; recover it,
                # so a line read from the stream still gets its result
                line = reader.grace_line()
                if line:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        yield line
                break
            if not line:  # "" = EOF
                break
            line = line.strip()
            if line and not line.startswith("#"):
                yield line
            if should_stop():
                break
    finally:
        if stream is not sys.stdin:
            stream.close()


def _shape_sig(args, job: Dict):
    """The loaded images' shapes, for batch grouping (headers only), and
    whether the job is warm: warm and cold jobs seed their first scale
    differently, so groups stay one or the other. Init sizes do not
    matter: each is resized once to the first executed scale's size."""
    from strotss_torch.utils.io import image_size

    try:
        return (image_size(job["content"], max_size=args.max_size),
                image_size(job["style"], max_size=args.max_size),
                "init" in job)
    except Exception:
        return None  # let the single path report the real error


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # stdout is the results stream by default: every line the shared
    # logger writes (the weights loader, write_image, the warm-up, the
    # summary) goes to stderr
    from strotss_torch.utils.logging import route_to_stderr

    route_to_stderr()
    if args.data_devices > 0:
        logger.error(
            f"--data_devices {args.data_devices}: sharding batches over "
            "several devices is not ported to strotss_torch yet (ROADMAP.md "
            "Queue 1 item 13); drop the flag to serve on one device")
        return 2

    from strotss_torch.api import resolve_device
    from strotss_torch.models.weights import load_vgg_params

    try:
        resolve_device(_device(args))
    except (RuntimeError, ValueError) as e:
        logger.error(str(e))
        return 2
    vgg_params = load_vgg_params("16", args.use_keras_weight)  # all jobs

    if args.warmup:
        _warmup(args, vgg_params)

    out = sys.stdout if args.results == "-" else open(args.results, "w")

    def emit(result: Dict):
        out.write(json.dumps(result) + "\n")
        out.flush()

    def run(jobs: List[Dict]):
        if len(jobs) > 1:
            try:
                for r in _run_batch(args, jobs, vgg_params):
                    emit(r)
                return
            except Exception:
                # one bad input fails the whole batch: retry the jobs
                # singly, so the good ones complete and only the bad one
                # emits its (precise) error
                pass
        for job in jobs:
            try:
                emit(_run_single(args, job, vgg_params))
            except Exception as e:  # serving survives bad jobs
                emit({"output": job.get("output"), "ok": False,
                      "error": f"{type(e).__name__}: {e}"})

    n_done = 0
    t_start = time.perf_counter()
    pending: List[Dict] = []
    pending_sig = None
    sig_state: Dict = {"draining": False}
    prev_handler = _install_sigterm(sig_state)
    try:
        for line in _job_lines(args.jobs,
                               should_stop=lambda: sig_state["draining"]):
            try:
                job = json.loads(line)
                if not isinstance(job, dict):
                    raise ValueError("job line must be a JSON object")
            except ValueError as e:
                emit({"ok": False, "error": f"bad job line: {e}"})
                continue
            sig = (_shape_sig(args, job)
                   if args.batch > 1 and _batchable(job) else None)
            # a warm job whose init IS a pending job's output depends on
            # it: flush the group first, so the init is read after its
            # producer wrote it (and never a stale file of an earlier run)
            depends = sig is not None and "init" in job and any(
                os.path.abspath(p.get("output", "")) ==
                os.path.abspath(job["init"]) for p in pending)
            if pending and (sig is None or sig != pending_sig or depends):
                batch, pending = pending, []
                run(batch)
                n_done += len(batch)
            if sig is None:
                run([job])
                n_done += 1
            else:
                pending.append(job)
                pending_sig = sig
                # a full batch runs now: a queue feeding stdin must not
                # leave N formed jobs waiting for job N + 1
                if len(pending) >= args.batch:
                    batch, pending = pending, []
                    run(batch)
                    n_done += len(batch)
        if sig_state["draining"]:
            logger.info(f"SIGTERM: draining {len(pending)} pending job(s), "
                        "then exiting.")
        # restored before the drain: a second SIGTERM aborts it
        _restore_sigterm(prev_handler)
        prev_handler = _SIGNALS_UNAVAILABLE  # not restored twice
        if pending:
            run(pending)
            n_done += len(pending)
    finally:
        _restore_sigterm(prev_handler)
        if out is not sys.stdout:
            out.close()
    logger.info(f"Served {n_done} jobs in "
                f"{time.perf_counter() - t_start:.2f}s.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
