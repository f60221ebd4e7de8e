"""CLI of the port: ``python -m strotss_torch.cli content style -o out``.

Same flags, defaults and log messages as ``strotss_tpu/cli.py``. The run
goes to ``cuda:<--gpu_id>`` (alias ``--device_id``); ``--cpu`` asks for the
CPU instead, and without a card and without ``--cpu`` the run stops with
an error rather than falling back. ``--content_mask``/``--style_mask``
run region-guided transfer; ``--style2``/``--style_blend`` and
``--styles``/``--style_weights`` blend styles; ``--init`` warm-starts and,
with ``--start_level``, refines an earlier result; ``--checkpoint_dir``
saves the state after every chunk and resumes from it; ``--remat``
recomputes VGG's activations in the backward pass; ``--profile_dir``
writes a ``torch.profiler`` Chrome trace of the run, with the program's
spans on a track of their own. ``--sinkhorn``
takes the materialized Sinkhorn path below N * M = 2**30 samples and the
streamed one (kernel K4) above, as the JAX package does.
``--no_pallas`` takes the plain PyTorch versions of the loss kernels and
runs VGG block1 as ``F.conv2d`` (cuDNN on the card) instead of kernel K3;
``--no_precompile`` is accepted and changes nothing (nothing is compiled
ahead of the run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from strotss_torch.config import StrotssConfig
from strotss_torch.utils import timing
from strotss_torch.utils.logging import make_logger
from strotss_torch.utils.timing import Timer

logger = make_logger("STROTSS")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="strotss_torch",
        description="STROTSS style transfer on a CUDA card (PyTorch port)",
    )
    parser.add_argument("content_path", type=str)
    parser.add_argument("style_path", type=str)
    parser.add_argument("--content_mask", type=str, default=None)
    parser.add_argument("--style_mask", type=str, default=None)
    parser.add_argument("--max_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--level", type=int, default=4)
    parser.add_argument("--max_iter", type=int, default=200)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--use_keras_weight", action="store_true")
    parser.add_argument("--gpu_id", "--device_id", type=int, default=0,
                        dest="device_id")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--output_path", "-o", type=str, default="output.jpg")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=None,
                        help="steps between progress updates (default: 25 "
                             "when stderr is a TTY, else max_iter)")
    parser.add_argument("--no_pallas", action="store_true",
                        help="plain PyTorch versions instead of the CUDA "
                             "kernels")
    parser.add_argument("--no_precompile", action="store_true",
                        help="accepted for the JAX CLI's sake; no effect")
    parser.add_argument("--sinkhorn", action="store_true",
                        help="full entropic OT instead of relaxed EMD")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "run into this directory")
    parser.add_argument("--save_every", type=int, default=0)
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="chunk-boundary checkpoints; resumes if present")
    parser.add_argument("--sample_size", type=int, default=1024,
                        help="feature samples per step (reference pins 1024)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="autograd anomaly detection (NaN/inf checks)")
    parser.add_argument("--taps", type=str, default=None,
                        help="comma-separated VGG tap layers "
                             "(default: the 9 STROTSS taps)")
    parser.add_argument("--init", type=str, default=None,
                        help="warm-start image: the first scale seeds from "
                             "it (resized) instead of the cold content+"
                             "style-mean seed")
    parser.add_argument("--remat", action="store_true",
                        help="recompute VGG activations in the backward "
                             "pass (torch.utils.checkpoint): less "
                             "activation memory for one more forward")
    parser.add_argument("--style2", type=str, default=None,
                        help="second style image to blend in, in "
                             "proportion to --style_blend")
    parser.add_argument("--style_blend", type=float, default=None,
                        help="weight of --style2 in [0,1] (style_path gets "
                             "1-w; default 0.5). Requires --style2")
    parser.add_argument("--styles", type=str, nargs="+", default=None,
                        help="additional style images beyond style_path to "
                             "blend; weights via --style_weights")
    parser.add_argument("--style_weights", type=float, nargs="+",
                        default=None,
                        help="one non-negative weight per style, style_path "
                             "first (len = 1 + len(--styles)); default "
                             "equal. Requires --styles")
    parser.add_argument("--start_level", type=int, default=0,
                        help="skip the coarsest N scales (alpha still "
                             "halves per skipped scale); with --init a "
                             "refinement pass")
    return parser


def check_blend_args(args: argparse.Namespace) -> None:
    """The blending flags' consistency, before any image is read
    (``strotss_tpu/cli.py:197-226``)."""
    if args.style_blend is not None and not args.style2:
        raise ValueError(
            "--style_blend requires --style2 (nothing to blend with)")
    blend = 0.5 if args.style_blend is None else args.style_blend
    if args.style2 and not 0.0 <= blend <= 1.0:
        raise ValueError(f"--style_blend must be in [0, 1], got {blend}")
    if args.styles and (args.style2 or args.style_blend is not None):
        raise ValueError(
            "--styles is mutually exclusive with --style2/--style_blend "
            "(fold the second style into --styles with --style_weights)")
    if args.style_weights is not None and not args.styles:
        raise ValueError(
            "--style_weights requires --styles (nothing to weight)")
    if args.styles and args.style_weights is not None \
            and len(args.style_weights) != 1 + len(args.styles):
        raise ValueError(
            f"--style_weights needs {1 + len(args.styles)} numbers "
            f"(style_path first, then the {len(args.styles)} --styles), "
            f"got {len(args.style_weights)}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    timer = Timer()
    timer.start()

    import torch

    from strotss_torch.api import resolve_device, stylize
    from strotss_torch.ops.masks import load_mask
    from strotss_torch.utils.io import load_image, write_image

    device = resolve_device("cpu" if args.cpu else f"cuda:{args.device_id}")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.log_every is None:
        args.log_every = 25 if sys.stderr.isatty() else args.max_iter

    cfg = StrotssConfig(
        lr=args.lr,
        levels=args.level,
        max_iter=args.max_iter,
        alpha=args.alpha,
        max_size=args.max_size,
        sample_size=args.sample_size,
        use_keras_weight=args.use_keras_weight,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        log_every=args.log_every,
        use_pallas=not args.no_pallas,
        use_sinkhorn=args.sinkhorn,
        precompile=not args.no_precompile,
        profile_dir=args.profile_dir,
        save_every=args.save_every,
        checkpoint_dir=args.checkpoint_dir,
        taps=tuple(args.taps.split(",")) if args.taps else None,
        start_level=args.start_level,
        remat=args.remat,
    )
    check_blend_args(args)

    content = load_image(args.content_path, max_size=args.max_size)
    style = load_image(args.style_path, max_size=args.max_size)
    style_weights = None
    if args.style2:
        blend = 0.5 if args.style_blend is None else args.style_blend
        style = [style, load_image(args.style2, max_size=args.max_size)]
        style_weights = [1.0 - blend, blend]
        logger.info(
            f"Blending styles: {args.style_path} ({style_weights[0]:.2f}) + "
            f"{args.style2} ({style_weights[1]:.2f}).")
    elif args.styles:
        style = [style] + [load_image(p, max_size=args.max_size)
                           for p in args.styles]
        # bad weight values fail in style_sample_counts with its messages
        style_weights = (list(args.style_weights)
                         if args.style_weights is not None
                         else [1.0] * len(style))
        names = [args.style_path, *args.styles]
        logger.info("Blending styles: " + " + ".join(
            f"{p} ({w:g})" for p, w in zip(names, style_weights)) + ".")
    init_image = None
    if args.init:
        init_image = load_image(args.init, max_size=args.max_size)
        logger.info(f"Warm-starting from {args.init}.")

    content_masks = style_masks = None
    if args.content_mask and args.style_mask:
        content_masks, style_masks = load_mask(
            args.content_mask, args.style_mask, max_size=args.max_size)
        logger.info(f"Loaded {content_masks.shape[0]} masks.")
    elif args.content_mask or args.style_mask:
        raise ValueError(
            "Either both content and style masks must be provided or neither.")

    try:
        from tqdm import tqdm

        # skipped coarse scales never call progress
        bar = tqdm(total=(cfg.levels - cfg.start_level) * cfg.max_iter)
        prog = {"base": 0, "scl": None}

        def progress(scl, done, total, metrics):
            if prog["scl"] != scl:
                if prog["scl"] is not None:
                    prog["base"] += total
                prog["scl"] = scl
            bar.set_description(f"Scale: {scl:4d} - It: {done:4d}")
            bar.set_postfix({k: f"{v:.3f}" for k, v in metrics.items()})
            bar.n = prog["base"] + done
            bar.refresh()
    except ImportError:  # tqdm optional
        bar = None

        def progress(scl, done, total, metrics):
            logger.info(
                f"Scale: {scl:4d} - It: {done:4d}/{total} "
                + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))

    snapshot = None
    if cfg.save_every > 0:
        stem, ext = os.path.splitext(args.output_path)

        def snapshot(scl, it, img):
            write_image(img, f"{stem}_scale{scl}_it{it:04d}{ext or '.jpg'}")

    def run():
        return stylize(content, style, cfg, content_masks=content_masks,
                       style_masks=style_masks, progress_cb=progress,
                       snapshot_cb=snapshot, init_image=init_image,
                       style_weights=style_weights, device=device)

    if cfg.profile_dir:
        final = profiled(run, cfg.profile_dir, device)
    else:
        final, _ = run()
    if bar is not None:
        bar.close()

    timer.stop()
    logger.info(f"Done in {timer.elapsed_time:.2f}s.")
    write_image(final, args.output_path)
    return 0


def profiled(run, directory: str, device):
    """``run()`` under ``torch.profiler`` (the host's activity, and the
    card's on a CUDA device) and :func:`timing.tracing`; the Chrome trace
    goes to ``<directory>/strotss_trace.json``, the spans added to it by
    :func:`add_spans`. Returns ``run()``'s image."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with timing.tracing() as trace, profile(activities=activities) as prof:
        final, _ = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(directory, "strotss_trace.json")
    prof.export_chrome_trace(path)
    add_spans(path, trace.spans)
    logger.info(f"Wrote profiler trace to {path}.")
    return final


def add_spans(path: str, spans) -> None:
    """Append ``spans`` (:class:`timing.Span`) to the Chrome trace at
    ``path`` as complete events on a track of their own (thread 0 of this
    process, named "strotss spans"), in µs on the trace's clock: Unix
    epoch ns less the trace's ``baseTimeNanoseconds``, as the profiler
    writes its own events."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "strotss spans"}}]
    for s in spans:
        events.append({"ph": "X", "cat": "strotss_span", "name": s.name,
                       "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, call_id=s.call_id)})
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)


if __name__ == "__main__":
    sys.exit(main())
