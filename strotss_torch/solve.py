"""The coarse-to-fine STROTSS driver, the counterpart of
``strotss_tpu/solve.py`` (``stylize_single``, lines 75-571) and of the
per-scale shapes of ``strotss_tpu/aot.py:90-114``.

A loop over scales (long edge 64 -> 128 -> 256 -> 512 by default); per
scale, ``max_iter`` RMSprop steps on the Laplacian-pyramid coefficients of
the stylized image. Alpha starts at ``cfg.initial_alpha()`` and halves per
scale; the last scale runs at half the learning rate. Besides one style:
region masks (each region pairs a content region with a style region, has
its own style targets and coordinates each step, and the loss averages
the regions), a blend of several styles (the style target mixes samples
of each style in proportion to its weight), a warm start from an image,
skipped coarse scales (``start_level``) and checkpoints that an
interrupted run resumes from. Under a mesh every rank runs the loop,
``cfg.shard_samples`` splits the transport terms' style samples (REMD
or Sinkhorn) over the mesh's 'sample' axis, and ``cfg.shard_spatial``
runs VGG (the per-scale content and style extractions and every step's
forward and backward) on each rank's rows of the images over its
'spatial' axis
(:mod:`strotss_torch.parallel.spatial`; the content features stay split
for the scale). Every rank then holds a replica of the pyramid: the
run takes PyTorch's deterministic algorithms, and the replicas are
checked to agree bit for bit after each scale (:func:`check_replicas`).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from strotss_torch import graphs
from strotss_torch.config import StrotssConfig
from strotss_torch.models.vgg import VGG
from strotss_torch.ops.image import (
    cap_max,
    fold_laplacian_pyramid,
    postprocess,
    resize_bilinear,
    resize_max_hw,
)
from strotss_torch.ops.losses import moment_stats
from strotss_torch.ops.sampling import (
    full_grid_coords,
    prepare_mask,
    sample_style,
    strided_grid_coords,
)
from strotss_torch.programs import (
    RMSprop,
    extract_hypercolumn,
    optimization_steps,
    precision,
    scale_seed,
    spec_from_config,
    style_sample_counts,
    warm_init_hw,
)
from strotss_torch.utils import checkpoint as ckpt
from strotss_torch.utils.logging import logger
from strotss_torch.utils.timing import span, timed
from strotss_torch.validation import check_start_level

#: ``coords_source(scale_index, kind, step, hw, sample_size)`` returns the
#: (sample_size, 2) coordinates for ``kind`` 'style' (once per scale,
#: step -1) or 'paired' (each step) at base resolution ``hw``. Under
#: region masks it takes a sixth argument, the region index, and is
#: called once per region; under blending the style draws take the
#: style's index there, one call a style at its own ``hw`` and count.
CoordsSource = Callable[..., torch.Tensor]


def scale_mode_shapes(cfg: StrotssConfig, content_shape, style_shape,
                      scale_index: int, scl: int, warm_start: bool = False):
    """(mode, chw, shw) of one scale: 'first', 'mid' or 'last' and the
    content and style shapes resized to long edge ``scl``. Under blending
    ``style_shape`` is a tuple of shapes and ``shw`` a tuple of theirs.
    Under a warm start scale 0 seeds by the 'mid' rule from the init
    image."""
    chw = resize_max_hw(content_shape[1], content_shape[2], scl)
    if isinstance(style_shape[0], (tuple, list)):
        shw = tuple(resize_max_hw(s[1], s[2], scl) for s in style_shape)
    else:
        shw = resize_max_hw(style_shape[1], style_shape[2], scl)
    mode = "first" if scale_index == 0 else (
        "mid" if scale_index < cfg.levels - 1 else "last")
    if scale_index == 0 and warm_start:
        mode = "mid"
    return mode, chw, shw


def scale_generators(seed: int, scale_index: int,
                     device) -> Tuple[torch.Generator, torch.Generator]:
    """Scale ``scale_index``'s two generators on ``device``: the style
    draws' and the per-step draws', seeded from (seed, scale_index, 0) and
    (seed, scale_index, 1) through numpy's ``SeedSequence``. Each scale
    draws from its own streams, as the JAX package folds the scale into
    its key (``strotss_tpu/solve.py:345``), so a refine from a later scale
    and a resume in the middle of a scale draw what the full run drew."""
    gens = []
    for stream in (0, 1):
        words = np.random.SeedSequence(
            [seed % 2 ** 64, scale_index, stream]).generate_state(2)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(words[0]) | (int(words[1]) & 0x7FFFFFFF) << 32)
        gens.append(gen)
    return gens[0], gens[1]


def sample_group(cfg: StrotssConfig, mesh, entry: str, example: str):
    """The up-front mesh contracts of ``entry`` (``strotss_tpu/solve.py:
    226-242``), and the process groups of the mesh's 'sample' axis under
    ``cfg.shard_samples`` and of its 'spatial' axis under
    ``cfg.shard_spatial`` (each else None)."""
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    # a silent single-device run would betray the explicit request
    if cfg.shard_spatial and "spatial" not in names:
        raise ValueError(
            "cfg.shard_spatial needs a mesh with a 'spatial' axis — pass "
            "stylize(..., mesh=make_mesh((N,), ('spatial',)))")
    if cfg.shard_samples and "sample" not in names:
        raise ValueError(
            "cfg.shard_samples needs a mesh with a 'sample' axis — pass "
            f"{entry}(..., mesh=make_mesh({example}))")
    return (mesh.get_group("sample") if cfg.shard_samples else None,
            mesh.get_group("spatial") if cfg.shard_spatial else None)


def check_replicas(pyramid: Sequence[torch.Tensor], group,
                   scale: int) -> None:
    """The ranks of ``group`` hold replicas of one pyramid (every rank of
    ``stylize_single``'s mesh; each 'sample' group of a batch): raise on
    every one of them when the replicas' bits differ after ``scale``, so
    that a drift fails the run instead of passing silently. Nothing to
    check for ``None`` or a group of one."""
    if group is None or dist.get_world_size(group) == 1:
        return
    flat = torch.cat([p.detach().reshape(-1) for p in pyramid])
    first = flat.clone()
    dist.broadcast(first, dist.get_global_rank(group, 0), group=group)
    differ = torch.ne(first.view(torch.int32),
                      flat.view(torch.int32)).any().to(torch.int32)[None]
    dist.all_reduce(differ, dist.ReduceOp.MAX, group=group)
    if differ.item():
        raise RuntimeError(
            f"the ranks' replicas of the pyramid differ after scale {scale}:"
            " a computation on the mesh is not bitwise repeatable")


def checkpoint_sync(mesh, cfg: StrotssConfig) -> None:
    """Under a mesh with checkpoints: every rank waits here, so that rank
    0, the only writer, never replaces the state another rank has still
    to read, and a callback that stops the run after a chunk finds the
    chunk's state written."""
    if mesh is not None and cfg.checkpoint_dir:
        dist.barrier()


def _coords(coords_source, gen, i, kind, step, hw, n, device,
            masks) -> torch.Tensor:
    """(K, n, 2) coordinates, one draw a region of ``masks`` (``[None]``
    without masks): from ``gen`` (the full grid for 'style', the strided
    grid for 'paired', under the region's mask) or from
    ``coords_source``, which is told the region under masks."""
    if coords_source is not None:
        return torch.stack([
            coords_source(i, kind, step, hw, n,
                          *(() if m is None else (r,)))
            for r, m in enumerate(masks)])
    draw = full_grid_coords if kind == "style" else strided_grid_coords
    return torch.stack([draw(gen, hw, n, device, mask=m) for m in masks])


def _blend_plan(style, style_weights, cfg: StrotssConfig, masked: bool):
    """(style, style_ns, weights): a single style passes through with
    ``None``s; a list of styles becomes the tuple of those whose
    largest-remainder count is above 0, their counts and their weights
    (``strotss_tpu/solve.py:125-177``). One survivor is the single-style
    run exactly."""
    if not isinstance(style, (list, tuple)):
        if style_weights is not None:
            raise ValueError(
                "style_weights was given with a single style image — pass "
                "a list of styles to blend, or drop the weights")
        return style, None, None
    styles = list(style)
    if len(styles) == 0:
        raise ValueError("style list must not be empty")
    if style_weights is None:
        style_weights = [1.0] * len(styles)
    if len(style_weights) != len(styles):
        raise ValueError(
            f"style_weights has {len(style_weights)} entries for "
            f"{len(styles)} styles — one weight per style")
    if masked:
        raise ValueError(
            "multi-style blending is incompatible with region masks — "
            "each mask color pairs one content region with ONE style "
            "region (run_strotss.py:97-125); pass a single style")
    counts = style_sample_counts(style_weights, cfg.sample_size)
    keep = [i for i, n in enumerate(counts) if n > 0]
    dropped = [i for i in range(len(counts))
               if counts[i] == 0 and float(style_weights[i]) > 0]
    if dropped:
        logger.warning(
            f"style_weights {[float(style_weights[i]) for i in dropped]}"
            f" apportion to 0 of {cfg.sample_size} samples — style(s) "
            f"{dropped} dropped entirely (raise the weight or "
            "sample_size to include them).")
    if len(keep) == 1:
        return styles[keep[0]], None, None
    return (tuple(styles[i] for i in keep), tuple(counts[i] for i in keep),
            tuple(float(style_weights[i]) for i in keep))


def _fingerprint(cfg, spec, content, style, multi, style_ns, weights,
                 n_regions, warm) -> Dict:
    """What decides the trajectory (``strotss_tpu/solve.py:259-298``),
    and the package: a checkpoint of the JAX package never matches."""
    fp = {
        "package": "strotss_torch",
        "lr": cfg.lr,
        "levels": cfg.levels,
        "max_iter": cfg.max_iter,
        "alpha": cfg.alpha,
        "pyramid_levels": cfg.pyramid_levels,
        "seed": cfg.seed,
        "spec": [list(v) if isinstance(v, tuple) else v for v in spec],
        "content_shape": list(content.shape),
        "style_shape": ([list(s.shape) for s in style] if multi
                        else list(style.shape)),
        "n_regions": n_regions,
    }
    if multi:
        fp["style_weights"] = list(weights)
        fp["style_ns"] = list(style_ns)
    if warm:
        fp["warm_start"] = True
    if cfg.start_level:
        fp["start_level"] = cfg.start_level
    return fp


def _state(pyramid, opt: RMSprop, step_gen: torch.Generator) -> Dict:
    """The checkpointed state of the scale in progress, by name."""
    state = {f"pyramid.{k}": p for k, p in enumerate(pyramid)}
    state.update({f"nu.{k}": v for k, v in enumerate(opt.nu)})
    state["rng"] = step_gen.get_state()
    return state


def stylize_single(
    content: torch.Tensor,
    style,
    cfg: StrotssConfig,
    vgg_params,
    progress_cb: Optional[Callable[[int, int, int, Dict[str, float]],
                                   None]] = None,
    snapshot_cb: Optional[Callable[[int, int, torch.Tensor], None]] = None,
    coords_source: Optional[CoordsSource] = None,
    content_masks: Optional[torch.Tensor] = None,
    style_masks: Optional[torch.Tensor] = None,
    init_image: Optional[torch.Tensor] = None,
    style_weights=None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """Full coarse-to-fine stylization of one (content, style) pair.

    ``content``/``style``: (1,H,W,3) float32 tensors in [0,1] on the device
    the run uses; ``content_masks``/``style_masks``: optional (K,H,W,1)
    float 0/1 region stacks on that device, at any resolution (each scale
    resizes them, :func:`prepare_mask`). ``style`` may be a list of style
    images with ``style_weights`` (one each, >= 0, positive sum): the
    style target then mixes :func:`style_sample_counts` full-grid samples
    of each style, and the first scale seeds from the weight-blended mean
    colour; styles whose count is 0 are dropped, so ``[1, 0]`` is the
    single-style run. Not with masks. ``init_image``: an optional
    (1,H,W,3) warm start, resized once to the first executed scale's
    resolution; that scale seeds from it by the 'mid' rule. Feed a run's
    ``info["stylized"]`` back with ``cfg.start_level`` to refine it.

    Returns (uint8 HWC image on that device, info dict with per-scale
    losses, alphas, timings and loss curves, ``n_regions`` and the float
    ``stylized`` image). ``progress_cb`` is called for every step,
    replayed at each ``log_every`` boundary, when the losses are read back
    from the device. With ``cfg.checkpoint_dir`` the state is saved after
    every chunk (before the callbacks run), and a run that finds a
    checkpoint of the same configuration there resumes from it.
    ``coords_source`` replaces the sampling generators (tests replay the
    JAX package's coordinates).

    ``mesh`` (:func:`strotss_torch.parallel.make_mesh`): every rank of it
    calls with the same inputs, on its own device, and returns the whole
    result. Under ``cfg.shard_samples`` the transport terms split the
    style samples over its 'sample' axis, under ``cfg.shard_spatial`` VGG
    runs on each rank's rows of the images over its 'spatial' axis; every
    rank draws the same coordinates from the same seeded generators, with
    no traffic. Only rank 0 writes
    checkpoints and calls ``snapshot_cb``; every rank calls
    ``progress_cb``.
    """
    group, spatial_group = sample_group(cfg, mesh, "stylize",
                                        "(N,), ('sample',)")
    lead = mesh is None or mesh.get_rank() == 0
    # under a mesh every rank holds the whole pyramid
    replicas = None if mesh is None else dist.group.WORLD
    device = content.device
    masked = content_masks is not None
    style, style_ns, weights = _blend_plan(style, style_weights, cfg, masked)
    multi = style_ns is not None
    content = cap_max(content, cfg.max_size)
    style = (tuple(cap_max(s, cfg.max_size) for s in style) if multi
             else cap_max(style, cfg.max_size))
    check_start_level(cfg)
    warm = init_image is not None
    if warm:
        init_image = resize_bilinear(init_image, warm_init_hw(
            content.shape[1], content.shape[2], cfg))
    # ValueError on a bad block1_impl
    spec = spec_from_config(cfg, device, masked=masked)
    spatial = None
    if spatial_group is not None:
        from strotss_torch.parallel.spatial import Spatial

        spatial = Spatial(spatial_group, spec.taps)
    if snapshot_cb is not None and cfg.save_every > 0 and cfg.max_iter > 0:
        # snapshots fire at chunk boundaries: chunk at the coarsest size
        # of which every save_every multiple is one
        cadence = math.gcd(max(1, min(cfg.log_every, cfg.max_iter)),
                           min(cfg.save_every, cfg.max_iter))
        if cadence != cfg.log_every:
            cfg = dataclasses.replace(cfg, log_every=cadence)
    n_regions = int(content_masks.shape[0]) if masked else 0
    # the step may replay a CUDA graph where its coordinates are the step
    # generator's draws alone, on one device (programs.step_route)
    own_draws = coords_source is None and mesh is None
    fingerprint = _fingerprint(cfg, spec, content, style, multi, style_ns,
                               weights, n_regions, warm)
    resume = ckpt.load_meta(cfg.checkpoint_dir)
    if resume is not None:
        ckpt.check_fingerprint(resume, fingerprint, cfg.checkpoint_dir)
        if resume["scale_index"] >= cfg.levels:
            raise ValueError(
                f"Checkpoint scale_index {resume['scale_index']} is out of "
                f"range for levels={cfg.levels} — config mismatch with the "
                "saved run. Delete the checkpoint directory to start fresh.")

    with precision(spec, deterministic=mesh is not None), \
            span("call", pairs=1, regions=max(n_regions, 1)):
        vgg = VGG({k: {n: t.to(device) for n, t in p.items()}
                   for k, p in vgg_params.items()},
                  taps=spec.taps, vgg_type=spec.vgg_type,
                  preprocess_mode=spec.preprocess_mode,
                  compute_dtype=spec.compute_dtype,
                  block1_impl=spec.block1_impl)
        n = spec.sample_size
        consumer = (progress_cb is not None or bool(cfg.checkpoint_dir)
                    or (snapshot_cb is not None and cfg.save_every > 0))
        chunk = max(1, min(cfg.log_every if consumer else cfg.max_iter,
                           cfg.max_iter))

        alpha = cfg.initial_alpha()
        # a warm start's init plays scale 0's previous stylization
        stylized = init_image if warm else None
        final_u8 = None
        info: Dict = {"scales": [], "n_regions": n_regions}
        t_total = time.perf_counter()
        for i, scl in enumerate(cfg.scale_sizes()):
            if i < cfg.start_level or (resume is not None
                                       and i < resume["scale_index"]):
                # skipped: never run, never drawn from; alpha still halves
                # so each scale that runs sees a full run's alpha
                alpha /= 2.0
                continue
            with timed("scale", index=i, px=scl) as clock:
                with span("scale.setup"):
                    mode, chw, shw = scale_mode_shapes(
                        cfg, content.shape,
                        tuple(s.shape for s in style) if multi
                        else style.shape, i, scl, warm)
                    lr = (cfg.lr / 2 if (i == cfg.levels - 1 and i > 0)
                          else cfg.lr)
                    prev = stylized if stylized is not None else content
                    style_gen, step_gen = scale_generators(cfg.seed, i,
                                                           device)
                    gens = [step_gen] if own_draws else None
                    with torch.no_grad():
                        scl_c, scl_s, pyramid = scale_seed(
                            mode, chw, shw, cfg.pyramid_levels, content,
                            style, prev, style_weights=weights)
                    pyramid = [p.detach().contiguous() for p in pyramid]
                    opt = RMSprop(pyramid, lr)
                    done = 0
                    if resume is not None:  # i is the checkpoint's scale
                        saved = ckpt.restore_state(
                            cfg.checkpoint_dir, _state(pyramid, opt, step_gen))
                        with torch.no_grad():
                            for k, p in enumerate(pyramid):
                                p.copy_(saved[f"pyramid.{k}"])
                            for k, v in enumerate(opt.nu):
                                v.copy_(saved[f"nu.{k}"])
                        step_gen.set_state(saved["rng"])
                        alpha = resume["alpha"]
                        done = min(resume["done_steps"], cfg.max_iter)
                        resume = None
                        checkpoint_sync(mesh, cfg)

                    curve: List[torch.Tensor] = []
                    ran = done < cfg.max_iter
                    if ran:
                        with torch.no_grad():
                            content_feats = extract_hypercolumn(vgg, scl_c,
                                                                spatial)
                            style_targets = _style_targets(
                                vgg, coords_source, style_gen, i, scl_s, shw,
                                n, style_ns, device, style_masks, spatial,
                                spec.sample_impl)
                            style_moments = [
                                moment_stats(t, spec.moments_impl)
                                for t in style_targets]
                        cmasks = ([prepare_mask(m, chw)
                                   for m in content_masks]
                                  if masked else [None])

                        def coords_fn(t, i=i, chw=chw, cmasks=cmasks,
                                      step_gen=step_gen):
                            return _coords(coords_source, step_gen, i,
                                           "paired", t, chw, n, device,
                                           cmasks)

                while done < cfg.max_iter:
                    k = min(chunk, cfg.max_iter - done)
                    curve.append(optimization_steps(
                        spec, k, vgg, content_feats, style_targets,
                        style_moments, alpha, pyramid, opt,
                        lambda t, d=done: coords_fn(d + t), group, spatial,
                        gens))
                    image = None
                    if cfg.checkpoint_dir or (snapshot_cb is not None
                                              and cfg.save_every > 0):
                        with torch.no_grad():
                            stylized = fold_laplacian_pyramid(pyramid)
                            image = postprocess(stylized)
                    if cfg.checkpoint_dir and lead:
                        ckpt.save_state(
                            cfg.checkpoint_dir, i, done + k, alpha,
                            _state(pyramid, opt, step_gen),
                            fingerprint=fingerprint,
                            extras={"stylized": stylized, "image_u8": image})
                    checkpoint_sync(mesh, cfg)
                    if progress_cb is not None:
                        with span("scale.readback"):
                            block = curve[-1].cpu().numpy()
                        for j in range(k):
                            progress_cb(scl, done + j + 1, cfg.max_iter,
                                        {"loss": float(block[j, 0]),
                                         "loss_c": float(block[j, 1]),
                                         "loss_s": float(block[j, 2])})
                    done += k
                    if (lead and snapshot_cb is not None
                            and cfg.save_every > 0
                            and (done % cfg.save_every == 0
                                 or done == cfg.max_iter)):
                        snapshot_cb(scl, done, image)
                check_replicas(pyramid, replicas, i)
                kept = ({} if ran or not cfg.checkpoint_dir
                        else ckpt.restore_extras(cfg.checkpoint_dir))
                if "stylized" in kept and "image_u8" in kept:
                    # a resume on a completed chunk boundary: the saved
                    # images go on to the next scale as the interrupted
                    # run made them
                    stylized = torch.from_numpy(kept["stylized"]).to(device)
                    final_u8 = torch.from_numpy(kept["image_u8"]).to(device)
                else:
                    with span("scale.finish"), torch.no_grad():
                        stylized = fold_laplacian_pyramid(pyramid)
                        final_u8 = postprocess(stylized)
                checkpoint_sync(mesh, cfg)
                with span("scale.readback"):
                    curve_np = (torch.cat(curve).cpu().numpy() if curve
                                else np.zeros((0, 3), np.float32))
            entry = {"scale": scl, "alpha": alpha, "curve": curve_np,
                     "seconds": clock.seconds}
            if len(curve_np):
                entry.update(loss=float(curve_np[-1, 0]),
                             loss_c=float(curve_np[-1, 1]),
                             loss_s=float(curve_np[-1, 2]))
            info["scales"].append(entry)
            alpha /= 2.0
        info["seconds"] = time.perf_counter() - t_total
    # the step graphs of this call's scale shapes stay for the next call
    graphs.end_call()
    # the float image before quantization: feed it back as ``init_image``
    # to refine (postprocess renormalizes, so the uint8 image would move
    # the next run's seed)
    info["stylized"] = stylized
    return final_u8, info


def _style_targets(vgg, coords_source, gen, i, scl_s, shw, n, style_ns,
                   device, style_masks, spatial=None,
                   impl: str = "plain") -> torch.Tensor:
    """(K, n, C) style targets of one scale, drawn from the scale's style
    generator: one a region of the raw ``style_masks`` (K = 1 without
    masks) or, under blending, ``style_ns[j]`` full-grid samples of each
    style ``j`` in turn, their rows concatenated
    (``strotss_tpu/programs.py:319-336``). Under ``spatial`` each style's
    VGG runs on this rank's rows of it. ``impl``: the gathers' route."""
    if style_ns is not None:
        parts = []
        for j, (img, hw, n_j) in enumerate(zip(scl_s, shw, style_ns)):
            xy = (coords_source(i, "style", -1, hw, n_j, j)
                  if coords_source is not None
                  else full_grid_coords(gen, hw, n_j, device))
            parts.append(sample_style(xy, extract_hypercolumn(vgg, img,
                                                              spatial),
                                      impl))
        return torch.cat(parts)[None]
    style_feats = extract_hypercolumn(vgg, scl_s, spatial)
    smasks = ([prepare_mask(m, shw) for m in style_masks]
              if style_masks is not None else [None])
    return torch.stack([
        sample_style(xy, style_feats, impl) for xy in _coords(
            coords_source, gen, i, "style", -1, shw, n, device, smasks)])
