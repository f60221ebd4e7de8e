"""Batched stylization: B (content, style) pairs in one run, the
counterpart of ``strotss_tpu/parallel/batch.py`` (``prepare_scale_batch``
79-145, ``run_chunk_batch`` 148-238, ``stylize_batch`` 241-602).

Pairs are independent stylizations of one shape bucket. Per scale the B
contents and the B styles each go through VGG once, and each step folds
the (B, ...) pyramid into B images, runs VGG once on all of them (one
launch of kernel K3a and one of K3b on the card) and then each pair's
losses (K1, K2a and K2b once a pair and region, in a Python loop). The
loss is the sum over pairs, so each pair's gradient is its single run's
(:func:`strotss_torch.programs.batch_steps`).

Each pair carries its own alpha and its own seed: pair b draws from
``scale_generators(pair_seeds[b], i, device)`` at scale i, as
``stylize_single`` with ``seed=pair_seeds[b]`` does, in the same order
(style draws, then one draw a step), so its trajectory is that run's
with ``cfg.alpha=alphas[b]``. Region masks come as (B, K, H, W, 1) stacks
padded to a common K, with ``region_valid`` (B, K) weights; a pair runs
and draws its regions of nonzero weight, in order, so a pair with K_b
valid regions is its single masked run on those K_b regions.

With a mesh (:func:`strotss_torch.parallel.make_mesh`) every rank calls
with the whole batch; rank d of the mesh's 'data' axis of size D runs
pairs [d B/D, (d + 1) B/D) and the images and curves are gathered, so
every rank returns the whole batch in pair order. Pairs keep their global
seeds, so each pair is its unsharded result (on the card bit for bit
when the caller switches on ``torch.use_deterministic_algorithms``: a
'data' axis holds no replicas, so it runs under the caller's switches, as
an unsharded run does). Under ``cfg.shard_samples`` a (``data``,
``sample``) mesh splits each pair's transport terms over the 'sample'
axis as well (:mod:`strotss_torch.parallel.transport`); the ranks of a
'sample' group hold replicas of their pairs' pyramid, so they run under
the deterministic algorithms and are checked to agree after each scale.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from strotss_torch.api import _to_device, resolve_device
from strotss_torch.config import StrotssConfig
from strotss_torch.models.vgg import VGG
from strotss_torch.models.weights import load_vgg_params
from strotss_torch.ops.image import (
    cap_max,
    fold_laplacian_pyramid,
    postprocess,
    resize_bilinear,
)
from strotss_torch.ops.losses import moment_stats
from strotss_torch.ops.sampling import (
    full_grid_coords,
    prepare_mask,
    sample_style,
    strided_grid_coords,
)
from strotss_torch.programs import (
    PairTerms,
    RMSprop,
    StepSpec,
    batch_steps,
    extract_hypercolumn,
    precision,
    scale_seed,
    spec_from_config,
    warm_init_hw,
)
from strotss_torch.parallel.mesh import axis_size, batch_sharding
from strotss_torch.solve import (
    check_replicas,
    checkpoint_sync,
    sample_group,
    scale_generators,
    scale_mode_shapes,
)
from strotss_torch.utils import checkpoint as ckpt
from strotss_torch.utils.timing import span, timed
from strotss_torch.validation import check_image, check_masks, \
    check_start_level

#: ``coords_source(pair, scale_index, kind, step, hw, sample_size)``: the
#: single path's ``CoordsSource`` with the pair index first; under masks
#: it takes the region's index in the (B, K) stack last.
BatchCoordsSource = Callable[..., torch.Tensor]


def pair_seed(seed: int, b: int) -> int:
    """Pair b's seed when the caller gives none: 63 bits of numpy's
    ``SeedSequence([seed, b])``, so distinct pairs draw distinct streams
    (the counterpart of the JAX package's ``fold_in(key, b)``)."""
    words = np.random.SeedSequence([seed % 2 ** 64, b]).generate_state(2)
    return int(words[0]) | (int(words[1]) & 0x7FFFFFFF) << 32


def _pair_coords(coords_source, gen, b, i, kind, step, hw, n, device,
                 masks, regions) -> torch.Tensor:
    """Pair b's (K_b, n, 2) coordinates, one draw a region it runs
    (``regions``: their indices in the stack, ``masks``: their prepared
    masks; ``[0]`` and ``[None]`` without masks)."""
    if not regions:
        return torch.zeros((0, n, 2), device=device)
    if coords_source is not None:
        return torch.stack([
            coords_source(b, i, kind, step, hw, n,
                          *(() if m is None else (r,)))
            for r, m in zip(regions, masks)]).to(device)
    draw = full_grid_coords if kind == "style" else strided_grid_coords
    return torch.stack([draw(gen, hw, n, device, mask=m) for m in masks])


def prepare_scale_batch(spec: StepSpec, mode: str, chw, shw, levels: int,
                        vgg: VGG, contents, styles, prev, style_gens,
                        scale_index: int, regions, content_masks=None,
                        style_masks=None, coords_source=None):
    """One scale's set-up for the batch (``batch.py:79-145``): resize and
    seed the (B, ...) pyramid, extract the contents' hypercolumns, draw
    each pair's style targets from its style generator, prepare each
    pair's content masks. ``regions[b]``: the region indices pair b runs.
    Returns (pyramid, content_feats, targets, moments, cmasks), the last
    three one entry a pair."""
    device = contents.device
    n = spec.sample_size
    masked = style_masks is not None
    with torch.no_grad():
        scl_c, scl_s, pyramid = scale_seed(mode, chw, shw, levels, contents,
                                           styles, prev)
        content_feats = extract_hypercolumn(vgg, scl_c)
        style_feats = [f.unbind(0) for f in extract_hypercolumn(vgg, scl_s)]
        targets, moments, cmasks = [], [], []
        for b, regs in enumerate(regions):
            smasks = ([prepare_mask(style_masks[b, r], shw) for r in regs]
                      if masked else [None])
            xy = _pair_coords(coords_source, style_gens[b], b, scale_index,
                              "style", -1, shw, n, device, smasks, regs)
            feats = [f[b] for f in style_feats]
            t = (torch.stack([sample_style(c, feats, spec.sample_impl)
                              for c in xy])
                 if len(xy) else xy.new_zeros((0, n, 0)))
            targets.append(t)
            moments.append([moment_stats(r) for r in t])
            cmasks.append([prepare_mask(content_masks[b, r], chw)
                           for r in regs] if masked else [None])
    pyramid = [p.detach().contiguous() for p in pyramid]
    return pyramid, content_feats, targets, moments, cmasks


def run_chunk_batch(spec: StepSpec, n_steps: int, vgg: VGG, content_feats,
                    pairs, pyramid, opt: RMSprop, coords_fn, images=False,
                    sample_group=None):
    """``n_steps`` (>= 1) batched steps (``batch.py:148-238``): the
    (n_steps, B, 3) loss rows on the device and, with ``images``, the
    chunk's float and uint8 images (:func:`_images`), else None."""
    rows = batch_steps(spec, n_steps, vgg, content_feats, pairs, pyramid,
                       opt, coords_fn, sample_group)
    return rows, (_images(pyramid) if images else None)


def _images(pyramid):
    """(float (B, H, W, 3) images, their uint8 images): each pair
    postprocessed on its own, so pairs never renormalize against each
    other (``batch.py:237``)."""
    with torch.no_grad():
        imgs = fold_laplacian_pyramid(pyramid)
        return imgs, torch.stack([postprocess(im[None]) for im in imgs])


def _state(pyramid, opt: RMSprop, step_gens) -> Dict:
    state = {f"pyramid.{k}": p for k, p in enumerate(pyramid)}
    state.update({f"nu.{k}": v for k, v in enumerate(opt.nu)})
    state.update({f"rng.{b}": g.get_state() for b, g in enumerate(step_gens)})
    return state


def _check_pairs(contents, styles, init_images, content_masks, style_masks,
                 region_valid, alphas, pair_seeds, cfg, mesh):
    """The JAX package's checks, word for word where it has them, and the
    port's refusals of what it does not run. Returns (B, alphas as a
    float64 array or None, pair seeds as ints or None, the 'sample'
    process group under ``cfg.shard_samples`` or None)."""
    check_image("contents", contents, batched=True)
    check_image("styles", styles, batched=True)
    if contents.shape[0] != styles.shape[0]:
        raise ValueError(
            f"contents and styles must have the same batch dim, got "
            f"{contents.shape[0]} vs {styles.shape[0]}")
    if init_images is not None:
        check_image("init_images", init_images, batched=True)
        if init_images.shape[0] != contents.shape[0]:
            raise ValueError(
                f"init_images batch dim {init_images.shape[0]} does not "
                f"match the pair batch {contents.shape[0]}")
    check_masks(content_masks, style_masks, region_valid, batched=True,
                batch=contents.shape[0])
    check_start_level(cfg)
    if cfg.shard_spatial:
        raise ValueError(
            "shard_spatial is a single-pair scale-out feature (stylize); "
            "the batched path scales over the mesh's 'data' axis instead")
    group, _ = sample_group(cfg, mesh, "stylize_batch",
                            "(D, S), ('data', 'sample')")
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    if mesh is not None and "data" not in names:
        raise ValueError(
            "stylize_batch shards the pair axis over the mesh's 'data' "
            f"axis, but the given mesh has axes {names} — build "
            "it with make_mesh((D,), ('data',)) (or ('data', 'sample'))")
    B = int(contents.shape[0])
    if mesh is not None and B % axis_size(mesh, "data"):
        raise ValueError(
            f"stylize_batch splits the {B} pairs over the mesh's 'data' "
            f"axis of size {axis_size(mesh, 'data')}: the batch must be a "
            "multiple of it")
    if pair_seeds is not None:
        shape = np.shape(pair_seeds)
        if shape != (B,):
            raise ValueError(
                f"pair_seeds must be {B} per-pair seeds (shape ({B},)); "
                f"got {shape} — passing a single seed instead of one seed "
                "per pair is the usual cause")
        pair_seeds = [int(s) for s in pair_seeds]
    if alphas is not None:
        alphas = np.asarray(alphas, np.float64)
        if alphas.shape != (B,):
            raise ValueError(
                f"alphas must be one value per pair, shape ({B},); got "
                f"{alphas.shape}")
        if not np.all(np.isfinite(alphas)):
            raise ValueError("alphas must be finite")
    return B, alphas, pair_seeds, group


def _regions(region_valid, B: int, k: int):
    """Per pair: the region indices it runs (weight not 0) and its region
    weights, w = valid / max(sum valid, 1) (``strotss_tpu/programs.py:
    670-675``), or ``None`` where they are the mean over those regions
    (every weight 1), which :func:`step_losses` takes as the single run
    does. Without masks ([0], None) a pair."""
    if region_valid is None:
        return [[r for r in range(k)] for _ in range(B)], [None] * B
    valid = np.asarray(region_valid.cpu() if isinstance(
        region_valid, torch.Tensor) else region_valid, np.float64)
    regions, weights = [], []
    for v in valid:
        regs = [r for r in range(k) if v[r] != 0]
        regions.append(regs)
        w = [float(v[r] / max(v.sum(), 1.0)) for r in regs]
        weights.append(None if all(v[r] == 1 for r in regs) else w)
    return regions, weights


def stylize_batch(
    contents,
    styles,
    cfg: Optional[StrotssConfig] = None,
    vgg_params=None,
    mesh=None,
    content_masks=None,
    style_masks=None,
    region_valid=None,
    progress_cb=None,
    init_images=None,
    alphas=None,
    pair_seeds=None,
    coords_source: Optional[BatchCoordsSource] = None,
    device=None,
) -> Tuple[torch.Tensor, Dict]:
    """Coarse-to-fine stylization of B pairs at once.

    ``contents``/``styles``: (B, H, W, 3) float in [0, 1] (numpy arrays or
    tensors), one shape bucket. ``content_masks``/``style_masks``:
    optional (B, K, H, W, 1) region stacks padded to a common K with
    all-zero masks; ``region_valid`` (B, K) marks real regions (default:
    all). ``init_images``: optional (B, H, W, 3) warm starts, each resized
    once to the first executed scale's resolution, as
    ``stylize(init_image=...)`` does. ``alphas``: optional (B,) per-pair
    style strengths (the CLI's ``--alpha``, rescaled and halved per scale
    like ``cfg.alpha``). ``pair_seeds``: optional (B,) per-pair seeds;
    without them pair b's seed is :func:`pair_seed` ``(cfg.seed, b)``.
    ``coords_source`` replaces the generators (tests replay the JAX
    package's per-pair coordinates). ``mesh``: a mesh with a 'data' axis
    whose size divides B (every rank calls with the whole batch, and runs
    its part; see the module). ``device``: ``None`` (the first CUDA card;
    under a mesh the rank's own), ``'cuda:<id>'`` or ``'cpu'``.

    Returns ((B, H', W', 3) uint8 on the run's device, info): ``batch``,
    per scale ``alpha`` (a float when all pairs share it, else a list),
    ``seconds``, ``curve`` (n, B, 3) and the batch mean of its last row
    as ``loss``/``loss_c``/``loss_s``; ``seconds``; ``stylized`` (the
    float (B, H', W', 3) images, to feed back as ``init_images``).

    **Contract**: pair b's trajectory is a ``stylize_single`` run with
    ``seed=pair_seeds[b]`` and ``alpha=alphas[b]``, to float tolerance.
    With ``cfg.checkpoint_dir`` the state (the pyramid, the RMSprop slots,
    the B step generators and the per-pair alphas) is saved after every
    chunk, and a run of the same configuration resumes from it; under a
    mesh rank 0 writes the whole batch's state, so a checkpoint resumes
    with or without a mesh.
    """
    cfg = cfg or StrotssConfig()
    B, alphas, seeds, group = _check_pairs(
        contents, styles, init_images, content_masks, style_masks,
        region_valid, alphas, pair_seeds, cfg, mesh)
    dev = resolve_device(device, mesh)
    if vgg_params is None:
        vgg_params = load_vgg_params(cfg.vgg_type, cfg.use_keras_weight)
    masked = content_masks is not None
    k = int(content_masks.shape[1]) if masked else 1
    regions, weights = _regions(region_valid, B, k)
    if seeds is None:
        seeds = [pair_seed(cfg.seed, b) for b in range(B)]
    spec = spec_from_config(cfg, dev, masked=masked, batched=True)
    # this rank's pairs: all of them without a mesh
    part = slice(0, B) if mesh is None else batch_sharding(mesh, B)
    data = None if mesh is None else mesh.get_group("data")
    lead = mesh is None or mesh.get_rank() == 0
    bl = part.stop - part.start
    if coords_source is not None and part.start:
        src = coords_source
        coords_source = lambda b, *a: src(part.start + b, *a)  # noqa: E731

    # cap, not resize: serve's inputs were resized at load time already
    contents = cap_max(_to_device(contents[part], dev), cfg.max_size)
    styles = cap_max(_to_device(styles[part], dev), cfg.max_size)
    if masked:
        content_masks = _to_device(content_masks[part], dev)
        style_masks = _to_device(style_masks[part], dev)
    warm = init_images is not None
    if warm:
        # one direct resize to the first executed scale's resolution: the
        # single path's resample (a no-op when serve stacked them there)
        init_images = resize_bilinear(
            _to_device(init_images[part], dev),
            warm_init_hw(contents.shape[1], contents.shape[2], cfg))

    fingerprint = {
        "package": "strotss_torch",
        "lr": cfg.lr,
        "levels": cfg.levels,
        "max_iter": cfg.max_iter,
        "alpha": cfg.alpha,
        "pyramid_levels": cfg.pyramid_levels,
        "seed": cfg.seed,
        "spec": [list(v) if isinstance(v, tuple) else v for v in spec],
        "content_shape": [B] + list(contents.shape[1:]),
        "style_shape": [B] + list(styles.shape[1:]),
        "n_regions": k if masked else 0,
    }
    if warm:
        fingerprint["warm_start"] = True
    if cfg.start_level:
        fingerprint["start_level"] = cfg.start_level
    if alphas is not None:
        fingerprint["alphas"] = [float(a) for a in alphas]
    if pair_seeds is not None:
        # explicit seeds steer every draw: a resume with others is refused
        fingerprint["pair_seeds"] = list(seeds)
    resume = ckpt.load_meta(cfg.checkpoint_dir)
    if resume is not None:
        ckpt.check_fingerprint(resume, fingerprint, cfg.checkpoint_dir)
        if resume["scale_index"] >= cfg.levels:
            raise ValueError(
                f"Checkpoint scale_index {resume['scale_index']} out of "
                f"range for levels={cfg.levels}; delete the checkpoint "
                "directory to start fresh.")

    # every pair's alpha (the checkpoint's); this rank's are alpha[part]
    alpha = [cfg.initial_alpha()] * B if alphas is None else [
        dataclasses.replace(cfg, alpha=float(a)).initial_alpha()
        for a in alphas]
    regions, weights, seeds = regions[part], weights[part], seeds[part]
    # the ranks of a 'sample' group hold replicas of their pairs' pyramid;
    # a 'data' axis alone runs each pair on one rank
    with precision(spec, deterministic=group is not None), \
            span("call", pairs=bl, regions=k):
        vgg = VGG({name: {n: t.to(dev) for n, t in p.items()}
                   for name, p in vgg_params.items()},
                  taps=spec.taps, vgg_type=spec.vgg_type,
                  preprocess_mode=spec.preprocess_mode,
                  compute_dtype=spec.compute_dtype,
                  block1_impl=spec.block1_impl)
        n = spec.sample_size
        consumer = progress_cb is not None or bool(cfg.checkpoint_dir)
        chunk = max(1, min(cfg.log_every if consumer else cfg.max_iter,
                           cfg.max_iter))
        # a warm start's inits play scale 0's previous stylization
        stylized = init_images if warm else None
        final_u8 = None
        info: Dict = {"scales": [], "batch": B}
        t_total = time.perf_counter()
        for i, scl in enumerate(cfg.scale_sizes()):
            if i < cfg.start_level or (resume is not None
                                       and i < resume["scale_index"]):
                # skipped: never run, never drawn from; alpha still halves
                alpha = [a / 2.0 for a in alpha]
                continue
            with timed("scale", index=i, px=scl) as clock:
                with span("scale.setup"):
                    mode, chw, shw = scale_mode_shapes(
                        cfg, contents.shape, styles.shape, i, scl, warm)
                    lr = (cfg.lr / 2 if (i == cfg.levels - 1 and i > 0)
                          else cfg.lr)
                    gens = [scale_generators(sd, i, dev) for sd in seeds]
                    step_gens = [g[1] for g in gens]
                    done = 0
                    ran = True
                    if resume is not None:
                        done = min(resume["done_steps"], cfg.max_iter)
                        ran = done < cfg.max_iter
                    pyramid, content_feats, targets, moments, cmasks = (
                        prepare_scale_batch(
                            spec, mode, chw, shw, cfg.pyramid_levels, vgg,
                            contents, styles,
                            stylized if stylized is not None else contents,
                            [g[0] for g in gens], i, regions, content_masks,
                            style_masks, coords_source))
                    opt = RMSprop(pyramid, lr)
                    if resume is not None:  # i is the checkpoint's scale
                        saved = _restore(cfg.checkpoint_dir,
                                         _state(pyramid, opt, step_gens), B,
                                         part)
                        with torch.no_grad():
                            for j, p in enumerate(pyramid):
                                p.copy_(saved[f"pyramid.{j}"])
                            for j, v in enumerate(opt.nu):
                                v.copy_(saved[f"nu.{j}"])
                        for b, g in enumerate(step_gens):
                            g.set_state(saved[f"rng.{b}"])
                        alpha = [float(a) for a in np.broadcast_to(
                            np.asarray(resume["alpha"], np.float64), (B,))]
                        resume = None
                        checkpoint_sync(mesh, cfg)
                    pairs = [PairTerms(targets[b], moments[b], alpha[part][b],
                                       weights[b]) for b in range(bl)]

                    def coords_fn(b, t, i=i, chw=chw, cmasks=cmasks,
                                  step_gens=step_gens):
                        return _pair_coords(coords_source, step_gens[b], b,
                                            i, "paired", t, chw, n, dev,
                                            cmasks[b], regions[b])

                curve: List[torch.Tensor] = []
                images = None
                while done < cfg.max_iter:
                    steps = min(chunk, cfg.max_iter - done)
                    rows, images = run_chunk_batch(
                        spec, steps, vgg, content_feats, pairs, pyramid, opt,
                        lambda b, t, d=done: coords_fn(b, d + t),
                        images=bool(cfg.checkpoint_dir), sample_group=group)
                    curve.append(rows)
                    if cfg.checkpoint_dir:
                        state = _state(pyramid, opt, step_gens)
                        extras = {"stylized": images[0],
                                  "image_u8": images[1]}
                        if data is not None:
                            state, extras = _gather_state(state, data), {
                                name: _gather_pairs(v, data)
                                for name, v in extras.items()}
                        if lead:
                            ckpt.save_state(cfg.checkpoint_dir, i,
                                            done + steps, alpha, state,
                                            fingerprint=fingerprint,
                                            extras=extras)
                        checkpoint_sync(mesh, cfg)
                    if progress_cb is not None:
                        block = rows if data is None else _gather_pairs(
                            rows.transpose(0, 1), data).transpose(0, 1)
                        with span("scale.readback"):
                            block = block.mean(dim=1).cpu().numpy()
                        for j in range(steps):
                            progress_cb(scl, done + j + 1, cfg.max_iter,
                                        {"loss": float(block[j, 0]),
                                         "loss_c": float(block[j, 1]),
                                         "loss_s": float(block[j, 2])})
                    done += steps
                check_replicas(pyramid, group, i)
                kept = ({} if ran or not cfg.checkpoint_dir
                        else ckpt.restore_extras(cfg.checkpoint_dir))
                if "stylized" in kept and "image_u8" in kept:
                    # a resume on a completed chunk boundary: the saved
                    # images go on to the next scale as the interrupted
                    # run made them
                    stylized = torch.from_numpy(
                        kept["stylized"][part]).to(dev)
                    final_u8 = torch.from_numpy(
                        kept["image_u8"][part]).to(dev)
                else:
                    with span("scale.finish"):
                        stylized, final_u8 = images or _images(pyramid)
                checkpoint_sync(mesh, cfg)
                with span("scale.readback"):
                    curve_np = (torch.cat(curve).cpu().numpy() if curve
                                else np.zeros((0, bl, 3), np.float32))
            info["scales"].append({
                "scale": scl,
                "alpha": (float(alpha[0]) if len(set(alpha)) == 1
                          else [float(a) for a in alpha]),
                "seconds": clock.seconds,
                "curve": curve_np})
            alpha = [a / 2.0 for a in alpha]
        if data is not None:
            # every rank returns the whole batch, in pair order
            final_u8 = _gather_pairs(final_u8, data)
            stylized = _gather_pairs(stylized, data)
            curves = [None] * dist.get_world_size(data)
            dist.all_gather_object(
                curves, [e["curve"] for e in info["scales"]], group=data)
            for j, entry in enumerate(info["scales"]):
                entry["curve"] = np.concatenate([c[j] for c in curves], 1)
        for entry in info["scales"]:
            if len(entry["curve"]):
                last = entry["curve"][-1].mean(axis=0)
                entry.update(loss=float(last[0]), loss_c=float(last[1]),
                             loss_s=float(last[2]))
        info["seconds"] = time.perf_counter() - t_total
    info["stylized"] = stylized
    return final_u8, info


def _gather_pairs(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's equal part of a leading pair axis over the 'data'
    ``group``, concatenated in pair order."""
    t = t.detach().contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]))
    with torch.no_grad():
        dist.all_gather_into_tensor(out, t, group=group)
    return out


def _gather_state(state: Dict, group) -> Dict:
    """The whole batch's checkpoint state from every rank's part: the
    pair-leading leaves gathered, the step generators renumbered by
    their pairs' global index."""
    gens = {name: v for name, v in state.items() if name.startswith("rng.")}
    out = {name: _gather_pairs(v, group) for name, v in state.items()
           if name not in gens}
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, [gens[f"rng.{b}"]
                                   for b in range(len(gens))], group=group)
    flat = [g for part in parts for g in part]
    out.update({f"rng.{b}": g for b, g in enumerate(flat)})
    return out


def _restore(directory: str, template: Dict, B: int, part: slice) -> Dict:
    """This rank's part of a checkpoint of the whole batch: the saved
    leaves for pairs ``part`` of ``B``, under ``template``'s names."""
    whole = {}
    for name, t in template.items():
        if name.startswith("rng."):
            continue
        whole[name] = torch.empty((B,) + tuple(t.shape[1:]), dtype=t.dtype)
    gen = next(t for name, t in template.items() if name.startswith("rng."))
    whole.update({f"rng.{b}": gen for b in range(B)})
    saved = ckpt.restore_state(directory, whole)
    out = {name: saved[name][part].to(t.device)
           for name, t in template.items() if not name.startswith("rng.")}
    out.update({f"rng.{b}": saved[f"rng.{part.start + b}"]
                for b in range(part.stop - part.start)})
    return out
