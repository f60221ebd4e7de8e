"""The coarse-to-fine STROTSS driver, the counterpart of
``strotss_tpu/solve.py`` (``stylize_single``, lines 75-125 and 336-470)
and of the per-scale shapes of ``strotss_tpu/aot.py:90-114``.

A loop over scales (long edge 64 -> 128 -> 256 -> 512 by default); per
scale, ``max_iter`` RMSprop steps on the Laplacian-pyramid coefficients of
the stylized image. Alpha starts at ``cfg.initial_alpha()`` and halves per
scale; the last scale runs at half the learning rate. One style, with
optional region masks: each region pairs a content region with a style
region, has its own style targets and coordinates each step, and the loss
averages the regions.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from strotss_torch.config import StrotssConfig
from strotss_torch.models.vgg import VGG
from strotss_torch.ops.image import (
    cap_max,
    fold_laplacian_pyramid,
    postprocess,
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
    scale_seed,
    set_precision,
    spec_from_config,
)

#: ``coords_source(scale_index, kind, step, hw, sample_size)`` returns the
#: (sample_size, 2) coordinates for ``kind`` 'style' (once per scale,
#: step -1) or 'paired' (each step) at base resolution ``hw``. Under
#: region masks it takes a sixth argument, the region index, and is
#: called once per region.
CoordsSource = Callable[..., torch.Tensor]


def scale_mode_shapes(cfg: StrotssConfig, content_shape, style_shape,
                      scale_index: int, scl: int):
    """(mode, chw, shw) of one scale: 'first', 'mid' or 'last' and the
    content and style shapes resized to long edge ``scl``."""
    chw = resize_max_hw(content_shape[1], content_shape[2], scl)
    shw = resize_max_hw(style_shape[1], style_shape[2], scl)
    mode = "first" if scale_index == 0 else (
        "mid" if scale_index < cfg.levels - 1 else "last")
    return mode, chw, shw


def _unported(cfg: StrotssConfig) -> None:
    for field, item in (("start_level", "9"), ("checkpoint_dir", "9"),
                        ("shard_samples", "13"), ("shard_spatial", "13"),
                        ("remat", "14"), ("profile_dir", "14")):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"StrotssConfig.{field} is not ported to strotss_torch yet "
                f"(ROADMAP.md Queue 1 item {item})")


def _coords(coords_source, gen, i, kind, step, hw, n, device,
            masks) -> torch.Tensor:
    """(K, n, 2) coordinates, one draw a region of ``masks`` (``[None]``
    without masks): from the run's generator (the full grid for 'style',
    the strided grid for 'paired', under the region's mask) or from
    ``coords_source``, which is told the region under masks."""
    if coords_source is not None:
        return torch.stack([
            coords_source(i, kind, step, hw, n,
                          *(() if m is None else (r,)))
            for r, m in enumerate(masks)])
    draw = full_grid_coords if kind == "style" else strided_grid_coords
    return torch.stack([draw(gen, hw, n, device, mask=m) for m in masks])


def stylize_single(
    content: torch.Tensor,
    style: torch.Tensor,
    cfg: StrotssConfig,
    vgg_params,
    progress_cb: Optional[Callable[[int, int, int, Dict[str, float]],
                                   None]] = None,
    snapshot_cb: Optional[Callable[[int, int, torch.Tensor], None]] = None,
    coords_source: Optional[CoordsSource] = None,
    content_masks: Optional[torch.Tensor] = None,
    style_masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full coarse-to-fine stylization of one (content, style) pair.

    ``content``/``style``: (1,H,W,3) float32 tensors in [0,1] on the device
    the run uses; ``content_masks``/``style_masks``: optional (K,H,W,1)
    float 0/1 region stacks on that device, at any resolution (each scale
    resizes them, :func:`prepare_mask`). Returns (uint8 HWC image on that
    device, info dict with per-scale losses, timings, loss curves and
    ``n_regions``). ``progress_cb`` is called
    for every step, replayed at each ``log_every`` boundary, when the
    losses are read back from the device. ``coords_source`` replaces the
    sampling generators (tests replay the JAX package's coordinates).
    """
    _unported(cfg)
    device = content.device
    masked = content_masks is not None
    # ValueError on a bad block1_impl
    spec = spec_from_config(cfg, device, masked=masked)
    set_precision(spec)
    content = cap_max(content, cfg.max_size)
    style = cap_max(style, cfg.max_size)
    vgg = VGG({k: {n: t.to(device) for n, t in p.items()}
               for k, p in vgg_params.items()},
              taps=spec.taps, vgg_type=spec.vgg_type,
              preprocess_mode=spec.preprocess_mode,
              compute_dtype=spec.compute_dtype,
              block1_impl=spec.block1_impl)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    n = spec.sample_size

    alpha = cfg.initial_alpha()
    stylized = None
    final_u8 = None
    info: Dict = {"scales": [],
                  "n_regions": int(content_masks.shape[0]) if masked else 0}
    t_total = time.perf_counter()
    for i, scl in enumerate(cfg.scale_sizes()):
        t_scale = time.perf_counter()
        mode, chw, shw = scale_mode_shapes(cfg, content.shape, style.shape,
                                           i, scl)
        lr = cfg.lr / 2 if (i == cfg.levels - 1 and i > 0) else cfg.lr
        prev = stylized if stylized is not None else content
        with torch.no_grad():
            scl_c, scl_s, pyramid = scale_seed(
                mode, chw, shw, cfg.pyramid_levels, content, style, prev)
            content_feats = extract_hypercolumn(vgg, scl_c)
            style_feats = extract_hypercolumn(vgg, scl_s)
            cmasks = ([prepare_mask(m, chw) for m in content_masks]
                      if masked else [None])
            smasks = ([prepare_mask(m, shw) for m in style_masks]
                      if masked else [None])
            style_targets = torch.stack([
                sample_style(xy, style_feats) for xy in _coords(
                    coords_source, gen, i, "style", -1, shw, n, device,
                    smasks)])
            style_moments = [moment_stats(t) for t in style_targets]
        pyramid = [p.detach().contiguous() for p in pyramid]
        opt = RMSprop(pyramid, lr)

        def coords_fn(t, i=i, chw=chw, cmasks=cmasks):
            return _coords(coords_source, gen, i, "paired", t, chw, n,
                           device, cmasks)

        curve: List[torch.Tensor] = []
        done = 0
        step_cb = progress_cb is not None or (
            snapshot_cb is not None and cfg.save_every > 0)
        chunk = max(1, min(cfg.log_every, cfg.max_iter)) if step_cb \
            else max(1, cfg.max_iter)
        while done < cfg.max_iter:
            k = min(chunk, cfg.max_iter - done)
            curve.append(optimization_steps(
                spec, k, vgg, content_feats, style_targets, style_moments,
                alpha, pyramid, opt,
                lambda t, d=done: coords_fn(d + t)))
            if progress_cb is not None:
                block = curve[-1].cpu().numpy()
                for j in range(k):
                    progress_cb(scl, done + j + 1, cfg.max_iter,
                                {"loss": float(block[j, 0]),
                                 "loss_c": float(block[j, 1]),
                                 "loss_s": float(block[j, 2])})
            done += k
            if snapshot_cb is not None and cfg.save_every > 0 and (
                    done % cfg.save_every == 0 or done == cfg.max_iter):
                with torch.no_grad():
                    snapshot_cb(scl, done, postprocess(
                        fold_laplacian_pyramid(pyramid)))
        with torch.no_grad():
            stylized = fold_laplacian_pyramid(pyramid)
            final_u8 = postprocess(stylized)
        curve_np = (torch.cat(curve).cpu().numpy() if curve
                    else np.zeros((0, 3), np.float32))
        entry = {"scale": scl, "alpha": alpha, "curve": curve_np,
                 "seconds": time.perf_counter() - t_scale}
        if len(curve_np):
            entry.update(loss=float(curve_np[-1, 0]),
                         loss_c=float(curve_np[-1, 1]),
                         loss_s=float(curve_np[-1, 2]))
        info["scales"].append(entry)
        alpha /= 2.0
    info["seconds"] = time.perf_counter() - t_total
    info["stylized"] = stylized
    return final_u8, info
