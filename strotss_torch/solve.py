"""The coarse-to-fine STROTSS driver, the counterpart of
``strotss_tpu/solve.py`` (``stylize_single``, lines 75-125 and 336-470)
and of the per-scale shapes of ``strotss_tpu/aot.py:90-114``.

A loop over scales (long edge 64 -> 128 -> 256 -> 512 by default); per
scale, ``max_iter`` RMSprop steps on the Laplacian-pyramid coefficients of
the stylized image. Alpha starts at ``cfg.initial_alpha()`` and halves per
scale; the last scale runs at half the learning rate. This slice covers
one style and no masks.
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
#: step -1) or 'paired' (each step) at base resolution ``hw``.
CoordsSource = Callable[[int, str, int, Tuple[int, int], int], torch.Tensor]


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


def stylize_single(
    content: torch.Tensor,
    style: torch.Tensor,
    cfg: StrotssConfig,
    vgg_params,
    progress_cb: Optional[Callable[[int, int, int, Dict[str, float]],
                                   None]] = None,
    snapshot_cb: Optional[Callable[[int, int, torch.Tensor], None]] = None,
    coords_source: Optional[CoordsSource] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full coarse-to-fine stylization of one (content, style) pair.

    ``content``/``style``: (1,H,W,3) float32 tensors in [0,1] on the device
    the run uses. Returns (uint8 HWC image on that device, info dict with
    per-scale losses, timings and loss curves). ``progress_cb`` is called
    for every step, replayed at each ``log_every`` boundary, when the
    losses are read back from the device. ``coords_source`` replaces the
    sampling generators (tests replay the JAX package's coordinates).
    """
    _unported(cfg)
    device = content.device
    spec = spec_from_config(cfg, device)  # ValueError on a bad block1_impl
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
    info: Dict = {"scales": []}
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
            if coords_source is None:
                s_coords = full_grid_coords(gen, shw, n, device)
            else:
                s_coords = coords_source(i, "style", -1, shw, n)
            style_targets = sample_style(s_coords, style_feats)
            style_moments = moment_stats(style_targets)
        pyramid = [p.detach().contiguous() for p in pyramid]
        opt = RMSprop(pyramid, lr)

        def coords_fn(t, i=i, chw=chw):
            if coords_source is None:
                return strided_grid_coords(gen, chw, n, device)
            return coords_source(i, "paired", t, chw, n)

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
