"""High-level library API: one call = one stylization (the counterpart of
``strotss_tpu/api.py``). Runs on the CUDA card unless the caller passes
``device='cpu'``; without a card it raises instead of falling back."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from strotss_torch.config import StrotssConfig
from strotss_torch.models.weights import load_vgg_params
from strotss_torch.solve import stylize_single
from strotss_torch.validation import check_image, check_masks


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` -> ``cuda`` (under a mesh: the rank's own device); a CUDA
    device must exist (no CPU fallback)."""
    if device is None and mesh is not None:
        from strotss_torch.parallel.mesh import rank_device

        return rank_device(mesh)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "strotss_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to run on the CPU")
        if (dev.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"Invalid device ID: {dev.index}")
    return dev


def _to_device(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def stylize(
    content,
    style,
    cfg: Optional[StrotssConfig] = None,
    content_masks=None,
    style_masks=None,
    vgg_params=None,
    progress_cb=None,
    snapshot_cb=None,
    init_image=None,
    style_weights=None,
    device=None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """Stylize ``content`` with ``style`` (both (1,H,W,3) float in [0,1],
    numpy arrays or tensors), optionally region by region:
    ``content_masks``/``style_masks`` are (K,H,W,1) float 0/1 stacks that
    pair content region k with style region k
    (:func:`strotss_torch.ops.masks.load_mask` makes them from two colour
    mask images).

    ``style`` may be a list of style images with ``style_weights`` (one
    weight per style, relative): the style target is then a weighted
    mixture of samples of each style
    (:func:`strotss_torch.programs.style_sample_counts`); a weight of 0,
    or one whose share of ``cfg.sample_size`` rounds to 0, drops its
    style exactly. Not with masks. ``init_image``: an optional (1,H,W,3)
    float warm start at any resolution: the first executed scale seeds
    from it, resized once to that scale's resolution. Feed a finished
    run's ``info["stylized"]`` back with ``cfg.start_level`` to refine it.

    Returns the uint8 HWC stylized image (on the run's device) and an info
    dict with per-scale losses and timings. ``device``: ``None`` (the
    first CUDA card), ``'cuda:<id>'`` or ``'cpu'``.

    ``mesh``: a :func:`strotss_torch.parallel.make_mesh` mesh (as in
    ``strotss_tpu/api.py:25-36``): every rank calls ``stylize`` with the
    same inputs and gets the whole result; the device is the rank's own.
    With ``cfg.shard_samples`` the transport losses split the style
    samples over its 'sample' axis.
    """
    check_image("content", content)
    multi = isinstance(style, (list, tuple))
    for i, s in enumerate(style if multi else [style]):
        check_image(f"style[{i}]" if multi else "style", s)
    if init_image is not None:
        check_image("init_image", init_image)
    check_masks(content_masks, style_masks)
    dev = resolve_device(device, mesh)
    cfg = cfg or StrotssConfig()
    if vgg_params is None:
        vgg_params = load_vgg_params(cfg.vgg_type, cfg.use_keras_weight)
    masks = {}
    if content_masks is not None:
        masks = {"content_masks": _to_device(content_masks, dev),
                 "style_masks": _to_device(style_masks, dev)}
    style = ([_to_device(s, dev) for s in style] if multi
             else _to_device(style, dev))
    return stylize_single(
        _to_device(content, dev), style, cfg, vgg_params,
        progress_cb=progress_cb, snapshot_cb=snapshot_cb,
        init_image=(None if init_image is None
                    else _to_device(init_image, dev)),
        style_weights=style_weights, mesh=mesh, **masks,
    )
