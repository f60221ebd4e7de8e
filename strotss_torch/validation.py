"""Fail-fast validation of the public API's image and mask inputs and of
``start_level``, the counterpart of ``strotss_tpu/validation.py:25-118``,
with the batched branches of ``stylize_batch``: (B, H, W, 3) images,
(B, K, H, W, 1) region stacks and their (B, K) ``region_valid`` marks.
The messages are the JAX package's, word for word."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _shape_dtype(x):
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))
    dtype = x.dtype if hasattr(x, "dtype") else np.asarray(x).dtype
    return shape, dtype


def _floating(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return bool(np.issubdtype(np.dtype(dtype), np.floating))


def check_image(name: str, x, batched: bool = False) -> None:
    """``x`` must be (1, H, W, 3), or (B, H, W, 3) with ``batched``,
    floating point."""
    shape, dtype = _shape_dtype(x)
    want = "(B, H, W, 3)" if batched else "(1, H, W, 3)"
    if len(shape) != 4 or shape[-1] != 3:
        hint = ""
        if len(shape) == 3 and shape[-1] == 3:
            hint = f" (got an unbatched HWC image — pass {name}[None])"
        raise ValueError(f"{name} must have shape {want}, got "
                         f"{shape}{hint}")
    if not batched and shape[0] != 1:
        raise ValueError(f"{name} must have a singleton batch dim {want}, "
                         f"got {shape} — use "
                         "strotss_torch.parallel.stylize_batch for multiple "
                         "pairs")
    if batched and shape[0] < 1:
        raise ValueError(f"{name} batch dim must be >= 1, got {shape}")
    if not _floating(dtype):
        raise ValueError(f"{name} must be floating point in [0, 1], got "
                         f"dtype {dtype}")


def check_masks(content_masks, style_masks, region_valid=None,
                batched: bool = False, batch: Optional[int] = None) -> None:
    """Region stacks must be (K, H, W, 1), or (B, K, H, W, 1) with
    ``batched``, float, given together, with the same region count: each
    colour pairs one content region with one style region. ``region_valid``
    (B, K) marks a batch's real regions and needs the stacks."""
    if (content_masks is None) != (style_masks is None):
        missing = "style_masks" if style_masks is None else "content_masks"
        raise ValueError(
            f"content_masks and style_masks must be given together "
            f"({missing} is None) — each mask color defines a "
            "content-region -> style-region transport pair")
    if content_masks is None:
        if region_valid is not None:
            raise ValueError(
                "region_valid was given without content_masks/style_masks; "
                "it weights mask REGIONS and would be silently ignored in "
                "an unmasked run — pass the region stacks or drop it")
        return
    rank = 5 if batched else 4
    want = "(B, K, H, W, 1)" if batched else "(K, H, W, 1)"
    shapes = {}
    for name, m in (("content_masks", content_masks),
                    ("style_masks", style_masks)):
        shape, dtype = _shape_dtype(m)
        if len(shape) != rank or shape[-1] != 1:
            raise ValueError(f"{name} must have shape {want}, got {shape}")
        if not _floating(dtype):
            raise ValueError(f"{name} must be a float 0/1 region indicator, "
                             f"got dtype {dtype}")
        shapes[name] = shape
    cshape, sshape = shapes["content_masks"], shapes["style_masks"]
    k_axis = 1 if batched else 0
    if cshape[k_axis] != sshape[k_axis]:
        raise ValueError(
            f"content_masks and style_masks must pair region-for-region: "
            f"got {cshape[k_axis]} content regions vs {sshape[k_axis]} "
            "style regions")
    if batched:
        if batch is not None and (cshape[0] != batch or sshape[0] != batch):
            raise ValueError(
                f"mask batch dims {cshape[0]}/{sshape[0]} do not match the "
                f"image batch {batch}")
        if region_valid is not None:
            vshape = _shape_dtype(region_valid)[0]
            if vshape != (cshape[0], cshape[1]):
                raise ValueError(
                    f"region_valid must have shape (B, K) = "
                    f"({cshape[0]}, {cshape[1]}), got {vshape}")


def check_start_level(cfg) -> None:
    """``start_level`` must leave at least one scale to run."""
    if not 0 <= cfg.start_level < cfg.levels:
        raise ValueError(
            f"start_level must be in [0, levels), got start_level="
            f"{cfg.start_level} with levels={cfg.levels}")
