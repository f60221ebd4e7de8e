"""Fail-fast validation of the public API's image and mask inputs and of
``start_level``, the counterpart of ``strotss_tpu/validation.py:25-118``
(the unbatched branches: batched pairs and ``region_valid`` are
ROADMAP.md Queue 1 item 10)."""

from __future__ import annotations

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


def check_image(name: str, x) -> None:
    """``x`` must be a (1, H, W, 3) floating-point array or tensor."""
    shape, dtype = _shape_dtype(x)
    if len(shape) != 4 or shape[-1] != 3:
        hint = ""
        if len(shape) == 3 and shape[-1] == 3:
            hint = f" (got an unbatched HWC image — pass {name}[None])"
        raise ValueError(f"{name} must have shape (1, H, W, 3), got "
                         f"{shape}{hint}")
    if shape[0] != 1:
        raise ValueError(f"{name} must have a singleton batch dim "
                         f"(1, H, W, 3), got {shape}")
    if not _floating(dtype):
        raise ValueError(f"{name} must be floating point in [0, 1], got "
                         f"dtype {dtype}")


def check_masks(content_masks, style_masks) -> None:
    """Region stacks must be (K, H, W, 1) float, given together, with the
    same region count: each colour pairs one content region with one style
    region."""
    if (content_masks is None) != (style_masks is None):
        missing = "style_masks" if style_masks is None else "content_masks"
        raise ValueError(
            f"content_masks and style_masks must be given together "
            f"({missing} is None) — each mask color defines a "
            "content-region -> style-region transport pair")
    if content_masks is None:
        return
    shapes = {}
    for name, m in (("content_masks", content_masks),
                    ("style_masks", style_masks)):
        shape, dtype = _shape_dtype(m)
        if len(shape) != 4 or shape[-1] != 1:
            raise ValueError(f"{name} must have shape (K, H, W, 1), got "
                             f"{shape}")
        if not _floating(dtype):
            raise ValueError(f"{name} must be a float 0/1 region indicator, "
                             f"got dtype {dtype}")
        shapes[name] = shape
    kc, ks = shapes["content_masks"][0], shapes["style_masks"][0]
    if kc != ks:
        raise ValueError(
            f"content_masks and style_masks must pair region-for-region: "
            f"got {kc} content regions vs {ks} style regions")


def check_start_level(cfg) -> None:
    """``start_level`` must leave at least one scale to run."""
    if not 0 <= cfg.start_level < cfg.levels:
        raise ValueError(
            f"start_level must be in [0, levels), got start_level="
            f"{cfg.start_level} with levels={cfg.levels}")
