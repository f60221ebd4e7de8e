"""Fail-fast validation of the public API's image inputs, the counterpart
of ``strotss_tpu/validation.py:25-48``."""

from __future__ import annotations

import numpy as np
import torch


def check_image(name: str, x) -> None:
    """``x`` must be a (1, H, W, 3) floating-point array or tensor."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))
    dtype = x.dtype if hasattr(x, "dtype") else np.asarray(x).dtype
    if len(shape) != 4 or shape[-1] != 3:
        hint = ""
        if len(shape) == 3 and shape[-1] == 3:
            hint = f" (got an unbatched HWC image — pass {name}[None])"
        raise ValueError(f"{name} must have shape (1, H, W, 3), got "
                         f"{shape}{hint}")
    if shape[0] != 1:
        raise ValueError(f"{name} must have a singleton batch dim "
                         f"(1, H, W, 3), got {shape}")
    floating = (dtype.is_floating_point if isinstance(dtype, torch.dtype)
                else np.issubdtype(np.dtype(dtype), np.floating))
    if not floating:
        raise ValueError(f"{name} must be floating point in [0, 1], got "
                         f"dtype {dtype}")
