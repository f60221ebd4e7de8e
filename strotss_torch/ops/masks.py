"""Region-mask loading and partition (host-side numpy), the counterpart of
``strotss_tpu/ops/masks.py``.

Both mask images are colour-quantized by ``// 255 * 255`` (each channel
snaps to {0, 255}, so at most 8 region colours); a colour defines a region
pair if it covers at least ``sample_threth`` (10000) pixels in the
*content* mask and appears at all in the *style* mask. The result is two
stacked (K, H, W, 1) float32 tensors of binary masks in the same region
order. Raises when no region survives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from strotss_torch.ops.image import resize_max
from strotss_torch.utils.io import load_image


def partition_masks(
    c_mask: np.ndarray,
    s_mask: np.ndarray,
    pixel_threth: int = 255,
    sample_threth: int = 10000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition quantized mask colours into paired binary region masks.

    Inputs are (H, W, 3) uint8 arrays. Returns two stacked (K, H, W, 1)
    float32 CPU tensors (content regions, style regions).
    """
    c_mask = (c_mask.astype(np.int64) // pixel_threth
              * pixel_threth).astype(np.uint8)
    s_mask = (s_mask.astype(np.int64) // pixel_threth
              * pixel_threth).astype(np.uint8)

    uniques, counts = np.unique(c_mask.reshape(-1, 3), axis=0,
                                return_counts=True)
    uniques = uniques[counts >= sample_threth]

    c_ret, s_ret = [], []
    for color in uniques:
        c_cond = np.all(c_mask == color[None, None, :], axis=-1)
        s_cond = np.all(s_mask == color[None, None, :], axis=-1)
        if c_cond.any() and s_cond.any():
            c_ret.append(c_cond.astype(np.float32)[..., None])
            s_ret.append(s_cond.astype(np.float32)[..., None])
    if not c_ret:
        raise Exception("No mask found")
    return torch.from_numpy(np.stack(c_ret)), torch.from_numpy(np.stack(s_ret))


def _load_quantized(path: str, max_size: Optional[int],
                    pixel_threth: int) -> np.ndarray:
    """One mask image as (H, W, 3) uint8, resized and quantized as the
    reference does.

    The reference resizes the decoded pixels in float and floor-quantizes
    those floats (``// 255 * 255``), so an interpolated edge pixel of
    254.7 maps to 0, not 255. Rounding the resized float back to uint8
    first would admit every pixel from 254.5 up into the 255 region and
    shift region membership (and the 10000-px counts) at anti-aliased
    edges. So: resize in float, floor-quantize the float, then cast (the
    quantized values are exact multiples of ``pixel_threth``).
    """
    # load_image divides by 255 in float32; x * 255 rounds back to the
    # decoded integer exactly
    raw = torch.round(load_image(path)[0] * 255.0)
    if max_size is None:
        return raw.numpy().astype(np.uint8)
    f = resize_max(raw, max_size).numpy()
    return (np.floor_divide(f, pixel_threth) * pixel_threth).astype(np.uint8)


def load_mask(
    content_path: str,
    style_path: str,
    max_size: Optional[int] = None,
    pixel_threth: int = 255,
    sample_threth: int = 10000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Load, quantize and partition a content/style mask image pair."""
    c = _load_quantized(content_path, max_size, pixel_threth)
    s = _load_quantized(style_path, max_size, pixel_threth)
    return partition_masks(c, s, pixel_threth, sample_threth)
