"""Host-side image I/O, the counterpart of ``strotss_tpu/utils/io.py``.

Decode to 3-channel RGB, convert to float [0,1], optional aspect-preserving
max-size resize, batch dim; JPEG written at quality 100. Pillow is imported
inside the functions: a machine without it can still import the package
and run the library API on tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from strotss_torch.ops.image import resize_max, resize_max_hw
from strotss_torch.utils.logging import logger


def load_image(path: str, max_size: Optional[int] = None) -> torch.Tensor:
    """Load an image file as a (1,H,W,3) float32 CPU tensor in [0,1].

    The resize happens in float after decoding, as in the reference
    (decode -> float convert -> resize).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"File not found: {path}")
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    img = torch.tensor(arr, dtype=torch.float32) / 255.0
    return resize_max(img, max_size)[None]


def image_size(path: str, max_size: Optional[int] = None):
    """(H, W) that :func:`load_image` would produce, from the header alone.

    PIL's ``open`` decodes no pixels, so this is cheap enough to group
    jobs by shape before loading them (``strotss_torch.serve``). The
    arithmetic is ``resize_max_hw``'s, the rule ``load_image`` resizes by.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"File not found: {path}")
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return resize_max_hw(h, w, max_size)


def write_image(image, path: str) -> None:
    """Write an HWC or 1HWC uint8 (or float [0,1]) image as JPEG/PNG."""
    arr = image.detach().cpu().numpy() if isinstance(
        image, torch.Tensor) else np.asarray(image)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(f"Batch size must be 1. Got {arr.shape[0]}")
        arr = arr[0]
    if arr.ndim != 3:
        raise ValueError(f"Invalid rank: {arr.ndim}")
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    from PIL import Image

    im = Image.fromarray(arr)
    if path.lower().endswith((".jpg", ".jpeg")):
        im.save(path, quality=100)
    else:
        im.save(path)
    logger.info(f"Wrote image to {path}")
