"""Image-space ops: bilinear resize, Laplacian pyramid, colour, postprocess.

Counterpart of ``strotss_tpu/ops/image.py``. Images are NHWC (or HWC)
float tensors, as in the JAX package. ``resize_bilinear`` is TensorFlow's
default bilinear resize (half-pixel centres, no antialiasing), which
``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
computes; it is held against the TF goldens in the tests.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# tf.image.rgb_to_yuv kernel (BT.601), the exact constants TF uses.
_RGB_TO_YUV = (
    (0.299, -0.14714119, 0.61497538),
    (0.587, -0.28886916, -0.51496512),
    (0.114, 0.43601035, -0.10001026),
)


#: (values, dtype, device) -> the constant on that device
_constants: dict = {}


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once a
    (values, dtype, device) and then shared, never written: a step takes
    its constants without a copy from the host, which a captured CUDA
    graph could not make. ``values``: nested tuples of numbers."""
    key = (values, dtype, torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return t


def _hw(x: torch.Tensor) -> Tuple[int, int]:
    if x.ndim == 4:
        return int(x.shape[1]), int(x.shape[2])
    if x.ndim == 3:
        return int(x.shape[0]), int(x.shape[1])
    raise ValueError(f"Invalid rank: {x.ndim}")


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC (or HWC) image to spatial size ``hw``."""
    h, w = int(hw[0]), int(hw[1])
    if x.ndim not in (3, 4):
        raise ValueError(f"Invalid rank: {x.ndim}")
    if _hw(x) == (h, w):
        return x
    nhwc = x if x.ndim == 4 else x[None]
    out = F.interpolate(nhwc.permute(0, 3, 1, 2), size=(h, w),
                        mode="bilinear", align_corners=False, antialias=False)
    out = out.permute(0, 2, 3, 1)
    return out if x.ndim == 4 else out[0]


def resize_max_hw(h: int, w: int, max_size: Optional[int]) -> Tuple[int, int]:
    """Target (h, w) of the aspect-preserving resize, truncating like the
    reference (``factor = max(h, w) / max_size``, ``int(h / factor)``)."""
    if max_size is None:
        return h, w
    factor = max(h / max_size, w / max_size)
    return int(h / factor), int(w / factor)


def resize_max(x: torch.Tensor, max_size: Optional[int]) -> torch.Tensor:
    """Resize so the longest edge equals ``max_size`` (upscaling too)."""
    if max_size is None:
        return x
    return resize_bilinear(x, resize_max_hw(*_hw(x), max_size))


def cap_max(x: torch.Tensor, max_size: Optional[int]) -> torch.Tensor:
    """Downscale so the longest edge is at most ``max_size``; an image
    already within the cap passes through untouched, so applying it twice
    never resamples twice (``resize_max`` is not idempotent)."""
    if max_size is None or max(_hw(x)) <= max_size:
        return x
    return resize_max(x, max_size)


def make_laplacian(x: torch.Tensor, return_downscale: bool = False):
    """One Laplacian band ``x - up(down(x))`` with /2 bilinear scaling."""
    h, w = _hw(x)
    down = resize_bilinear(x, (max(h // 2, 1), max(w // 2, 1)))
    band = x - resize_bilinear(down, (h, w))
    if return_downscale:
        return band, down
    return band


def make_laplacian_pyramid(x: torch.Tensor, levels: int = 5) -> List[torch.Tensor]:
    """``levels`` band-pass tensors plus the low-res residual."""
    bands = []
    cur = x
    for _ in range(levels):
        band, cur = make_laplacian(cur, return_downscale=True)
        bands.append(band)
    bands.append(cur)
    return bands


def fold_laplacian_pyramid(bands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Reconstruct the image from its pyramid bands."""
    out = bands[-1]
    for band in reversed(bands[:-1]):
        out = band + resize_bilinear(out, _hw(band))
    return out


def rgb_to_yuv(x: torch.Tensor) -> torch.Tensor:
    """RGB->YUV of the first 3 entries of the last axis (BT.601, TF's kernel)."""
    k = device_constant(_RGB_TO_YUV, x.dtype, x.device)
    return torch.matmul(x[..., :3], k)


def postprocess(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0,1], global min-max renormalize, uint8, drop batch dim."""
    x = torch.clamp(x, 0.0, 1.0)
    x = x - torch.min(x)
    x = x / torch.max(x)
    return (x * 255.0).to(torch.uint8)[0]


def laplacian_pyramid_shapes(
    hw: Tuple[int, int], levels: int = 5
) -> List[Tuple[int, int]]:
    """Spatial shapes of each pyramid entry (levels+1 of them)."""
    shapes = []
    h, w = hw
    for _ in range(levels):
        shapes.append((h, w))
        h, w = max(h // 2, 1), max(w // 2, 1)
    shapes.append((h, w))
    return shapes
