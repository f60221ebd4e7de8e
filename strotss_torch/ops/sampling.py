"""Hypercolumn feature sampling, the counterpart of
``strotss_tpu/ops/sampling.py``.

- Style targets: ``sample_size`` pixels drawn uniformly without
  replacement from the full grid (the reference's shuffle-and-truncate),
  nearest lookup, once per scale.
- Content and prediction: a strided grid with a random offset per axis,
  ``sample_size`` of its in-bounds points drawn without replacement, the
  same coordinates for both, bilinear lookup with the reference's border
  clipping. Coordinates are rescaled per feature map by
  :func:`coordinate_factors`.
- Region masks (:func:`prepare_mask`) restrict either draw to the pixels
  of one region. A region with no valid point at a scale or grid offset
  falls back to the whole grid (the JAX package's escapes), and the draw
  is always topped up with replacement, because the valid count is known
  only on the device and is never read back.

Draws come from an explicit ``torch.Generator`` on the run's device, so
sampling never waits on the host. Selection is Gumbel top-k over the valid
points (fewer than ``sample_size`` valid points are topped up by draws with
replacement, as in the JAX package), so shapes stay fixed. Every gather
takes its coordinates as an argument; ``coords[:, 0]`` indexes H. The JAX
package's one-hot-matmul sampling gate (a TPU measurement) is not ported:
all lookups are gathers.

``impl`` selects the gathers' route: ``'plain'`` (the PyTorch gathers
below, under autograd), ``'kernel'`` (kernel pair K5,
:mod:`strotss_torch.ops.kernels.gather`: every map of both sides in one
launch, bit for bit the plain rows, and a deterministic float32 backward)
or ``'auto'`` (K5 on CUDA coordinates, plain on the CPU).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from strotss_torch.ops.image import resize_bilinear
from strotss_torch.ops.kernels import gather
from strotss_torch.ops.kernels.common import resolve_impl


def coordinate_factors(shapes: Sequence[Tuple[int, int]]) -> List[float]:
    """Per-map multiplier taking base-resolution coords to map ``i`` coords.

    Replicates the reference's cumulative divides: when the height drops
    between consecutive entries, coordinates are divided by the ratio along
    one axis chosen once (H if the current height is a power of two, else
    W).
    """
    factors = [1.0]
    f = 1.0
    axis = None
    for i in range(1, len(shapes)):
        if shapes[i][0] < shapes[i - 1][0]:
            if axis is None:
                axis = 0 if (math.log2(shapes[i][0]) % 1 == 0) else 1
            f /= shapes[i - 1][axis] / shapes[i][axis]
        factors.append(f)
    return factors


def strided_grid_params(h: int, w: int) -> Tuple[int, int, int, int]:
    """(step_x, step_y, nx, ny) of the content sampling grid: the x step
    floors and the y step ceils ``sqrt((h*w) // 128**2)``; nx, ny are the
    worst-case point counts per axis."""
    area = math.sqrt((h * w) // (128 ** 2))
    step_x = max(1, math.floor(area))
    step_y = max(1, math.ceil(area))
    return step_x, step_y, -(-h // step_x), -(-w // step_y)


def prepare_mask(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize an (H, W, 1) or (1, H, W, 1) mask to ``hw`` and threshold at
    0.5: a float (h, w) validity map in {0, 1}. If the resized mask's
    maximum is below 0.1 every pixel is valid (the reference's all-pass
    escape)."""
    if mask.ndim == 4:
        mask = mask[0]
    m = resize_bilinear(mask.float(), hw)[..., 0]
    valid = (m > 0.5).float()
    return torch.where(m.max() < 0.1, torch.ones_like(valid), valid)


def _check_mask_hw(mask: torch.Tensor, hw: Tuple[int, int]) -> None:
    """A prepared mask must have the base grid's shape: any other would
    draw coordinates from the wrong index domain."""
    if tuple(mask.shape) != tuple(hw):
        raise ValueError(
            f"sampling mask has shape {tuple(mask.shape)} but the base "
            f"grid is {tuple(hw)}; resize it first (prepare_mask)")


def _select_k(gen: torch.Generator, valid: torch.Tensor, k: int,
              min_valid: int) -> torch.Tensor:
    """``k`` indices drawn without replacement among ``valid`` entries.

    Gumbel top-k; where fewer than k entries may be valid (``min_valid``
    is a lower bound on their count, known from the shapes), picks that
    land on invalid entries are replaced by uniform draws with replacement
    from the valid set.
    """
    p = valid.shape[0]
    if p < k:
        valid = torch.cat([valid, valid.new_zeros(k - p)])
        p = k
    u = torch.rand(p, generator=gen, device=valid.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    scores = torch.where(valid, gumbel, torch.full_like(gumbel, -math.inf))
    idx = torch.topk(scores, k).indices
    if min_valid >= k:
        return idx
    # the caller guarantees a valid entry: multinomial fails on a zero row
    probs = valid.float()
    replacement = torch.multinomial(probs, k, replacement=True, generator=gen)
    return torch.where(valid[idx], idx, replacement)


def full_grid_coords(gen: torch.Generator, hw: Tuple[int, int],
                     sample_size: int, device,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sample_size`` pixel coords (row, col) of the full grid, float32,
    among the pixels of a prepared ``mask`` when one is given."""
    h, w = hw
    valid = torch.ones(h * w, dtype=torch.bool, device=device)
    min_valid = h * w
    if mask is not None:
        _check_mask_hw(mask, hw)
        in_mask = mask.reshape(-1) > 0.5
        # a region with no pixel over the threshold at this scale (possible
        # past prepare_mask's escape, e.g. a resized maximum of 0.3) takes
        # the whole grid
        valid = torch.where(in_mask.any(), in_mask, valid)
        min_valid = 0
    idx = _select_k(gen, valid, sample_size, min_valid)
    return torch.stack([idx // w, idx % w], dim=1).float()


def strided_grid_coords(gen: torch.Generator, hw: Tuple[int, int],
                        sample_size: int, device,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sample_size`` coords of a random-offset strided grid, float32,
    among the grid points inside a prepared ``mask`` when one is given."""
    h, w = hw
    step_x, step_y, nx, ny = strided_grid_params(h, w)
    off_x = torch.randint(0, step_x, (1,), generator=gen, device=device)
    off_y = torch.randint(0, step_y, (1,), generator=gen, device=device)
    xs = off_x + torch.arange(nx, device=device) * step_x
    ys = off_y + torch.arange(ny, device=device) * step_y
    gx = xs.repeat_interleave(ny)
    gy = ys.repeat(nx)
    inb = (gx < h) & (gy < w)
    # whatever the offsets, at least floor(h/step) x floor(w/step) points
    # fall inside the image
    valid, min_valid = inb, (h // step_x) * (w // step_y)
    if mask is not None:
        _check_mask_hw(mask, hw)
        in_mask = inb & (mask[gx.clamp(0, h - 1), gy.clamp(0, w - 1)] > 0.5)
        # a thin region can fall between the grid's points for some
        # offsets: that draw takes the in-bounds grid
        valid = torch.where(in_mask.any(), in_mask, inb)
        min_valid = 0
    idx = _select_k(gen, valid, sample_size, min_valid)
    return torch.stack([gx[idx], gy[idx]], dim=1).float()


def _squeeze_map(fmap: torch.Tensor) -> torch.Tensor:
    return fmap[0] if fmap.ndim == 4 else fmap


def bilinear_corners(coords: torch.Tensor, h: int, w: int):
    """The four corners (row, col, weight) of each of the (n, 2) float
    coords on an (h, w) map, in the order :func:`bilinear_gather` blends
    them. Corner indices floor and floor+1 are clipped independently to
    the map (the reference's border rule)."""
    gx, gy = coords[:, 0], coords[:, 1]
    gxf, gyf = torch.floor(gx), torch.floor(gy)
    dx, dy = gx - gxf, gy - gyf
    x0 = gxf.clamp(0, h - 1).long()
    y0 = gyf.clamp(0, w - 1).long()
    x1 = (gxf + 1).clamp(0, h - 1).long()
    y1 = (gyf + 1).clamp(0, w - 1).long()
    return (
        (x0, y0, (1 - dx) * (1 - dy)),
        (x0, y1, (1 - dx) * dy),
        (x1, y0, dx * (1 - dy)),
        (x1, y1, dx * dy),
    )


def bilinear_gather(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """4-tap bilinear lookup of (n,2) float coords on an (h,w,c) map at
    :func:`bilinear_corners`; the blend runs in float32."""
    fmap = _squeeze_map(fmap)
    out = None
    for xi, yi, wt in bilinear_corners(coords, fmap.shape[0], fmap.shape[1]):
        term = fmap[xi, yi].float() * wt[:, None]
        out = term if out is None else out + term
    return out


def nearest_gather(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Truncating nearest lookup (clip float coords, cast to int)."""
    fmap = _squeeze_map(fmap)
    h, w = fmap.shape[0], fmap.shape[1]
    gx = coords[:, 0].clamp(0, h - 1).long()
    gy = coords[:, 1].clamp(0, w - 1).long()
    return fmap[gx, gy]


def _side(feats: Sequence[torch.Tensor], bilinear: bool,
          integer_coords: bool) -> gather.Side:
    """The maps with their factors and lookups (as
    :func:`sample_hypercolumn` chooses them), as K5 takes them; a map of
    more than one image is sampled at its first, as the plain route
    does."""
    maps = [f[0] if f.ndim == 4 and f.shape[0] != 1 else f for f in feats]
    factors = coordinate_factors([f.shape[-3:-1] for f in maps])
    return gather.Side(maps, factors,
                       [not bilinear or (integer_coords and fac == 1.0)
                        for fac in factors])


def sample_hypercolumn(feats: Sequence[torch.Tensor], coords: torch.Tensor,
                       bilinear: bool = True, integer_coords: bool = False,
                       impl: str = "plain") -> torch.Tensor:
    """Sample every map at (rescaled) ``coords``; concat channels, float32.

    ``integer_coords=True`` asserts the base coords are exact integers
    (true for both grids): maps at factor 1.0 then take the nearest lookup,
    which equals the bilinear one there. ``feats`` may be a hypercolumn
    split by height over ranks
    (:class:`strotss_torch.parallel.spatial.SlabColumns`), which samples
    itself: the same rows, bit for bit. ``impl``: the module doc's.
    """
    if hasattr(feats, "sample"):
        return feats.sample(coords, bilinear, integer_coords, impl)
    if resolve_impl(impl, coords) == "kernel":
        return gather.rows(coords, [_side(feats, bilinear,
                                          integer_coords)])[0]
    shapes = [tuple(_squeeze_map(f).shape[:2]) for f in feats]
    factors = coordinate_factors(shapes)
    parts = []
    for fmap, fac in zip(feats, factors):
        c = coords * fac if fac != 1.0 else coords
        if not bilinear or (integer_coords and fac == 1.0):
            g = nearest_gather(fmap, c)
        else:
            g = bilinear_gather(fmap, c)
        parts.append(g.float())
    return torch.cat(parts, dim=1)


def sample_style(coords: torch.Tensor, feats: Sequence[torch.Tensor],
                 impl: str = "plain") -> torch.Tensor:
    """Style targets at full-grid ``coords`` (nearest lookup)."""
    return sample_hypercolumn(feats, coords, bilinear=False, impl=impl)


def sample_paired(coords: torch.Tensor, xs: Sequence[torch.Tensor],
                  ys: Sequence[torch.Tensor], impl: str = "plain"):
    """Content and prediction rows at the same strided-grid ``coords``;
    under K5 both sides in one launch."""
    if (not hasattr(xs, "sample") and not hasattr(ys, "sample")
            and resolve_impl(impl, coords) == "kernel"):
        return gather.rows(coords, [_side(xs, True, True),
                                    _side(ys, True, True)])
    return (
        sample_hypercolumn(xs, coords, True, True, impl),
        sample_hypercolumn(ys, coords, True, True, impl),
    )
