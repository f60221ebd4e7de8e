"""Inputs made from the run's seed on the device: VGG16 weights, images,
region masks, and the jobs of the window.

One generator reads every traffic file. Its parameters:

- ``content_hw``, ``style_hw``: image sizes (every job the same shape);
- ``images``: distinct contents and styles made, which the jobs cycle;
- ``pairs``: pairs a call (1: ``strotss_torch.stylize``; more:
  ``strotss_torch.parallel.stylize_batch`` with one shape bucket);
- ``alphas``: per-pair alphas of a batch, in pair order;
- ``regions``: 0, or 2 (content split top/bottom and style left/right at a
  boundary drawn from the seed within ``boundary``);
- ``check``: finished stylizations the check compares, drawn from the seed
  among those the window finished;
- ``trace_calls``: calls the traced run times and profiles.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

CONVS = (2, 2, 3, 3, 3)
WIDTHS = (64, 128, 256, 512, 512)


def layer_names() -> List[str]:
    return [f"block{b}_conv{c}" for b, n in enumerate(CONVS, start=1)
            for c in range(1, n + 1)]


def streams(seed: int, n: int) -> List[int]:
    """``n`` 63-bit seeds drawn from the run's seed."""
    rng = np.random.default_rng(int(seed))
    return [int(s) for s in rng.integers(0, 2 ** 63 - 1, size=n,
                                         dtype=np.int64)]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def vgg_weights(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-normal VGG16 kernels (OIHW, std sqrt(2 / (9 cin))) and zero
    biases, float32, from one draw on the device."""
    names, shapes, cin = layer_names(), [], 3
    for b, n in enumerate(CONVS):
        for _ in range(n):
            shapes.append((WIDTHS[b], cin, 3, 3))
            cin = WIDTHS[b]
    total = sum(int(np.prod(s)) for s in shapes)
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device)
    out, at = {}, 0
    for name, s in zip(names, shapes):
        k = int(np.prod(s))
        std = float(np.sqrt(2.0 / (9 * s[1])))
        out[name] = {"kernel": (flat[at:at + k] * std).view(s),
                     "bias": torch.zeros(s[0], device=device)}
        at += k
    return out


def smooth_image(h: int, w: int, seed: int, device) -> torch.Tensor:
    """(1, h, w, 3) float32 in [0, 1]: random 16-px blocks smoothed by an
    18-px box blur, so the VGG features are not white noise."""
    g = generator(seed, device)
    blocks = torch.rand((3, h // 16 + 2, w // 16 + 2), generator=g,
                        device=device)
    img = blocks.repeat_interleave(16, 1).repeat_interleave(16, 2)
    img = img[:, :h, :w][None]
    k = 9
    pad = F.pad(img, (k, k, k, k), mode="replicate")
    box = F.avg_pool2d(pad, 2 * k, stride=1)[:, :, :h, :w]
    return box.permute(0, 2, 3, 1).contiguous()


def split_masks(h: int, w: int, at: float, axis: int, device):
    """(2, h, w, 1) 0/1 masks: the part before ``at`` of the height
    (``axis`` 0) or width (1), and the rest."""
    n = h if axis == 0 else w
    cut = int(round(at * n))
    first = torch.zeros((h, w), device=device)
    if axis == 0:
        first[:cut] = 1.0
    else:
        first[:, :cut] = 1.0
    return torch.stack([first, 1.0 - first])[..., None]


class Job(NamedTuple):
    """One call of the entry."""

    content: torch.Tensor  # (B, H, W, 3)
    style: torch.Tensor
    seeds: List[int]  # a pair's seed (the single path's cfg.seed)
    alphas: Optional[List[float]]
    content_masks: Optional[torch.Tensor]  # (K, H, W, 1), single pairs
    style_masks: Optional[torch.Tensor]


class Traffic:
    """The jobs of one run: images and masks made once at set-up, and the
    j-th call's pairs, seeds and alphas."""

    def __init__(self, params: Dict, seed: int, device):
        self.p = params
        k = int(params.get("images", 4))
        s = streams(seed, 2 * k + 2)
        ch, cw = params["content_hw"]
        sh, sw = params["style_hw"]
        self.contents = [smooth_image(ch, cw, s[i], device) for i in range(k)]
        self.styles = [smooth_image(sh, sw, s[k + i], device)
                       for i in range(k)]
        self.rng = np.random.default_rng(s[2 * k])
        self.pairs = int(params.get("pairs", 1))
        self.masks = None
        if int(params.get("regions", 0)):
            lo, hi = params.get("boundary", [0.35, 0.65])
            b = np.random.default_rng(s[2 * k + 1]).uniform(lo, hi, 2)
            self.masks = (split_masks(ch, cw, b[0], 0, device),
                          split_masks(sh, sw, b[1], 1, device))
        self.calls = 0

    def job(self) -> Job:
        j, k = self.calls, len(self.contents)
        self.calls += 1
        idx = [(j * self.pairs + b) % k for b in range(self.pairs)]
        content = torch.cat([self.contents[i] for i in idx])
        # a style other than the content's index, turning with the call
        style = torch.cat([self.styles[(i + 1 + j) % k] for i in idx])
        seeds = [int(v) for v in self.rng.integers(0, 2 ** 62,
                                                   size=self.pairs)]
        alphas = self.p.get("alphas")
        return Job(content, style, seeds,
                   None if alphas is None else [float(a) for a in alphas],
                   None if self.masks is None else self.masks[0],
                   None if self.masks is None else self.masks[1])
