"""VGG16/19 hypercolumn feature extractor.

Counterpart of ``strotss_tpu/models/vgg.py``. Parameters are a plain dict
``{name: {'kernel': (cout, cin, 3, 3), 'bias': (cout,)}}`` of OIHW tensors
(:mod:`strotss_torch.models.weights` converts the JAX package's HWIO
arrays). The forward pass takes an NHWC image in [0, 1], runs NCHW
``F.conv2d`` with SAME padding, and stops after the deepest tap; each tap
is the post-ReLU activation of its conv, returned as an NHWC view.

Under ``compute_dtype='bfloat16'`` it keeps the JAX package's mixed
policy: block1 runs with float32 operands and float32-stored taps, blocks
2-5 in bfloat16 (the convolution accumulates in float32 inside cuDNN).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

STROTSS_DEFAULT_TAPS = (
    "block1_conv1",
    "block1_conv2",
    "block2_conv1",
    "block2_conv2",
    "block3_conv1",
    "block3_conv2",
    "block3_conv3",
    "block4_conv3",
    "block5_conv3",
)

_BLOCK_CONVS = {"16": (2, 2, 3, 3, 3), "19": (2, 2, 4, 4, 4)}
_BLOCK_WIDTHS = (64, 128, 256, 512, 512)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_CAFFE_BGR_MEAN = (103.939, 116.779, 123.68)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def vgg_layer_names(vgg_type: str = "16") -> List[str]:
    """Ordered conv layer names: block1_conv1 ... block5_convN."""
    vgg_type = str(vgg_type)
    if vgg_type not in _BLOCK_CONVS:
        raise ValueError(f"vgg_type must be 16 or 19, got {vgg_type}")
    return [f"block{b}_conv{c}"
            for b, n in enumerate(_BLOCK_CONVS[vgg_type], start=1)
            for c in range(1, n + 1)]


def vgg_layer_channels(vgg_type: str = "16") -> Dict[str, int]:
    return {name: _BLOCK_WIDTHS[int(name[5]) - 1]
            for name in vgg_layer_names(vgg_type)}


def hypercolumn_channels(taps: Sequence[str] = STROTSS_DEFAULT_TAPS,
                         vgg_type: str = "16") -> int:
    """Total channels of image + tapped maps (2179 for the defaults)."""
    chans = vgg_layer_channels(vgg_type)
    return 3 + sum(chans[t] for t in taps)


def preprocess(x: torch.Tensor, mode: str = "norm") -> torch.Tensor:
    """Input normalization of an NHWC RGB image in [0, 1]."""
    if mode == "norm":
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
        return (x - mean) / std
    if mode == "keras":
        bgr = torch.flip(x * 255.0, dims=(-1,))
        return bgr - torch.tensor(_CAFFE_BGR_MEAN, dtype=x.dtype,
                                  device=x.device)
    raise ValueError(f"Unknown preprocess mode: {mode}")


def _conv(h: torch.Tensor, p: Dict[str, torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    y = F.conv2d(h, p["kernel"].to(dtype), padding=1)
    return torch.relu(y + p["bias"].to(dtype)[None, :, None, None])


def vgg_apply(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    taps: Sequence[str] = STROTSS_DEFAULT_TAPS,
    vgg_type: str = "16",
    preprocess_mode: str = "norm",
    compute_dtype: str = "float32",
) -> List[torch.Tensor]:
    """Run VGG on an NHWC [0,1] RGB image; return the taps (NHWC views)."""
    taps = list(taps)
    names = vgg_layer_names(vgg_type)
    deepest = max(names.index(t) for t in taps)
    dtype = _DTYPES[compute_dtype]
    mixed = dtype == torch.bfloat16
    h = preprocess(x.float(), preprocess_mode).permute(0, 3, 1, 2)
    outs: Dict[str, torch.Tensor] = {}
    idx = 0
    for b, n_convs in enumerate(_BLOCK_CONVS[str(vgg_type)]):
        dt = torch.float32 if (mixed and b == 0) else dtype
        h = h.to(dt)
        for _ in range(n_convs):
            name = names[idx]
            h = _conv(h, params[name], dt)
            if name in taps:
                outs[name] = h.permute(0, 2, 3, 1)
            if idx == deepest:
                return [outs[t] for t in taps]
            idx += 1
        h = F.max_pool2d(h, kernel_size=2, stride=2)
    return [outs[t] for t in taps]


class VGG(torch.nn.Module):
    """The extractor as a module: frozen weights as buffers, ``forward``
    returns the tap list (the caller prepends the image to form the
    hypercolumn)."""

    def __init__(self, params, taps=STROTSS_DEFAULT_TAPS, vgg_type="16",
                 preprocess_mode="norm", compute_dtype="float32"):
        super().__init__()
        self.taps = tuple(taps)
        self.vgg_type = str(vgg_type)
        self.preprocess_mode = preprocess_mode
        self.compute_dtype = compute_dtype
        self.names = vgg_layer_names(self.vgg_type)
        for name in self.names:
            self.register_buffer(f"{name}_kernel", params[name]["kernel"])
            self.register_buffer(f"{name}_bias", params[name]["bias"])

    def params(self):
        return {n: {"kernel": getattr(self, f"{n}_kernel"),
                    "bias": getattr(self, f"{n}_bias")} for n in self.names}

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return vgg_apply(self.params(), x, self.taps, self.vgg_type,
                         self.preprocess_mode, self.compute_dtype)
