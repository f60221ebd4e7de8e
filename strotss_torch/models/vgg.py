"""VGG16/19 hypercolumn feature extractor.

Counterpart of ``strotss_tpu/models/vgg.py``. Parameters are a plain dict
``{name: {'kernel': (cout, cin, 3, 3), 'bias': (cout,)}}`` of OIHW tensors
(:mod:`strotss_torch.models.weights` converts the JAX package's HWIO
arrays). The forward pass takes an NHWC image in [0, 1], runs NCHW
``F.conv2d`` with SAME padding, and stops after the deepest tap; each tap
is the post-ReLU activation of its conv, returned as an NHWC view.

Under ``compute_dtype='bfloat16'`` it keeps the JAX package's mixed
policy: block1 runs with float32-stored taps, blocks 2-5 in bfloat16 (the
convolution accumulates in float32 inside cuDNN). ``block1_impl`` picks
block1's route, as the JAX package's does: ``'xla'`` runs it as two
float32 ``F.conv2d`` calls; ``'pallas'`` runs it fused through
:func:`strotss_torch.ops.kernels.block1.block1` (kernel K3 on a CUDA
tensor, its plain version on the CPU), with bf16 operands and float32
sums, the rounding of the JAX package's DEFAULT-precision block1;
``'plain'`` takes that fused function's plain version on any device (to
hold the kernel to it on the card). The fused route is taken under the
bf16 policy when a tap lies past ``block1_conv1``, for any batch: B
images go through one launch of K3a (and of K3b in the backward);
otherwise block1 runs as ``'xla'``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from strotss_torch.ops.image import device_constant
from strotss_torch.ops.kernels import block1 as _block1

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
        mean = device_constant(_IMAGENET_MEAN, x.dtype, x.device)
        std = device_constant(_IMAGENET_STD, x.dtype, x.device)
        return (x - mean) / std
    if mode == "keras":
        bgr = torch.flip(x * 255.0, dims=(-1,))
        return bgr - device_constant(_CAFFE_BGR_MEAN, x.dtype, x.device)
    raise ValueError(f"Unknown preprocess mode: {mode}")


def _conv(h: torch.Tensor, p: Dict[str, torch.Tensor], dtype: torch.dtype,
          slab=None, level: int = 0) -> torch.Tensor:
    k = p["kernel"].to(dtype)
    y = F.conv2d(h, k, padding=1) if slab is None else slab.conv(h, k, level)
    return torch.relu(y + p["bias"].to(dtype)[None, :, None, None])


def _block1_convs(h: torch.Tensor, params, names: Sequence[str],
                  dtype: torch.dtype, fused: bool, block1_impl: str,
                  slab=None):
    """Block1's convolutions ``names`` (one or both) of the NCHW image
    ``h``: their NCHW outputs, fused through K3 or as ``F.conv2d``. Under
    a ``slab``, ``h`` is the extended slab and the outputs are this rank's
    rows."""
    if not fused:
        if slab is not None:
            return slab.block1(lambda t: _block1_convs(
                t, params, names, dtype, False, block1_impl), h, len(names),
                _BLOCK_WIDTHS[0])
        out = []
        for name in names:
            h = _conv(h, params[name], dtype)
            out.append(h)
        return out
    p1, p2 = params["block1_conv1"], params["block1_conv2"]
    fn = _block1.block1 if slab is None else slab.fused_block1
    taps = fn(h.permute(0, 2, 3, 1), p1["kernel"], p1["bias"], p2["kernel"],
              p2["bias"], impl="auto" if block1_impl == "pallas" else "plain")
    return [t.permute(0, 3, 1, 2) for t in taps]


def vgg_apply(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    taps: Sequence[str] = STROTSS_DEFAULT_TAPS,
    vgg_type: str = "16",
    preprocess_mode: str = "norm",
    compute_dtype: str = "float32",
    block1_impl: str = "xla",
    slab=None,
) -> List[torch.Tensor]:
    """Run VGG on an NHWC [0,1] RGB image; return the taps (NHWC views).

    ``block1_impl``: ``'xla'``, ``'pallas'`` or ``'plain'`` (module doc).
    ``slab`` (:class:`strotss_torch.parallel.spatial.Slab`): run on this
    rank's rows of the replicated image ``x`` only, and return this rank's
    rows of each tap: block1 on the rows with 4 extra a side, cropped;
    blocks 2-5 with the halo exchange.
    """
    if block1_impl not in ("xla", "pallas", "plain"):
        raise ValueError("block1_impl must be 'xla', 'pallas' or 'plain', "
                         f"got {block1_impl!r}")
    taps = list(taps)
    names = vgg_layer_names(vgg_type)
    deepest = max(names.index(t) for t in taps)
    dtype = _DTYPES[compute_dtype]
    mixed = dtype == torch.bfloat16
    if slab is not None:
        x = slab.extended(x)
    h = preprocess(x.float(), preprocess_mode).permute(0, 3, 1, 2)
    outs: Dict[str, torch.Tensor] = {}
    fused = block1_impl != "xla" and mixed and deepest >= 1
    n_convs = _BLOCK_CONVS[str(vgg_type)]
    # block1 at full resolution: float32-stored taps under the bf16 policy
    run = names[:min(n_convs[0], deepest + 1)]
    dt = torch.float32 if mixed else dtype
    h = h.to(dt)

    ys = _block1_convs(h, params, run, dt, fused, block1_impl, slab)
    for name, y in zip(run, ys):
        if name in taps:
            outs[name] = y.permute(0, 2, 3, 1)
    idx = len(run)
    h = ys[-1]
    for b, n in enumerate(n_convs[1:], start=1):
        if idx > deepest:
            break
        h = (F.max_pool2d(h, kernel_size=2, stride=2) if slab is None
             else slab.pool(h)).to(dtype)
        for _ in range(n):
            name = names[idx]
            h = _conv(h, params[name], dtype, slab, b)
            if name in taps:
                outs[name] = h.permute(0, 2, 3, 1)
            idx += 1
            if idx > deepest:
                break
    return [outs[t] for t in taps]


class VGG(torch.nn.Module):
    """The extractor as a module: frozen weights as buffers, ``forward``
    returns the tap list (the caller prepends the image to form the
    hypercolumn)."""

    def __init__(self, params, taps=STROTSS_DEFAULT_TAPS, vgg_type="16",
                 preprocess_mode="norm", compute_dtype="float32",
                 block1_impl="xla"):
        super().__init__()
        self.taps = tuple(taps)
        self.block1_impl = block1_impl
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

    def forward(self, x: torch.Tensor, slab=None) -> List[torch.Tensor]:
        return vgg_apply(self.params(), x, self.taps, self.vgg_type,
                         self.preprocess_mode, self.compute_dtype,
                         self.block1_impl, slab)
