"""Fused VGG block1: CUDA kernels K3a (forward) and K3b (backward).

Counterpart of ``strotss_tpu/ops/kernels/block1.py``. Block1 is conv
3->64, ReLU, conv 64->64, ReLU with SAME padding. With x the preprocessed
(H, W, 3) image, the forward returns both taps, (H, W, 64) float32:

    tap1 = relu(conv(r(x), r(k1)) + b1)
    tap2 = relu(conv(r(tap1), r(k2)) + b2)

and the backward returns the image gradient only (the VGG weights are
frozen; their cotangents are zero, as in the JAX package):

    dz2 = r(g2 * [tap2 > 0])
    dy1 = r(conv^T(dz2, r(k2)) * [tap1 > 0] + r(g1 * [tap1 > 0]))
    dx  = conv^T(dy1, r(k1))

where r rounds to ``mul_dtype`` (bf16 in the shipped policy) at the points
where the TPU kernel rounds, and every sum is float32. The ReLU mask is
strict, so the gradient at exactly 0 is 0.

Every function here also takes a leading image axis: x (B, H, W, 3), the
taps and their cotangents (B, H, W, 64), dx (B, H, W, 3). On the card one
launch a direction serves all B images (the kernels walk the tiles of all
of them), and each image's result is bit for bit a one-image launch's.

``block1_fwd`` and ``block1_bwd`` are the wrappers: on CUDA tensors they
launch the kernels of ``csrc/block1.cu`` (whose header states their bound
and design) and count the launches (``launch.block1_fwd``,
``launch.block1_bwd``); on CPU tensors they compute the same
with the plain versions below. Weights arrive as the port's OIHW tensors
and are laid out for the kernels here.

Both kernels compute their convolutions on the tensor cores
(``mma.sync``, bf16 operands, f32 sums) in persistent blocks; K3a and
K3b's dy1 kernel keep the 64x64 conv2 kernel in shared memory. The
wrappers do no per-call weight work: ``fwd_layouts`` and ``bwd_layouts``
build the kernels' layouts, and ``cached_fwd_layouts`` and
``cached_bwd_layouts`` keep them per weight tensor (the VGG weights are
the same module buffers on every step) until a weight is replaced or
edited in place.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input

from strotss_torch.ops.kernels import build
from strotss_torch.ops.kernels.common import (
    check_cuda_f32,
    graph_store,
    launch_on,
    resolve_impl,
)
from strotss_torch.utils.timing import count


def _r(t: torch.Tensor, mul_dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``mul_dtype`` and back to its own dtype."""
    return t.to(mul_dtype).to(t.dtype)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _batched(t: torch.Tensor):
    """(t with a leading image axis, whether one was added)."""
    return (t[None], True) if t.dim() == 3 else (t, False)


def block1_plain(x, k1, b1, k2, b2, mul_dtype=torch.bfloat16):
    """(tap1, tap2), both (B, H, W, 64), from x (B, H, W, 3), or (H, W, 64)
    from (H, W, 3); sums in x's dtype (float32; float64 gives the exactly
    summed reference)."""
    x, one = _batched(x)
    y1 = torch.relu(F.conv2d(_nchw(_r(x, mul_dtype)), _r(k1, mul_dtype),
                             padding=1) + b1[:, None, None])
    y2 = torch.relu(F.conv2d(_r(y1, mul_dtype), _r(k2, mul_dtype),
                             padding=1) + b2[:, None, None])
    tap1, tap2 = _nhwc(y1), _nhwc(y2)
    return (tap1[0], tap2[0]) if one else (tap1, tap2)


def block1_bwd_plain(tap1, tap2, g1, g2, k1, k2, mul_dtype=torch.bfloat16):
    """dx (B, H, W, 3) for the cotangents g1, g2 of the two (B, H, W, 64)
    taps, or (H, W, 3) without the image axis; sums in the taps' dtype."""
    (tap1, one), (tap2, _), (g1, _), (g2, _) = map(_batched,
                                                   (tap1, tap2, g1, g2))
    b, h, w, _ = tap1.shape
    m1 = (tap1 > 0).to(tap1.dtype)
    dz2 = _r(g2 * (tap2 > 0), mul_dtype)
    g1m = _r(g1 * m1, mul_dtype)
    acc = conv2d_input((b, 64, h, w), _r(k2, mul_dtype), _nchw(dz2),
                       padding=1)
    dy1 = _r(_nhwc(acc) * m1 + g1m, mul_dtype)
    dx = _nhwc(conv2d_input((b, 3, h, w), _r(k1, mul_dtype), _nchw(dy1),
                            padding=1))
    return dx[0] if one else dx


def _check_bf16(mul_dtype) -> None:
    if mul_dtype != torch.bfloat16:
        raise ValueError("the block1 kernels compute with bfloat16 operands "
                         f"only, got mul_dtype={mul_dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_layouts(k1, b1, k2, b2):
    """K3a's weight layouts from the OIHW weights, on their device:
    (k1l, b1l, k2l, b2l) with k1l (64, 32) bf16 [co][ky][kx][ci], k padded
    from 27 to 32 with zeros; k2l (3, 3, 64, 64) bf16 [ky][kx][ci][co]; the
    biases float32."""
    k1l = F.pad(k1.permute(0, 2, 3, 1).reshape(64, 27), (0, 5))
    return (k1l.to(torch.bfloat16).contiguous(),
            b1.float().clone(memory_format=torch.contiguous_format),
            k2.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous(),
            b2.float().clone(memory_format=torch.contiguous_format))


def bwd_layouts(k1, k2):
    """K3b's weight layouts from the OIHW weights, on their device. The
    transposed convolutions run as plain ones: each kernel flipped in both
    spatial axes with its channel axes swapped, [ky][kx][K][N] bf16 with K
    the channel read and N the channel written. (k2r, k1r): k2r
    (3, 3, 64, 64) [ky][kx][co][ci]; k1r (3, 3, 64, 8) [ky][kx][co][c], c
    padded from 3 to 8 with zeros."""
    k2r = k2.flip(2, 3).permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
    k1r = F.pad(k1.flip(2, 3).permute(2, 3, 0, 1), (0, 5))
    return k2r, k1r.to(torch.bfloat16).contiguous()


#: (layout name, ids of the source tensors) -> (those tensors, their
#: (device, _version)s, their layouts); the newest _LAYOUTS_KEPT entries
_layouts: "OrderedDict[tuple, tuple]" = OrderedDict()
_LAYOUTS_KEPT = 8


def _cached(name, build_layouts, *src):
    """``build_layouts(*src)``, built once per source tensor.

    The VGG weights are the same module buffers on every step, so a repeat
    call returns the same layout objects. The cache holds the source
    tensors, so their ids stay theirs while an entry lives; an entry
    serves only the same tensors at the same ``_version``, so an in-place
    edit of a weight rebuilds its layouts.
    """
    if graph_store() is not None:
        # a captured graph reads weights whose values a later call may
        # replace in place: it derives the layouts itself on each replay
        return build_layouts(*src)
    key = (name, *map(id, src))
    stamp = tuple((t.device, t._version) for t in src)
    hit = _layouts.get(key)
    if hit is not None and hit[1] == stamp:
        _layouts.move_to_end(key)
        return hit[2]
    out = build_layouts(*src)
    _layouts[key] = (src, stamp, out)
    _layouts.move_to_end(key)
    while len(_layouts) > _LAYOUTS_KEPT:
        _layouts.popitem(last=False)
    return out


def cached_fwd_layouts(k1, b1, k2, b2):
    """``fwd_layouts`` of these weights, built once per weight tensor."""
    return _cached("fwd", fwd_layouts, k1, b1, k2, b2)


def cached_bwd_layouts(k1, k2):
    """``bwd_layouts`` of these weights, built once per weight tensor."""
    return _cached("bwd", bwd_layouts, k1, k2)


def block1_fwd(x, k1, b1, k2, b2, mul_dtype=torch.bfloat16):
    """(tap1, tap2): kernel K3a on CUDA tensors, one launch for all the
    images of x (B, H, W, 3) or for x (H, W, 3)."""
    if not x.is_cuda:
        return block1_plain(x, k1, b1, k2, b2, mul_dtype)
    _check_bf16(mul_dtype)
    *lead, h, w, _ = x.shape
    if len(lead) > 1:
        raise ValueError(f"x must be (H, W, 3) or (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    check_cuda_f32("x", x, (*lead, h, w, 3))
    check_cuda_f32("k1", k1, (64, 3, 3, 3))
    check_cuda_f32("k2", k2, (64, 64, 3, 3))
    k1l, b1l, k2l, b2l = cached_fwd_layouts(k1, b1, k2, b2)
    check_cuda_f32("b1", b1l, (64,))
    check_cuda_f32("b2", b2l, (64,))
    tap1 = torch.empty((*lead, h, w, 64), dtype=torch.float32,
                       device=x.device)
    tap2 = torch.empty_like(tap1)
    launch_on(x.device, "block1_fwd", x.data_ptr(), k1l.data_ptr(),
              b1l.data_ptr(), k2l.data_ptr(), b2l.data_ptr(), h, w,
              lead[0] if lead else 1, tap1.data_ptr(), tap2.data_ptr(),
              _stream(x))
    count("launch.block1_fwd")
    return tap1, tap2


def fwd_setups() -> int:
    """How many times K3a's C entry has set its kernel's shared-memory
    limit in this process: once per device, not once per call."""
    return build.library("block1").block1_fwd_setups()


def block1_bwd(tap1, tap2, g1, g2, k1, k2, mul_dtype=torch.bfloat16):
    """dx: kernel K3b (its two launches count as one) on CUDA tensors, one
    call for all the images of (B, H, W, 64) taps or for (H, W, 64)."""
    if not tap1.is_cuda:
        return block1_bwd_plain(tap1, tap2, g1, g2, k1, k2, mul_dtype)
    _check_bf16(mul_dtype)
    *lead, h, w, _ = tap1.shape
    if len(lead) > 1:
        raise ValueError(f"tap1 must be (H, W, 64) or (B, H, W, 64), got "
                         f"{tuple(tap1.shape)}")
    for name, t in (("tap1", tap1), ("tap2", tap2), ("g1", g1), ("g2", g2)):
        check_cuda_f32(name, t, (*lead, h, w, 64))
    check_cuda_f32("k1", k1, (64, 3, 3, 3))
    check_cuda_f32("k2", k2, (64, 64, 3, 3))
    k2r, k1r = cached_bwd_layouts(k1, k2)
    dy1 = torch.empty((*lead, h, w, 64), dtype=torch.bfloat16,
                      device=tap1.device)
    dx = torch.empty((*lead, h, w, 3), dtype=torch.float32,
                     device=tap1.device)
    launch_on(tap1.device, "block1_bwd", tap1.data_ptr(), tap2.data_ptr(),
              g1.data_ptr(), g2.data_ptr(), k2r.data_ptr(), k1r.data_ptr(),
              h, w, lead[0] if lead else 1, dy1.data_ptr(), dx.data_ptr(),
              _stream(tap1))
    count("launch.block1_bwd")
    return dx


def bwd_setups() -> int:
    """How many times K3b's C entry has set its dy1 kernel's
    shared-memory limit in this process: once per device, not once per
    call."""
    return build.library("block1").block1_bwd_setups()


class Block1(torch.autograd.Function):
    """(tap1, tap2) through K3a, the image gradient through K3b; with
    ``use_kernel`` False, through the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2, mul_dtype, use_kernel):
        fwd = block1_fwd if use_kernel else block1_plain
        tap1, tap2 = fwd(x, k1, b1, k2, b2, mul_dtype)
        ctx.save_for_backward(tap1, tap2, k1, b1, k2, b2)
        ctx.mul_dtype, ctx.use_kernel = mul_dtype, use_kernel
        return tap1, tap2

    @staticmethod
    def backward(ctx, g1, g2):
        tap1, tap2, k1, b1, k2, b2 = ctx.saved_tensors
        g1 = torch.zeros_like(tap1) if g1 is None else g1.contiguous()
        g2 = torch.zeros_like(tap2) if g2 is None else g2.contiguous()
        bwd = block1_bwd if ctx.use_kernel else block1_bwd_plain
        dx = bwd(tap1, tap2, g1, g2, k1, k2, ctx.mul_dtype)
        # frozen weights: zero cotangents, as the JAX package returns
        zero = [torch.zeros_like(t) if need else None for need, t in
                zip(ctx.needs_input_grad[1:5], (k1, b1, k2, b2))]
        return (dx, *zero, None, None)


def block1(x, k1, b1, k2, b2, mul_dtype=torch.bfloat16, impl: str = "auto"):
    """Differentiable fused block1 of x (B, H, W, 3) or (H, W, 3): (tap1,
    tap2) with the same leading axes.

    ``impl``: ``'kernel'`` (K3a/K3b), ``'plain'`` (the plain versions) or
    ``'auto'`` (the kernels on CUDA tensors). Weights are OIHW.
    """
    use_kernel = resolve_impl(impl, x) == "kernel"
    return Block1.apply(x.contiguous(), k1.contiguous(), b1, k2.contiguous(),
                        b2, mul_dtype, use_kernel)
