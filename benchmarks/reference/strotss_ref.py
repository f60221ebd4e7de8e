"""Plain reference of one STROTSS stylization step, frozen for the benchmark.

Plain PyTorch, float32 with TF32 off, written from the mathematics of the
reference program (STROTSS-tensorflow's ``run_strotss.py``) as the
``strotss_torch`` package states it, and independent of that package:
nothing here imports it. What it covers:

- the scale schedule, the per-scale seed (content Laplacian plus the
  style's mean colour, or the previous result resized) and the Laplacian
  pyramid with its fold;
- the per-scale random draws (the same generator algorithm the program
  states: numpy ``SeedSequence`` seeds, Gumbel top-k without replacement,
  topped up by draws with replacement), so the reference works out every
  coordinate itself;
- VGG16 with the STROTSS taps under the configuration's precision: block1
  on bfloat16 operands with float32 sums and float32 taps, blocks 2-5 on
  bfloat16 values (each convolution, bias add and the gradients through
  them rounded to bfloat16), as ``compute_dtype='bfloat16'`` states; all
  float32 under ``compute_dtype='float32'``;
- hypercolumn sampling (nearest for style targets, bilinear for the paired
  content and prediction rows);
- the losses: self-similarity, moments, relaxed EMD on cosine and on YUV
  with the 'both' distance, and Sinkhorn above the memory gate with the
  converged-plan (Danskin) gradient;
- the gradient back to the pyramid and RMSprop with eps inside the root.

``precision='control'`` computes the same in the next precision below the
configuration's: VGG on float8 (e4m3, one scale a tensor) where the
configuration states bfloat16, and the losses' matrix products on TF32
operands where it states float32 with TF32 off. The benchmark's tests and
``benchmarks/tools/control.py`` use it; a run never does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input

TAPS = ("block1_conv1", "block1_conv2", "block2_conv1", "block2_conv2",
        "block3_conv1", "block3_conv2", "block3_conv3", "block4_conv3",
        "block5_conv3")
CONVS = (2, 2, 3, 3, 3)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
RGB_TO_YUV = ((0.299, -0.14714119, 0.61497538),
              (0.587, -0.28886916, -0.51496512),
              (0.114, 0.43601035, -0.10001026))
NORM_EPS, DIST_EPS, COLSUM_EPS = 1e-12, 1e-6, 1e-12
#: Sinkhorn streams, with the Danskin gradient, once N * M passes this
GATE = 2 ** 30
RHO, EPS = 0.99, 1e-8


class exact:
    """Float32 products in full float32 (TF32 off for matmuls and
    convolutions) inside the ``with``; the switches are restored after."""

    def __enter__(self):
        b = torch.backends
        self.saved = (torch.get_float32_matmul_precision(),
                      b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        torch.set_float32_matmul_precision("highest")
        b.cuda.matmul.allow_tf32 = False
        b.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved[0])
        torch.backends.cuda.matmul.allow_tf32 = self.saved[1]
        torch.backends.cudnn.allow_tf32 = self.saved[2]
        return False


def layer_names() -> List[str]:
    return [f"block{b}_conv{c}" for b, n in enumerate(CONVS, start=1)
            for c in range(1, n + 1)]


# ---------------------------------------------------------------- rounding

def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, ties away from zero."""
    bits = v.float().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    out = ((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    return torch.where(mag >= 0x7F800000, bits, out).view(torch.float32)


def fp8(v: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale for the tensor (its largest value at
    448), back in float32."""
    s = v.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (v / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    """Where the reference rounds: ``low`` the values the configuration
    keeps in bfloat16 (None: none), ``mm`` the operands of the losses'
    matrix products (None: exact float32)."""

    def __init__(self, compute_dtype: str, control: bool = False):
        bf16 = compute_dtype == "bfloat16"
        if control:
            self.low = fp8 if bf16 else (lambda t: t.to(torch.bfloat16)
                                         .float())
            self.mm = tf32
        else:
            self.low = (lambda t: t.to(torch.bfloat16).float()) if bf16 \
                else None
            self.mm = None

    def matmul(self, a, b):
        if self.mm is None:
            return a @ b
        return _Round.apply(a, self.mm) @ _Round.apply(b, self.mm)


class _Round(torch.autograd.Function):
    """Rounds the value and its gradient (a tensor stored, or a product's
    operand taken, in low precision)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _low(prec: Precision, x):
    return x if prec.low is None else _Round.apply(x, prec.low)


# -------------------------------------------------------------- image ops

def hw_of(x: torch.Tensor) -> Tuple[int, int]:
    return int(x.shape[1]), int(x.shape[2])


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear, half-pixel centres, no antialiasing, NHWC."""
    if hw_of(x) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1)


def resize_max_hw(h: int, w: int, max_size: int) -> Tuple[int, int]:
    f = max(h / max_size, w / max_size)
    return int(h / f), int(w / f)


def laplacian(x):
    h, w = hw_of(x)
    down = resize(x, (max(h // 2, 1), max(w // 2, 1)))
    return x - resize(down, (h, w)), down


def pyramid_of(x, levels: int) -> List[torch.Tensor]:
    bands, cur = [], x
    for _ in range(levels):
        band, cur = laplacian(cur)
        bands.append(band)
    return bands + [cur]


def fold(bands: Sequence[torch.Tensor]) -> torch.Tensor:
    out = bands[-1]
    for band in reversed(bands[:-1]):
        out = band + resize(out, hw_of(band))
    return out


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Clip, min-max renormalize, uint8, first image."""
    x = torch.clamp(x, 0.0, 1.0)
    x = x - torch.min(x)
    x = x / torch.max(x)
    return (x * 255.0).to(torch.uint8)[0]


def yuv(x: torch.Tensor) -> torch.Tensor:
    k = torch.tensor(RGB_TO_YUV, dtype=torch.float32, device=x.device)
    return x[..., :3] @ k


# ------------------------------------------------------------------ draws

def generators(seed: int, scale: int, device):
    """(style draws', step draws') generators of one scale."""
    gens = []
    for stream in (0, 1):
        w = np.random.SeedSequence([seed % 2 ** 64, scale, stream]) \
            .generate_state(2)
        g = torch.Generator(device=device)
        g.manual_seed(int(w[0]) | (int(w[1]) & 0x7FFFFFFF) << 32)
        gens.append(g)
    return gens


def _pick(gen, valid: torch.Tensor, k: int, min_valid: int):
    p = valid.shape[0]
    if p < k:
        valid = torch.cat([valid, valid.new_zeros(k - p)])
        p = k
    u = torch.rand(p, generator=gen, device=valid.device)
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    idx = torch.topk(torch.where(valid, g, torch.full_like(g, -math.inf)),
                     k).indices
    if min_valid >= k:
        return idx
    extra = torch.multinomial(valid.float(), k, replacement=True,
                              generator=gen)
    return torch.where(valid[idx], idx, extra)


def mask_at(mask: torch.Tensor, hw) -> torch.Tensor:
    """(h, w) {0, 1} map of a (H, W, 1) region mask at ``hw``; all valid
    when the resized mask stays under 0.1."""
    m = resize(mask[None].float(), hw)[0, ..., 0]
    valid = (m > 0.5).float()
    return torch.where(m.max() < 0.1, torch.ones_like(valid), valid)


def style_coords(gen, hw, n: int, device, mask=None) -> torch.Tensor:
    h, w = hw
    valid = torch.ones(h * w, dtype=torch.bool, device=device)
    least = h * w
    if mask is not None:
        inside = mask.reshape(-1) > 0.5
        valid = torch.where(inside.any(), inside, valid)
        least = 0
    idx = _pick(gen, valid, n, least)
    return torch.stack([idx // w, idx % w], 1).float()


def paired_coords(gen, hw, n: int, device, mask=None) -> torch.Tensor:
    h, w = hw
    area = math.sqrt((h * w) // (128 ** 2))
    sx, sy = max(1, math.floor(area)), max(1, math.ceil(area))
    nx, ny = -(-h // sx), -(-w // sy)
    ox = torch.randint(0, sx, (1,), generator=gen, device=device)
    oy = torch.randint(0, sy, (1,), generator=gen, device=device)
    gx = (ox + torch.arange(nx, device=device) * sx).repeat_interleave(ny)
    gy = (oy + torch.arange(ny, device=device) * sy).repeat(nx)
    inb = (gx < h) & (gy < w)
    valid, least = inb, (h // sx) * (w // sy)
    if mask is not None:
        inside = inb & (mask[gx.clamp(0, h - 1), gy.clamp(0, w - 1)] > 0.5)
        valid = torch.where(inside.any(), inside, inb)
        least = 0
    idx = _pick(gen, valid, n, least)
    return torch.stack([gx[idx], gy[idx]], 1).float()


# --------------------------------------------------------------- sampling

def factors(shapes) -> List[float]:
    out, f, axis = [1.0], 1.0, None
    for i in range(1, len(shapes)):
        if shapes[i][0] < shapes[i - 1][0]:
            if axis is None:
                axis = 0 if math.log2(shapes[i][0]) % 1 == 0 else 1
            f /= shapes[i - 1][axis] / shapes[i][axis]
        out.append(f)
    return out


def _nearest(fmap, c):
    h, w = fmap.shape[:2]
    return fmap[c[:, 0].clamp(0, h - 1).long(), c[:, 1].clamp(0, w - 1).long()]


def _bilinear(fmap, c):
    h, w = fmap.shape[:2]
    fx, fy = torch.floor(c[:, 0]), torch.floor(c[:, 1])
    dx, dy = c[:, 0] - fx, c[:, 1] - fy
    x0, y0 = fx.clamp(0, h - 1).long(), fy.clamp(0, w - 1).long()
    x1, y1 = (fx + 1).clamp(0, h - 1).long(), (fy + 1).clamp(0, w - 1).long()
    out = None
    for xi, yi, wt in ((x0, y0, (1 - dx) * (1 - dy)), (x0, y1, (1 - dx) * dy),
                       (x1, y0, dx * (1 - dy)), (x1, y1, dx * dy)):
        t = fmap[xi, yi].float() * wt[:, None]
        out = t if out is None else out + t
    return out


def sample(columns, coords, bilinear: bool) -> torch.Tensor:
    """Rows of the hypercolumn [image, taps...] (each (1, h, w, c)) at the
    base-resolution ``coords``; maps at the base resolution take the
    nearest lookup, which equals the bilinear one at integer coords."""
    maps = [m[0] for m in columns]
    fs = factors([tuple(m.shape[:2]) for m in maps])
    parts = []
    for fmap, f in zip(maps, fs):
        c = coords * f if f != 1.0 else coords
        parts.append((_bilinear(fmap, c) if bilinear and f != 1.0
                      else _nearest(fmap, c)).float())
    return torch.cat(parts, 1)


# -------------------------------------------------------------------- VGG

class _Block1(torch.autograd.Function):
    """Block1 on rounded operands with float32 sums and float32 taps; the
    backward rounds its cotangents as the forward rounds its operands."""

    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2, fn):
        r = (lambda t: t) if fn is None else fn
        y1 = torch.relu(F.conv2d(r(x), r(k1), padding=1) + b1[:, None, None])
        y2 = torch.relu(F.conv2d(r(y1), r(k2), padding=1)
                        + b2[:, None, None])
        ctx.save_for_backward(y1, y2, k1, k2)
        ctx.fn = r
        ctx.xshape = x.shape
        return y1, y2

    @staticmethod
    def backward(ctx, g1, g2):
        y1, y2, k1, k2 = ctx.saved_tensors
        r = ctx.fn
        m1 = (y1 > 0).float()
        dz2 = r(g2 * (y2 > 0))
        dy1 = r(conv2d_input(y1.shape, r(k2), dz2, padding=1) * m1
                + r(g1 * m1))
        dx = conv2d_input(ctx.xshape, r(k1), dy1, padding=1)
        return dx, None, None, None, None, None


def vgg(weights, x: torch.Tensor, prec: Precision) -> List[torch.Tensor]:
    """The 9 taps (NHWC, float32 values) of an NHWC [0, 1] image.
    ``weights``: {name: {'kernel': OIHW, 'bias': (cout,)}}."""
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    h = ((x.float() - mean) / std).permute(0, 3, 1, 2)
    kb = {n: (p["kernel"], p["bias"]) for n, p in weights.items()}
    (k1, b1), (k2, b2) = kb["block1_conv1"], kb["block1_conv2"]
    y1, y2 = _Block1.apply(h, k1, b1, k2, b2, prec.low)
    taps = {"block1_conv1": y1, "block1_conv2": y2}
    names = layer_names()
    idx, h = 2, y2
    for n in CONVS[1:]:
        h = _low(prec, F.max_pool2d(h, 2, 2))
        for _ in range(n):
            k, b = kb[names[idx]]
            lk = k if prec.low is None else prec.low(k)
            lb = b if prec.low is None else prec.low(b)
            c = _low(prec, F.conv2d(h, lk, padding=1))
            h = torch.relu(_low(prec, c + lb[None, :, None, None]))
            taps[names[idx]] = h
            idx += 1
    return [taps[t].permute(0, 2, 3, 1) for t in TAPS]


def columns(weights, img, prec: Precision):
    return [img] + vgg(weights, img, prec)


# ----------------------------------------------------------------- losses

def unit_rows(x):
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, 1, keepdim=True),
                                       min=NORM_EPS))


def cosine(x, y, prec):
    return 1.0 - prec.matmul(unit_rows(x), unit_rows(y).T)


def l2(x, y, prec):
    m = (torch.sum(x * x, 1)[:, None] + torch.sum(y * y, 1)[None, :]
         - 2.0 * prec.matmul(x, y.T))
    return torch.sqrt(torch.clamp(m, min=DIST_EPS) / x.shape[1])


def distance(x, y, kind: str, prec):
    d = cosine(x, y, prec)
    return d if kind == "cosine" else d + l2(x, y, prec)


def moments(x, prec):
    m = torch.mean(x, 0, keepdim=True)
    c = x - m
    return m, prec.matmul(c.T, c) / x.shape[0]


def remd(x, y, kind, prec):
    d = distance(x, y, kind, prec)
    return torch.maximum(torch.mean(torch.min(d, 1).values),
                         torch.mean(torch.min(d, 0).values))


class _SelfSim(torch.autograd.Function):
    """``sum |Dx/cx - Dy/cy| / N`` of the unit rows ``xh`` (the
    prediction's, differentiated) and ``yh`` (the content's), with
    ``D = 1 - h h^T`` and ``c`` its column sums, computed in row blocks so
    that N = 32769 fits: dL/dxh = -(G + G^T) xh with
    G_ij = (s_ij / cx_j - t_j / cx_j^2) / N, s = sign(Dx/cx - Dy/cy),
    t_j = sum_i s_ij Dx_ij."""

    @staticmethod
    def forward(ctx, xh, yh, prec, block):
        n = xh.shape[0]
        cx = torch.clamp(n - xh @ xh.sum(0), min=COLSUM_EPS)
        cy = torch.clamp(n - yh @ yh.sum(0), min=COLSUM_EPS)
        total = xh.new_zeros(())
        t = torch.zeros_like(cx)
        for i in range(0, n, block):
            dx = 1.0 - prec.matmul(xh[i:i + block], xh.T)
            diff = dx / cx - (1.0 - prec.matmul(yh[i:i + block], yh.T)) / cy
            total += diff.abs().sum()
            t += (torch.sign(diff) * dx).sum(0)
        ctx.save_for_backward(xh, yh, cx, cy, t)
        ctx.prec, ctx.block = prec, block
        return total / n

    @staticmethod
    def backward(ctx, g):
        xh, yh, cx, cy, t = ctx.saved_tensors
        prec, block, n = ctx.prec, ctx.block, xh.shape[0]
        xs = xh / cx[:, None]
        rows = torch.empty_like(xh)
        cols = torch.zeros_like(xh)
        for i in range(0, n, block):
            dx = 1.0 - prec.matmul(xh[i:i + block], xh.T)
            s = torch.sign(dx / cx - (1.0 - prec.matmul(yh[i:i + block],
                                                        yh.T)) / cy)
            rows[i:i + block] = prec.matmul(s, xs)
            cols += prec.matmul(s.T, xh[i:i + block])
        v = (xh * (t / (cx * cx))[:, None]).sum(0)
        gx = rows - v + cols / cx[:, None] - (t / (cx * cx))[:, None] \
            * xh.sum(0)
        return -g * gx / n, None, None, None


def self_similarity(pred, content, prec, block: int = 2048):
    return _SelfSim.apply(unit_rows(pred), unit_rows(content).detach(),
                          prec, block)


class _SinkhornDanskin(torch.autograd.Function):
    """``<T, d>`` after ``iters`` log-domain Sinkhorn iterations (u from v,
    then v from the new u; uniform marginals), with the gradient of the
    read-out at the plan T held fixed."""

    @staticmethod
    def forward(ctx, x, y, kind, lam, iters, prec, block):
        n, m = x.shape[0], y.shape[0]
        log_p, log_q = -math.log(n), -math.log(m)
        log_u, log_v = x.new_zeros(n), x.new_zeros(m)
        d = distance(x, y, kind, prec)
        log_k = -lam * d
        for _ in range(iters):
            log_u = log_p - torch.logsumexp(log_k + log_v[None], 1)
            log_v = log_q - torch.logsumexp(log_k + log_u[:, None], 0)
        total = torch.sum(torch.exp(log_u[:, None] + log_k + log_v[None]) * d)
        del d, log_k
        ctx.save_for_backward(x, y, log_u, log_v)
        ctx.args = (kind, lam, prec, block)
        return total

    @staticmethod
    def backward(ctx, g):
        x, y, log_u, log_v = ctx.saved_tensors
        kind, lam, prec, block = ctx.args
        dx, dy = torch.zeros_like(x), torch.zeros_like(y)
        yl = y.detach().requires_grad_(True)
        with torch.enable_grad():
            for i in range(0, x.shape[0], block):
                xb = x[i:i + block].detach().requires_grad_(True)
                d = distance(xb, yl, kind, prec)
                plan = torch.exp(log_u[i:i + block, None] - lam * d
                                 + log_v[None]).detach()
                gx, gy = torch.autograd.grad(torch.sum(plan * d), (xb, yl))
                dx[i:i + block] = gx
                dy += gy
        return g * dx, g * dy, None, None, None, None, None


def transport(x, y, kind, cfg, prec):
    if not cfg["use_sinkhorn"]:
        return remd(x, y, kind, prec)
    if x.shape[0] * y.shape[0] <= GATE:
        raise NotImplementedError(
            "the materialized Sinkhorn below the gate is not in this "
            "reference; no cell runs it")
    return _SinkhornDanskin.apply(x, y, kind, cfg["sinkhorn_lambda"],
                                  cfg["sinkhorn_iters"], prec, 512)


def step_loss(cfg, prec, content_cols, pred_cols, targets, alpha, coords,
              weights=None):
    """(loss, loss_c, loss_s) of one step: one entry a region in
    ``coords`` (K, n, 2) and ``targets`` (K, n, C)."""
    denom = 2.0 + alpha + 1.0 / max(alpha, 1.0)
    k = coords.shape[0]
    lc = ls = 0.0
    for r in range(k):
        c_rows = sample(content_cols, coords[r], True)
        p_rows = sample(pred_cols, coords[r], True)
        lc_r = self_similarity(p_rows, c_rows, prec)
        tgt = targets[r]
        tm, tv = moments(tgt, prec)
        pm, pv = moments(p_rows, prec)
        ls_r = (torch.mean(torch.abs(tv - pv)) + torch.mean(torch.abs(tm - pm))
                + transport(tgt, p_rows, "cosine", cfg, prec)
                + transport(yuv(tgt), yuv(p_rows), "both", cfg, prec)
                / max(alpha, 1.0))
        w = 1.0 / k if weights is None else weights[r]
        lc, ls = lc + lc_r * w, ls + ls_r * w
    return (alpha * lc + ls) / denom, lc, ls


# ------------------------------------------------------------- the solver

class Scale:
    """What one scale of one pair holds: its shapes, step size and alpha,
    the content's hypercolumn, the style targets and the step
    generator."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def scale_sizes(cfg) -> List[int]:
    return [2 << (5 + i) for i in range(cfg["levels"])]


def alpha_at(cfg, scale: int, alpha: Optional[float] = None) -> float:
    a = (cfg["alpha"] if alpha is None else alpha) * 16.0
    return a / 2 ** scale


def prepare_scale(cfg, prec, weights, content, style, scale: int, seed: int,
                  content_masks=None, style_masks=None,
                  alpha: Optional[float] = None) -> Scale:
    """Scale ``scale``'s set-up for one pair: its shapes, the content's
    hypercolumn, the style targets drawn from the scale's style generator
    (one set a region of ``style_masks``), and the step generator."""
    size = scale_sizes(cfg)[scale]
    chw = resize_max_hw(content.shape[1], content.shape[2], size)
    shw = resize_max_hw(style.shape[1], style.shape[2], size)
    n, dev = cfg["sample_size"], content.device
    g_style, g_step = generators(seed, scale, dev)
    with torch.no_grad():
        c_cols = columns(weights, resize(content, chw), prec)
        s_cols = columns(weights, resize(style, shw), prec)
        smasks = ([mask_at(m, shw) for m in style_masks]
                  if style_masks is not None else [None])
        targets = torch.stack([sample(s_cols, style_coords(g_style, shw, n,
                                                           dev, m), False)
                               for m in smasks])
    cmasks = ([mask_at(m, chw) for m in content_masks]
              if content_masks is not None else [None])
    last = scale == cfg["levels"] - 1 and scale > 0
    return Scale(index=scale, chw=chw, shw=shw, content_cols=c_cols,
                 targets=targets, gen=g_step, cmasks=cmasks,
                 lr=cfg["lr"] / 2 if last else cfg["lr"],
                 alpha=alpha_at(cfg, scale, alpha))


def seed_pyramid(cfg, content, style, scale: int, prev=None):
    """The pyramid a scale starts from: 'first' the content's Laplacian
    plus the style's mean colour, 'mid' the previous result resized plus
    the Laplacian, 'last' the previous result resized."""
    size = scale_sizes(cfg)[scale]
    chw = resize_max_hw(content.shape[1], content.shape[2], size)
    shw = resize_max_hw(style.shape[1], style.shape[2], size)
    c = resize(content, chw)
    lap = laplacian(c)[0]
    if scale == 0:
        img = lap + torch.mean(resize(style, shw), dim=(1, 2), keepdim=True)
    elif scale < cfg["levels"] - 1:
        img = resize(prev, chw) + lap
    else:
        img = resize(prev, chw)
    return pyramid_of(img, cfg["pyramid_levels"])


def follow(cfg, prec, weights, sc: Scale, pyramid, steps: int,
           weights_r=None):
    """``steps`` reference steps from ``pyramid`` (left as it is): the
    (steps, 3) loss rows, the RMSprop slots after the first step and the
    pyramid after the last."""
    params = [p.detach().clone() for p in pyramid]
    nu = [torch.zeros_like(p) for p in params]
    rows, nu1 = [], None
    n, dev = cfg["sample_size"], params[0].device
    for t in range(steps):
        coords = torch.stack([paired_coords(sc.gen, sc.chw, n, dev, m)
                              for m in sc.cmasks])
        leaves = [p.requires_grad_(True) for p in params]
        loss, lc, ls = step_loss(cfg, prec, sc.content_cols,
                                 columns(weights, fold(leaves), prec),
                                 sc.targets, sc.alpha, coords, weights_r)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g, v in zip(params, grads, nu):
                v.copy_((1 - RHO) * (g * g) + RHO * v)
                p.add_((g * torch.rsqrt(v + EPS)) * (-sc.lr))
        params = [p.detach() for p in params]
        rows.append(torch.stack([loss.detach(), torch.as_tensor(lc).detach(),
                                 torch.as_tensor(ls).detach()]))
        if t == 0:
            nu1 = [v.clone() for v in nu]
    return torch.stack(rows), nu1, params
