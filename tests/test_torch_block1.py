"""The port's fused VGG block1 (kernel K3's plain version on the CPU)
against the JAX package's ``block1_pallas`` in interpret mode, its VGG
wiring, the route's gate, and a short whole run through it.

Tolerances: the taps to 1e-5 of their largest value and dx to 1e-5
(bf16 operands) or 1e-4 (float32 operands, as tests/test_kernels.py holds
the JAX kernel's own gradient) of its largest value. Both sides round to
bf16 at the same points and sum products of bf16 values, which are exact
in float32, so only the order of the float32 sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch.models import vgg as TV
from strotss_torch.models.weights import params_from_jax
from strotss_torch.ops.kernels import block1 as B
from strotss_torch.programs import spec_from_config
from strotss_torch.solve import stylize_single
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models import vgg as JV
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops.kernels.block1 import block1_pallas
from strotss_tpu.solve import stylize_single as jax_stylize_single
from test_torch_step import _jax_coords

_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _weights(seed):
    """HWIO numpy weights at the scales tests/test_kernels.py uses."""
    rng = np.random.default_rng(seed)
    return {
        "block1_conv1": {"kernel": (rng.standard_normal((3, 3, 3, 64)) * 0.2
                                    ).astype(np.float32),
                         "bias": (rng.standard_normal(64) * 0.1
                                  ).astype(np.float32)},
        "block1_conv2": {"kernel": (rng.standard_normal((3, 3, 64, 64))
                                    * 0.05).astype(np.float32),
                         "bias": (rng.standard_normal(64) * 0.1
                                  ).astype(np.float32)},
    }


def _args(p):
    return (p["block1_conv1"]["kernel"], p["block1_conv1"]["bias"],
            p["block1_conv2"]["kernel"], p["block1_conv2"]["bias"])


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", [((13, 11), 4), ((16, 8), 8),
                                        ((7, 21), 4)])
def test_plain_block1_matches_jax_pallas(shape, rows, dtype):
    t_dtype, j_dtype = _DTYPES[dtype]
    h, w = shape
    rng = np.random.default_rng(h * 100 + w)
    x = rng.standard_normal((h, w, 3)).astype(np.float32)
    g1 = rng.standard_normal((h, w, 64)).astype(np.float32)
    g2 = rng.standard_normal((h, w, 64)).astype(np.float32)
    hwio = _weights(h + w)
    (t1j, t2j), vjp = jax.vjp(
        lambda x: block1_pallas(x, *map(jnp.asarray, _args(hwio)), rows,
                                j_dtype, True), jnp.asarray(x))
    (dxj,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))

    xt = torch.tensor(x, requires_grad=True)
    t1, t2 = B.block1(xt, *_args(params_from_jax(hwio)), t_dtype)
    (dx,) = torch.autograd.grad((t1, t2), [xt],
                                (torch.tensor(g1), torch.tensor(g2)))
    assert t1.shape == t2.shape == (h, w, 64) and dx.shape == (h, w, 3)
    assert _rel_err(t1.detach(), t1j) <= 1e-5
    assert _rel_err(t2.detach(), t2j) <= 1e-5
    assert _rel_err(dx, dxj) <= (1e-5 if dtype == "bfloat16" else 1e-4)


def test_weights_get_zero_gradients():
    """Frozen VGG: the weights' cotangents are zeros, as the JAX package's
    ``block1_pallas`` returns (test_block1_pallas_weight_grads_are_zero)."""
    x = torch.tensor(np.random.default_rng(3).standard_normal((9, 10, 3)),
                     dtype=torch.float32, requires_grad=True)
    ws = [t.clone().requires_grad_(True)
          for t in _args(params_from_jax(_weights(3)))]
    _, t2 = B.block1(x, *ws)
    grads = torch.autograd.grad(t2.sum(), [x] + ws)
    assert float(grads[0].abs().max()) > 0
    for g in grads[1:]:
        assert float(g.abs().max()) == 0.0


def test_vgg_fused_block1_matches_jax():
    """tests/test_kernels.py:295-314's path on both sides: bf16 policy,
    fused block1, taps through block2_conv1. block2 runs in bf16 on both
    sides, and its bf16 outputs may round one way in PyTorch and the other
    in XLA, one bf16 step (2^-8 relative) of an entry: so block2_conv1 is
    held to 1e-2 of its largest value, the block1 taps to 1e-5."""
    jp = jax.tree.map(np.asarray, jax_random_params("16", 0))
    x = np.random.default_rng(4).random((1, 14, 12, 3)).astype(np.float32)
    taps = ("block1_conv1", "block1_conv2", "block2_conv1")
    want = JV.vgg_apply(jp, jnp.asarray(x), taps=taps,
                        compute_dtype=jnp.bfloat16, block1_impl="pallas",
                        block1_interpret=True)
    got = TV.vgg_apply(params_from_jax(jp), torch.tensor(x), taps=taps,
                       compute_dtype="bfloat16", block1_impl="pallas")
    assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                      torch.bfloat16]
    for g, wnt, tol in zip(got, want, (1e-5, 1e-5, 1e-2)):
        assert tuple(g.shape) == tuple(wnt.shape)
        assert _rel_err(g.float().numpy(), np.asarray(wnt, np.float32)) <= tol


@pytest.mark.parametrize("taps,fused", [
    (("block1_conv1",), False),
    (("block1_conv2",), True),
    (("block1_conv1", "block2_conv1"), True),
])
def test_vgg_fuses_only_past_block1_conv1(monkeypatch, taps, fused):
    """The fused route needs a tap past block1_conv1 (as the JAX package's
    ``deepest >= 1``); otherwise block1 runs as F.conv2d."""
    calls = []
    real = B.block1
    monkeypatch.setattr(B, "block1",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.rand((1, 12, 10, 3), generator=torch.Generator().manual_seed(0))
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jax_random_params("16", 0)))
    got = TV.vgg_apply(params, x, taps=taps, compute_dtype="bfloat16",
                       block1_impl="pallas")
    assert bool(calls) == fused
    ref = TV.vgg_apply(params, x, taps=taps, compute_dtype="bfloat16")
    if not fused:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("kw,device,want", [
    (dict(compute_dtype="float32", block1_impl="pallas"), "cuda", "xla"),
    (dict(use_pallas=False), "cuda", "xla"),
    (dict(), "cuda", "pallas"),
    (dict(), "cuda:1", "pallas"),
    (dict(), "cpu", "xla"),
    (dict(block1_impl="pallas"), "cpu", "pallas"),
    (dict(block1_impl="xla"), "cuda", "xla"),
])
def test_block1_route_gate(kw, device, want):
    cfg = strotss_torch.StrotssConfig(**kw)
    assert spec_from_config(cfg, device).block1_impl == want


def test_block1_route_rejects_unknown_values():
    cfg = strotss_torch.StrotssConfig(block1_impl="cudnn")
    with pytest.raises(ValueError, match="block1_impl"):
        spec_from_config(cfg, "cpu")
    with pytest.raises(ValueError, match="block1_impl"):
        stylize_single(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 8, 8, 3)),
                       cfg, {})
    with pytest.raises(ValueError, match="block1_impl"):
        TV.vgg_apply({}, torch.zeros((1, 8, 8, 3)), block1_impl="cudnn")


def test_kernel_impl_on_cpu_raises():
    x = torch.zeros((4, 4, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        B.block1(x, *_args(params_from_jax(_weights(0))), impl="kernel")


def test_three_steps_through_fused_block1_match_jax():
    """test_ten_steps_match_jax's run under the bf16 policy with the fused
    block1 on both sides (JAX's Pallas kernel in interpret mode, the port's
    plain version): block1 taps only, so every feature stays float32 and
    K3's bf16 rounding is the only one in the run. Per-step losses to
    rtol 1e-4."""
    rng = np.random.default_rng(42)
    content = rng.random((1, 48, 56, 3)).astype(np.float32)
    style = rng.random((1, 52, 44, 3)).astype(np.float32)
    kw = dict(levels=1, max_iter=3, log_every=3, sample_size=64,
              compute_dtype="bfloat16", use_pallas=False,
              block1_impl="pallas", taps=("block1_conv1", "block1_conv2"),
              seed=7)
    params = jax_random_params("16", 0)
    _, jinfo = jax_stylize_single(jnp.asarray(content), jnp.asarray(style),
                                  JaxConfig(**kw), params)
    img, tinfo = stylize_single(
        torch.tensor(content), torch.tensor(style),
        strotss_torch.StrotssConfig(**kw),
        params_from_jax(jax.tree.map(np.asarray, params)),
        coords_source=_jax_coords(7))
    want = np.asarray(jinfo["scales"][0]["curve"])
    got = tinfo["scales"][0]["curve"]
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tuple(img.shape) == (54, 64, 3) and img.dtype == torch.uint8


def _oihw(seed):
    return _args(params_from_jax(_weights(seed)))


def test_fwd_layouts_are_the_oihw_weights_rounded_and_permuted():
    k1, b1, k2, b2 = _oihw(5)
    k1l, b1l, k2l, b2l = B.fwd_layouts(k1, b1, k2, b2)
    assert k1l.dtype == k2l.dtype == torch.bfloat16
    assert tuple(k1l.shape) == (64, 32) and tuple(k2l.shape) == (3, 3, 64, 64)
    assert k1l.is_contiguous() and k2l.is_contiguous()
    k1n, k2n = k1.numpy(), k2.numpy()
    for co, ky, kx, ci in [(0, 0, 0, 0), (63, 2, 1, 2), (17, 1, 2, 0)]:
        want = torch.tensor(k1n[co, ci, ky, kx]).to(torch.bfloat16)
        assert k1l[co, (ky * 3 + kx) * 3 + ci] == want
    want1 = torch.cat([k1.permute(0, 2, 3, 1).reshape(64, 27),
                       torch.zeros(64, 5)], 1).to(torch.bfloat16)
    assert torch.equal(k1l.view(torch.int16), want1.view(torch.int16))
    want2 = k2.to(torch.bfloat16).permute(2, 3, 1, 0)
    assert torch.equal(k2l.view(torch.int16), want2.view(torch.int16))
    assert k2l[2, 0, 5, 60] == torch.tensor(k2n[60, 5, 2, 0]).to(
        torch.bfloat16)
    assert b1l.dtype == b2l.dtype == torch.float32
    assert torch.equal(b1l, b1) and torch.equal(b2l, b2)


def test_cached_fwd_layouts_returns_the_same_objects_for_the_same_weights(
        monkeypatch):
    builds = []
    real = B.fwd_layouts
    monkeypatch.setattr(B, "fwd_layouts",
                        lambda *a: builds.append(1) or real(*a))
    w = _oihw(6)
    first = B.cached_fwd_layouts(*w)
    again = B.cached_fwd_layouts(*w)
    assert builds == [1]
    assert all(a is b for a, b in zip(first, again))


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_cached_fwd_layouts_follow_a_new_tensor_or_an_inplace_edit(which):
    w = list(_oihw(7))
    first = B.cached_fwd_layouts(*w)
    # a new tensor with the same values: a new entry, equal layouts
    w[which] = w[which].clone()
    fresh = B.cached_fwd_layouts(*w)
    assert fresh[which] is not first[which]
    assert torch.equal(fresh[which].float(), first[which].float())
    # an in-place edit bumps _version: the layouts are rebuilt
    w[which].mul_(2)
    edited = B.cached_fwd_layouts(*w)
    assert edited[which] is not fresh[which]
    assert torch.equal(edited[which], B.fwd_layouts(*w)[which])
    assert torch.equal(edited[which].float(), 2 * fresh[which].float())


def test_bwd_layouts_are_the_oihw_weights_flipped_transposed_and_rounded():
    k1, _, k2, _ = _oihw(8)
    k2r, k1r = B.bwd_layouts(k1, k2)
    assert k2r.dtype == k1r.dtype == torch.bfloat16
    assert tuple(k2r.shape) == (3, 3, 64, 64)
    assert tuple(k1r.shape) == (3, 3, 64, 8)
    assert k2r.is_contiguous() and k1r.is_contiguous()
    want2 = k2.to(torch.bfloat16).flip(2, 3).permute(2, 3, 0, 1)
    assert torch.equal(k2r.view(torch.int16), want2.view(torch.int16))
    want1 = torch.cat([k1.to(torch.bfloat16).flip(2, 3).permute(2, 3, 0, 1),
                       torch.zeros(3, 3, 64, 5, dtype=torch.bfloat16)], 3)
    assert torch.equal(k1r.view(torch.int16), want1.view(torch.int16))
    k1n, k2n = k1.numpy(), k2.numpy()
    # entry [ty][tx][K][N] is the OIHW weight at the mirrored tap
    for ty, tx, co, ci in [(0, 0, 0, 0), (2, 1, 63, 5), (1, 2, 17, 40)]:
        assert k2r[ty, tx, co, ci] == torch.tensor(
            k2n[co, ci, 2 - ty, 2 - tx]).to(torch.bfloat16)
    for ty, tx, co, c in [(0, 0, 0, 0), (2, 1, 63, 2), (1, 2, 17, 1)]:
        assert k1r[ty, tx, co, c] == torch.tensor(
            k1n[co, c, 2 - ty, 2 - tx]).to(torch.bfloat16)
    assert not k1r[..., 3:].float().any()


def _tap_conv(inp, lay):
    """The 3x3 SAME convolution of inp (H, W, K) with lay (3, 3, K, N) as a
    direct sum over shifted taps: out[p] = sum_t inp[p + t - 1] @ lay[t]."""
    h, w, _ = inp.shape
    pad = torch.nn.functional.pad(inp, (0, 0, 1, 1, 1, 1))
    return sum(pad[ty:ty + h, tx:tx + w] @ lay[ty, tx]
               for ty in range(3) for tx in range(3))


@pytest.mark.parametrize("h,w", [(13, 11), (16, 8)])
def test_bwd_layouts_compute_the_backward(h, w):
    """K3b's arithmetic on its layouts, in float64: dy1 and dx as plain
    tap sums over [tap][K][N] reproduce block1_bwd_plain."""
    rng = np.random.default_rng(h * 10 + w)
    tap1, tap2, g1, g2 = (torch.tensor(rng.standard_normal((h, w, 64)))
                          for _ in range(4))
    k1, _, k2, _ = _oihw(h + w)
    k2r, k1r = (t.double() for t in B.bwd_layouts(k1, k2))

    def r(t):
        return t.to(torch.bfloat16).double()

    m1 = (tap1 > 0).double()
    dy1 = r(_tap_conv(r(g2 * (tap2 > 0)), k2r) * m1 + r(g1 * m1))
    dx = _tap_conv(dy1, k1r)
    assert not dx[..., 3:].any()
    want = B.block1_bwd_plain(tap1, tap2, g1, g2, k1.double(), k2.double())
    assert _rel_err(dx[..., :3], want) <= 1e-10


def test_cached_bwd_layouts_returns_the_same_objects_for_the_same_weights(
        monkeypatch):
    builds = []
    real = B.bwd_layouts
    monkeypatch.setattr(B, "bwd_layouts",
                        lambda *a: builds.append(1) or real(*a))
    k1, _, k2, _ = _oihw(9)
    first = B.cached_bwd_layouts(k1, k2)
    again = B.cached_bwd_layouts(k1, k2)
    assert builds == [1]
    assert all(a is b for a, b in zip(first, again))


@pytest.mark.parametrize("which", [0, 1])
def test_cached_bwd_layouts_follow_a_new_tensor_or_an_inplace_edit(which):
    k1, _, k2, _ = _oihw(10)
    w = [k1, k2]
    out = 1 - which  # k1's layout is k1r, the second of (k2r, k1r)
    first = B.cached_bwd_layouts(*w)
    # a new tensor with the same values: a new entry, equal layouts
    w[which] = w[which].clone()
    fresh = B.cached_bwd_layouts(*w)
    assert fresh[out] is not first[out]
    assert torch.equal(fresh[out].float(), first[out].float())
    # an in-place edit bumps _version: the layouts are rebuilt
    w[which].mul_(2)
    edited = B.cached_bwd_layouts(*w)
    assert edited[out] is not fresh[out]
    assert torch.equal(edited[out], B.bwd_layouts(*w)[out])
    assert torch.equal(edited[out].float(), 2 * fresh[out].float())
