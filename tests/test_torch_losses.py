"""The port's losses against the TF goldens and against the JAX package.

Same inputs (seeded numpy) through both; JAX runs on the CPU, its Pallas
kernels in interpret mode. Values agree to rtol 1e-5 and gradients to
1e-4 of max|g|: both sides compute in float32 with different summation
orders, a few ulps apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strotss_torch.ops import losses as TL
from strotss_tpu.ops import losses as JL
from strotss_tpu.ops.kernels.remd import relaxed_emd_pallas
from strotss_tpu.ops.kernels.selfsim import self_similarity_pallas


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rand(seed, shape, positive=False):
    rng = np.random.default_rng(seed)
    a = rng.random(shape) if positive else rng.standard_normal(shape)
    return a.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def full_float32_matmuls():
    """The goldens and tolerances below assume float32 matmuls in full
    float32, the state the port's main path sets
    (``programs.set_precision``: 'highest'). A process that left a
    reduced-precision mode behind ('medium' makes oneDNN round the
    operands to bf16: 1.1e-3 off the l2 golden) would fail them, so the
    module pins it and restores what it found."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.mkldnn.matmul.fp32_precision)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.mkldnn.matmul.fp32_precision = saved[1]


def _numerics() -> str:
    """The process's matmul state and the CPU's vector flags, for a
    failure's message."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln.split(":", 1)[1].split() for ln in f
                          if ln.startswith("flags")), [])
    except OSError:
        flags = []
    vec = sorted(x for x in flags if x.startswith(("avx", "amx", "fma")))
    return (f"float32 matmul precision "
            f"{torch.get_float32_matmul_precision()}, oneDNN fp32 "
            f"{torch.backends.mkldnn.matmul.fp32_precision}, threads "
            f"{torch.get_num_threads()}, CPU "
            f"{torch.backends.cpu.get_cpu_capability()} {' '.join(vec)}")


def _grad_close(g, ref, frac=1e-4):
    g, ref = np.asarray(g), np.asarray(ref)
    assert np.abs(g - ref).max() <= frac * np.abs(ref).max(), (
        np.abs(g - ref).max(), np.abs(ref).max())


# --- TF goldens, at tests/test_losses.py's tolerances ---------------------

@pytest.mark.parametrize("dist", ["cosine", "l2"])
def test_distance_golden(golden, dist):
    g = golden("losses")
    out = TL.dist_metrics[dist](_t(g["x"]), _t(g["y"]))
    np.testing.assert_allclose(out.numpy(), g[dist], atol=1e-5,
                               err_msg=_numerics())


@pytest.mark.parametrize("dist", ["cosine", "l2", "both"])
def test_remd_golden(golden, dist):
    g = golden("losses")
    out = TL.relaxed_emd(_t(g["x"]), _t(g["y"]), dist)
    np.testing.assert_allclose(float(out), float(g[f"remd_{dist}"]),
                               rtol=1e-5)


def test_selfsim_golden(golden):
    g = golden("losses")
    out = TL.self_similarity(_t(g["x"]), _t(g["z"]))
    np.testing.assert_allclose(float(out), float(g["selfsim"]), rtol=1e-4)


def test_moments_golden(golden):
    g = golden("losses")
    out = TL.moment_matching(_t(g["x"]), _t(g["y"]))
    np.testing.assert_allclose(float(out), float(g["moments"]), rtol=1e-4)


def test_moment_hoisting_identical():
    x, y = _t(_rand(1, (64, 17))), _t(_rand(2, (64, 17)))
    assert torch.equal(TL.moment_matching(x, y),
                       TL.moment_matching_from_stats(TL.moment_stats(x), y))
    assert torch.equal(
        TL.style_loss(x, y, 2.0),
        TL.style_loss(x, y, 2.0, target_moments=TL.moment_stats(x)))


# --- values and gradients against JAX ('xla' and interpreted 'pallas') ---

_REMD_CASES = [(100, 130, 35, "cosine"), (100, 130, 35, "l2"),
               (257, 80, 3, "both"), (96, 64, 3, "both")]


@pytest.mark.parametrize("n,m,c,dist", _REMD_CASES)
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_remd_matches_jax(n, m, c, dist, jax_impl):
    x = _rand(n + c, (n, c), positive=(c == 3))
    y = _rand(m + c + 1, (m, c), positive=(c == 3))

    def jf(a, b):
        if jax_impl == "pallas":
            return relaxed_emd_pallas(a, b, dist)
        return JL.relaxed_emd(a, b, dist, impl="xla")

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    tv = TL.relaxed_emd(xt, yt, dist, impl="plain")
    tg = torch.autograd.grad(tv, [xt, yt])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for a, b in zip(tg, jg):
        _grad_close(a.numpy(), b)


@pytest.mark.parametrize("n,c", [(96, 20), (130, 35), (64, 3)])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_selfsim_matches_jax(n, c, jax_impl):
    x, y = _rand(n, (n, c)), _rand(n + 1, (n, c))

    def jf(a, b):
        if jax_impl == "pallas":
            return self_similarity_pallas(a, b, True)
        return JL.self_similarity(a, b, impl="xla")

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    tv = TL.self_similarity(xt, yt, impl="plain")
    tg = torch.autograd.grad(tv, [xt, yt])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for a, b in zip(tg, jg):
        _grad_close(a.numpy(), b)


def test_style_and_content_loss_match_jax():
    t, p = _rand(5, (80, 35), positive=True), _rand(6, (80, 35), True)
    for alpha in (16.0, 0.5):
        jv = JL.style_loss(jnp.asarray(t), jnp.asarray(p), alpha)
        tv = TL.style_loss(_t(t), _t(p), alpha)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    jc = JL.content_loss(jnp.asarray(t), jnp.asarray(p), impl="xla")
    np.testing.assert_allclose(float(TL.content_loss(_t(t), _t(p))),
                               float(jc), rtol=1e-5)
