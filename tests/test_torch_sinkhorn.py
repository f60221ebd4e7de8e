"""The port's Sinkhorn path against the JAX package.

Same inputs (seeded numpy) through both; JAX runs on the CPU, its Pallas
LSE kernel in interpret mode, and the port's wrapper runs the plain LSE on
CPU tensors. Tolerances: LSE passes to 1e-5 of max|out| and Sinkhorn
values to rtol 1e-5 (float32 sums in another order); gradients to 1e-4
of max|g| (the backward sums over N x M terms in another order, and the
unrolled one through 20 iterations). Kernel K4 itself runs only on a card
(``test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_step import _jax_coords

import strotss_torch
from strotss_torch import cli as tcli
from strotss_torch.models.weights import params_from_jax
from strotss_torch.ops import losses as TL
from strotss_torch.ops.kernels import sinkhorn as TS
from strotss_torch.solve import stylize_single
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops import losses as JL
from strotss_tpu.ops.kernels import sinkhorn as JS
from strotss_tpu.solve import stylize_single as jax_stylize_single


def _rand(seed, shape, positive=False):
    rng = np.random.default_rng(seed)
    a = rng.random(shape) if positive else rng.standard_normal(shape)
    return a.astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close_of_max(got, want, frac):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= frac * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


# --- one LSE pass (K4's function) ------------------------------------------

@pytest.mark.parametrize("n,m,c", [(96, 80, 24), (130, 70, 5)])
@pytest.mark.parametrize("dist", ["cosine", "l2", "both"])
def test_lse_pass_plain_matches_pallas(n, m, c, dist):
    """(130, 5) x (70, 5) is ragged past the Pallas kernel's 128 tile."""
    x, y = _rand(n + c, (n, c)), _rand(m + c + 1, (m, c))
    logv = 3.0 * _rand(m, (m,))
    want = JS.lse_pass(jnp.asarray(x), jnp.asarray(y), jnp.asarray(logv),
                       10.0, dist, interpret=True)
    got = TS.lse_pass_plain(_t(x), _t(y), _t(logv), 10.0, dist)
    _close_of_max(got.numpy(), want, 1e-5)


def test_lse_pass_on_cpu_is_the_plain_version():
    x, y, logv = _t(_rand(1, (40, 9))), _t(_rand(2, (30, 9))), _t(
        _rand(3, (30,)))
    before = TS.lse_pass.launches
    assert torch.equal(TS.lse_pass(x, y, logv, 10.0, "both"),
                       TS.lse_pass_plain(x, y, logv, 10.0, "both"))
    assert TS.lse_pass.launches == before
    with pytest.raises(ValueError, match="unknown distance"):
        TS.lse_pass(x, y, logv, 10.0, "cos")


# --- the materialized path: values and unrolled gradients -------------------

@pytest.mark.parametrize("dist", ["cosine", "both"])
def test_sinkhorn_plain_matches_jax(dist):
    """tests/test_kernels.py's shapes: (96, 24) x (80, 24), lam 10, 20
    iterations, through 'plain' and JAX's 'xla'."""
    x, y = _rand(11, (96, 24)), _rand(12, (80, 24))
    jv, jg = jax.value_and_grad(
        lambda a, b: JL.sinkhorn(a, b, dist, 10.0, 20, impl="xla"),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    tv = TL.sinkhorn(xt, yt, dist, 10.0, 20, impl="plain")
    tg = torch.autograd.grad(tv, [xt, yt])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for a, b in zip(tg, jg):
        _close_of_max(a.numpy(), b, 1e-4)


# --- the streamed path: values and the Danskin gradient ---------------------

@pytest.mark.parametrize("dist", ["cosine", "both"])
def test_sinkhorn_streamed_matches_jax(dist):
    x, y = _rand(21, (96, 24)), _rand(22, (80, 24))
    want = JS.sinkhorn_streamed(jnp.asarray(x), jnp.asarray(y), dist, 10.0,
                                20, True)
    got = TS.sinkhorn_streamed(_t(x), _t(y), dist, 10.0, 20)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # 'kernel' and 'auto' above the gate reach the same function
    np.testing.assert_allclose(
        float(TL.sinkhorn(_t(x), _t(y), dist, 10.0, 20, impl="kernel")),
        float(got), rtol=0)


def _frozen_plan_plain(x, y, lam, iters):
    """The materialized path with the whole plan held fixed in the
    read-out: the documented Danskin estimator (dL/dd = T)."""
    m = TL.cosine_distance(x, y)
    log_k = -lam * m
    n, mm = m.shape
    log_p = torch.full((n,), -float(np.log(n)))
    log_q = torch.full((mm,), -float(np.log(mm)))
    lu, lv = torch.zeros(n), torch.zeros(mm)
    with torch.no_grad():
        for _ in range(iters):
            lu = log_p - torch.logsumexp(log_k + lv[None, :], dim=1)
            lv = log_q - torch.logsumexp(log_k + lu[:, None], dim=0)
    t = torch.exp(lu[:, None] + log_k + lv[None, :]).detach()
    return torch.sum(t * m)


def test_sinkhorn_streamed_grad_matches_jax_vjp():
    """At tests/test_kernels.py:151-189's sizes (48 x 12, 40 x 12, lam 10,
    25 iterations): the port's Danskin VJP against JAX's custom VJP, and
    against the frozen-plan gradient of the port's own plain path."""
    x, y = _rand(31, (48, 12)), _rand(32, (40, 12))
    jg = jax.grad(lambda a, b: JS.sinkhorn_streamed(a, b, "cosine", 10.0, 25,
                                                    True),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    tg = torch.autograd.grad(
        TS.sinkhorn_streamed(xt, yt, "cosine", 10.0, 25), [xt, yt])
    xf, yf = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    fg = torch.autograd.grad(_frozen_plan_plain(xf, yf, 10.0, 25), [xf, yf])
    for a, b, f in zip(tg, jg, fg):
        _close_of_max(a.numpy(), b, 1e-4)
        _close_of_max(a.numpy(), f.numpy(), 1e-4)


def test_sinkhorn_streamed_grad_one_argument():
    """Only y needs a gradient (the style loss's prediction): the same dy,
    and no dx."""
    x, y = _t(_rand(41, (40, 7))), _t(_rand(42, (52, 7)))
    yt = y.clone().requires_grad_(True)
    (dy,) = torch.autograd.grad(TS.sinkhorn_streamed(x, yt, "both", 10.0, 5),
                                [yt])
    xb, yb = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    _, dy_both = torch.autograd.grad(
        TS.sinkhorn_streamed(xb, yb, "both", 10.0, 5), [xb, yb])
    assert torch.equal(dy, dy_both)


# --- the memory gate ----------------------------------------------------------

def test_sinkhorn_route_is_the_jax_memory_gate():
    assert TL.SINKHORN_STREAM_ABOVE == 2 ** 30
    assert TL.sinkhorn_route(2 ** 15, 2 ** 15) == "plain"
    assert TL.sinkhorn_route(5, (2 ** 30 + 1) // 5) == "kernel"
    assert TL.sinkhorn_route(2 ** 15, 2 ** 15 + 1) == "kernel"
    assert TL.sinkhorn_route(2 ** 20, 2 ** 20, "plain") == "plain"
    assert TL.sinkhorn_route(8, 8, "kernel") == "kernel"
    with pytest.raises(ValueError, match="impl must be"):
        TL.sinkhorn_route(8, 8, "xla")


def test_sinkhorn_and_style_loss_route_by_shape(monkeypatch):
    """Zero-stride views give N x M around 2^30 without the memory; the two
    implementations are replaced by recorders."""
    calls = []
    monkeypatch.setattr(TL, "_sinkhorn_plain",
                        lambda x, y, *a: calls.append("plain") or x.sum())
    monkeypatch.setattr(TS, "sinkhorn_streamed",
                        lambda x, y, *a: calls.append("kernel") or x.sum())

    def rows(n):
        return torch.ones(1, 3).expand(n, 3)

    TL.sinkhorn(rows(2 ** 15), rows(2 ** 15))
    TL.sinkhorn(rows(2 ** 15), rows(2 ** 15 + 1))
    assert calls == ["plain", "kernel"]
    calls.clear()
    for impl in ("auto", "plain"):
        TL.style_loss(rows(2 ** 15), rows(2 ** 15 + 1), 1.0,
                      use_sinkhorn=True, remd_impl=impl)
    assert calls == ["kernel", "kernel", "plain", "plain"]


# --- the style loss, a whole run, the CLI -------------------------------------

def test_style_loss_sinkhorn_matches_jax():
    t, p = _rand(51, (64, 35), positive=True), _rand(52, (64, 35), True)
    for alpha in (16.0, 0.5):
        def jf(pp):
            return JL.style_loss(jnp.asarray(t), pp, alpha, use_sinkhorn=True,
                                 remd_impl="xla")

        jv, jg = jax.value_and_grad(jf)(jnp.asarray(p))
        pt = _t(p).requires_grad_(True)
        tv = TL.style_loss(_t(t), pt, alpha, use_sinkhorn=True)
        (tg,) = torch.autograd.grad(tv, [pt])
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
        _close_of_max(tg.numpy(), jg, 1e-4)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_stylize_single_sinkhorn_matches_jax(use_pallas):
    """tests/test_solve_extras.py's Sinkhorn run (1 scale, 2 steps, 32
    samples, float32, block1_conv1, lam 20, 10 iterations) in both
    packages, from the same weights, images and sample coordinates."""
    rng = np.random.default_rng(5)
    content = rng.random((1, 40, 40, 3)).astype(np.float32)
    style = rng.random((1, 40, 40, 3)).astype(np.float32)
    kw = dict(levels=1, max_iter=2, log_every=2, sample_size=32,
              compute_dtype="float32", use_pallas=use_pallas,
              taps=("block1_conv1",), use_sinkhorn=True,
              sinkhorn_lambda=20.0, sinkhorn_iters=10, seed=3)
    params = jax_random_params("16", 0)
    _, jinfo = jax_stylize_single(jnp.asarray(content), jnp.asarray(style),
                                  JaxConfig(**kw), params)
    img, tinfo = stylize_single(
        torch.tensor(content), torch.tensor(style),
        strotss_torch.StrotssConfig(**kw),
        params_from_jax(jax.tree.map(np.asarray, params)),
        coords_source=_jax_coords(3))
    want = np.asarray(jinfo["scales"][0]["curve"])
    got = tinfo["scales"][0]["curve"]
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (64, 64, 3)


def test_cli_sinkhorn_runs_on_cpu(tmp_path):
    rng = np.random.default_rng(1)
    for name, shape in (("c.png", (40, 48, 3)), ("s.png", (36, 52, 3))):
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            tmp_path / name)
    out = tmp_path / "out.jpg"
    rc = tcli.main([str(tmp_path / "c.png"), str(tmp_path / "s.png"),
                    "-o", str(out), "--cpu", "--sinkhorn", "--level", "1",
                    "--max_iter", "2", "--taps", "block1_conv1",
                    "--compute_dtype", "float32", "--sample_size", "64",
                    "--max_size", "48"])
    assert rc == 0 and out.exists()
    assert Image.open(out).size == (64, 53)
