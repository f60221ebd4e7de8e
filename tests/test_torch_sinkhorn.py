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
from strotss_torch.utils import timing
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
    before = timing.counters()
    assert torch.equal(TS.lse_pass(x, y, logv, 10.0, "both"),
                       TS.lse_pass_plain(x, y, logv, 10.0, "both"))
    assert timing.counters() == before
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


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("shard_samples", [False, True])
@pytest.mark.parametrize("shard_spatial", [False, True])
def test_sinkhorn_route_of_every_path_is_the_jax_one(
        use_pallas, masked, batched, shard_samples, shard_spatial):
    """Above the gate (N = M = 32769) a Sinkhorn run streams exactly where
    the JAX package's ``spec_from_config`` leaves ``remd_impl='auto'``
    and takes the materialized solve where it pins ``'xla'``: masked,
    batched, sample-sharded and spatially sharded runs, and
    ``use_pallas=False``."""
    from strotss_torch.programs import spec_from_config
    from strotss_tpu.programs import spec_from_config as jax_spec

    kw = dict(use_pallas=use_pallas, use_sinkhorn=True, sample_size=32769,
              shard_samples=shard_samples, shard_spatial=shard_spatial)
    want = jax_spec(JaxConfig(**kw), masked=masked,
                    batched=batched).remd_impl
    assert want in ("auto", "xla")
    spec = spec_from_config(strotss_torch.StrotssConfig(**kw), "cpu",
                            masked=masked, batched=batched)
    n = spec.sample_size
    assert TL.sinkhorn_route(n, n, spec.remd_impl) == (
        "kernel" if want == "auto" else "plain")


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


# --- K4's layout, arithmetic and order of work (its kernel runs on a card) ---

def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _k4_dot(px, py, n, m, c):
    """The dot products K4 forms. Tensor-core route: the three TF32
    products of each period of stages exact (float64), rounded to float32,
    and the periods added in float32 (csrc/sinkhorn.cu: SK_PERIOD stages
    of 16 channels); CUDA-core route: float32 products."""
    if c < TS.TC_MIN_C:
        return px.parts[:n] @ py.parts[:m].T
    xb, xsm = px.parts[0, :n].double(), px.parts[1, :n].double()
    yb, ysm = py.parts[0, :m].double(), py.parts[1, :m].double()
    cp = px.parts.shape[2]
    width = 16 * TS.TC_PERIOD
    dot = torch.zeros((n, m), dtype=torch.float32)
    for k0 in range(0, cp, width):
        s = slice(k0, k0 + width)
        dot = dot + (xb[:, s] @ ysm[:, s].T + xsm[:, s] @ yb[:, s].T
                     + xb[:, s] @ yb[:, s].T).float()
    return dot


def _k4_z(dot, px, py, n, m, c, logv, lam, dist):
    """z = -lam d + logv_j with the kernel's formulas (``sk_dist``)."""
    xs, rx = px.norms[0, :n, None], px.norms[1, :n, None]
    ys, ry = py.norms[0, None, :m], py.norms[1, None, :m]
    d = torch.zeros_like(dot)
    if dist != "l2":
        d = 1.0 - (dot * rx) * ry
    if dist != "cosine":
        inv_c = _f32(1.0) / c
        d = d + torch.sqrt(torch.clamp(xs + ys - 2.0 * dot, min=1e-6) * inv_c)
    return -lam * d + logv[None, :]


def _merge(a, b):
    nm = torch.maximum(a[0], b[0])
    return nm, a[1] * torch.exp(a[0] - nm) + b[1] * torch.exp(b[0] - nm)


def _k4_model(x, y, logv, lam, dist, split):
    """K4's order of work in torch on the CPU: the prepared operands, the
    products (:func:`_k4_dot`), then per chunk of column tiles the running
    (max, sum) of each thread (tensor cores: the lane quad's four threads
    own the columns 8j + 2t + e of a tile, folded tile by tile, then
    merged t ^ 1, t ^ 2; CUDA cores: one thread a row, the max raised
    column by column, each tile summed apart), and the chunks combined in
    order."""
    n, c = x.shape
    m = y.shape[0]
    px, py = TS.prepare_plain(x), TS.prepare_plain(y)
    z = _k4_z(_k4_dot(px, py, n, m, c), px, py, n, m, c, logv, lam, dist)
    neg = torch.full((n,), -3.4e38)
    zero = torch.zeros(n)
    _, bn = TS.tile_shape(c)
    tiles = -(-m // bn)
    parts = []
    for q in range(split):
        cols_of = [range(t * bn, min(m, (t + 1) * bn))
                   for t in TS.chunk_tiles(q, tiles, split)]
        if c >= TS.TC_MIN_C:
            runs = []
            for t4 in range(4):
                mx, sm = neg.clone(), zero.clone()
                for cols in cols_of:
                    mine = [j for j in cols if (j - cols[0]) % 8 // 2 == t4]
                    if not mine:
                        continue
                    nm = torch.maximum(mx, z[:, mine].max(dim=1).values)
                    s = zero.clone()
                    for j in mine:
                        s = s + torch.exp(z[:, j] - nm)
                    sm, mx = sm * torch.exp(mx - nm) + s, nm
                runs.append((mx, sm))
            pair = [_merge(runs[0], runs[1]), _merge(runs[2], runs[3])]
            parts.append(_merge(*pair))
        else:
            mx, sm = neg.clone(), zero.clone()
            for cols in cols_of:
                loc = zero.clone()
                for j in cols:
                    up = z[:, j] > mx
                    sc = torch.where(up, torch.exp(mx - z[:, j]), _f32(1.0))
                    sm, loc = sm * sc, loc * sc
                    mx = torch.where(up, z[:, j], mx)
                    loc = loc + torch.exp(z[:, j] - mx)
                sm = sm + loc
            parts.append((mx, sm))
    big = torch.stack([p[0] for p in parts]).max(dim=0).values
    total = zero.clone()
    for mx, sm in parts:
        total = total + sm * torch.exp(mx - big)
    return torch.log(torch.clamp(total, min=1e-38)) + big


@pytest.mark.parametrize("dist", ["cosine", "l2", "both"])
@pytest.mark.parametrize("n,m,c,split", [
    (129, 300, 40, 2),   # tensor cores: a last strip of one row, a
    (129, 300, 40, 1),   # partial last tile; one chunk or two
    (130, 70, 35, 1),    # C = 35, just above the route threshold
    (1025, 300, 3, 2),   # CUDA cores: a last strip of one row
])
def test_k4_model_matches_pallas(n, m, c, split, dist):
    """K4's order of work (:func:`_k4_model`) against the JAX package's
    Pallas kernel in interpret mode, to 1e-5 of max|out|."""
    x, y = _rand(n + c, (n, c)), _rand(m + c + 1, (m, c))
    logv = 5.0 * _rand(m, (m,))
    want = JS.lse_pass(jnp.asarray(x), jnp.asarray(y), jnp.asarray(logv),
                       10.0, dist, interpret=True)
    got = _k4_model(_t(x), _t(y), _t(logv), 10.0, dist, split)
    _close_of_max(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("c", [3, 35, 2179])
def test_k4_prepared_layout(c):
    """Rows padded to ROW_PAD and channels to prep_channels(C) with zeros;
    on the tensor-core route the big and small TF32 parts (low 13 bits 0)
    give back each value to 2^-22 of it; the norms and their floored
    inverse square roots."""
    n = 300
    x = _t(_rand(c, (n, c), positive=c == 3))
    p = TS.prepare_plain(x)
    rows, cp = TS.ROW_PAD * -(-n // TS.ROW_PAD), TS.prep_channels(c)
    sq = (x.double() ** 2).sum(1)
    np.testing.assert_allclose(p.norms[0, :n].numpy(), sq.numpy(), rtol=1e-5)
    np.testing.assert_allclose(p.norms[1, :n].numpy(),
                               (1.0 / sq.sqrt()).numpy(), rtol=1e-5)
    assert (p.n, p.c) == (n, c) and tuple(p.norms.shape) == (2, rows)
    floor = 1.0 / torch.sqrt(_f32(1e-12))
    assert not p.norms[0, n:].any() and p.norms[1, n:].eq(floor).all()
    if c < TS.TC_MIN_C:
        assert tuple(p.parts.shape) == (rows, cp) and cp == -(-c // 4) * 4
        assert torch.equal(p.parts[:n, :c], x)
        assert not p.parts[n:].any() and not p.parts[:, c:].any()
        return
    assert tuple(p.parts.shape) == (2, rows, cp) and cp % 32 == 0
    big, small = p.parts[0].double(), p.parts[1].double()
    for part in p.parts:
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (big[:n, :c] + small[:n, :c] - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert not p.parts[:, n:].any() and not p.parts[:, :, c:].any()


def test_k4_route_is_chosen_by_c():
    assert TS.TC_MIN_C == 32
    assert [TS.route(c) for c in (3, 31, 32, 35, 2179)] == [
        "cuda_cores", "cuda_cores", "tensor_cores", "tensor_cores",
        "tensor_cores"]
    assert [TS.prep_channels(c) for c in (3, 31, 32, 35, 2179)] == [
        4, 32, 32, 64, 2208]
    assert TS.tile_shape(3) == (1024, 256)
    assert TS.tile_shape(2179) == (128, 192)


@pytest.mark.parametrize("n,m,c,sms", [
    (32769, 32769, 2179, 132), (32769, 32769, 3, 132),
    (4099, 3001, 2179, 132), (4096, 4096, 2179, 132), (129, 300, 40, 132),
    (1025, 300, 3, 8), (32769, 32769, 2179, 114)])
def test_k4_split_covers_every_pair_once(n, m, c, sms):
    """Items (strip, chunk) cover each (row, column) pair exactly once:
    the strips partition the rows, the chunks of a strip its column
    tiles."""
    bm, bn = TS.tile_shape(c)
    split = TS.lse_split(n, m, c, sms)
    tiles = -(-m // bn)
    assert 1 <= split <= min(tiles, TS.MAX_SPLIT)
    cols = np.zeros(m, np.int64)
    for q in range(split):
        chunk = TS.chunk_tiles(q, tiles, split)
        assert len(chunk) >= 1
        for t in chunk:
            cols[t * bn:(t + 1) * bn] += 1
    rows = np.zeros(n, np.int64)
    for strip in range(-(-n // bm)):
        rows[strip * bm:(strip + 1) * bm] += 1
    assert (cols == 1).all() and (rows == 1).all()


def test_k4_split_rule_at_the_path_shapes():
    """On an H100 (132 SMs): at 32769 samples S = 1, 3 and 9 tie (342 tile
    times on the busiest SM) and 1 leaves the fewest slots idle (7 of 132
    in its second round); 4 at 4099 x 3001 (4, 8 and 16 fill the card in
    4 tile times; the smallest); 16 on the YUV term's CUDA-core route (15
    ties in tile times but leaves 33 slots idle; chunks of unequal length
    cost nothing more there). On 114 SMs (an H100 PCIe) 3 and 9 tie at
    32769 samples and 3 leaves fewer idle; on 144, 5 would take the
    fewest tile times (315) but its chunks differ in length, so 9 (323).
    PERF.md holds the measured splits."""
    assert TS.lse_split(32769, 32769, 2179, 132) == 1
    assert TS.lse_split(32769, 32769, 3, 132) == 16
    assert TS.lse_split(4099, 3001, 2179, 132) == 4
    assert TS.lse_split(32769, 32769, 2179, 114) == 3
    assert TS.lse_split(32769, 32769, 2179, 144) == 9


@pytest.mark.parametrize("m", [32769, 32256])
@pytest.mark.parametrize("sms", [114, 132, 144, 160])
def test_k4_split_prefers_equal_chunks_on_tensor_cores(m, sms):
    """At 32769 rows the tensor-core route takes a split whose chunks all
    hold the same number of column tiles (171 or 168 tiles); an unequal
    split would have to cost 30% fewer tile times to be taken."""
    tiles = -(-m // TS.TC_BN)
    split = TS.lse_split(32769, m, 2179, sms)
    assert tiles % split == 0
    assert len({len(TS.chunk_tiles(q, tiles, split))
                for q in range(split)}) == 1


def test_k4_streamed_solve_prepares_once_on_cpu():
    """On the CPU the solve prepares nothing and launches nothing."""
    before = timing.counters()
    x, y = _t(_rand(61, (40, 35))), _t(_rand(62, (30, 35)))
    assert TS.prepare(x, y) is None
    TS.sinkhorn_streamed(x, y, "cosine", 10.0, 3)
    assert timing.counters() == before
