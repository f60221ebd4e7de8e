"""``cfg.shard_spatial`` in the port (``strotss_torch.parallel.spatial``):
the slab plan, the halo-exchanged convolutions and poolings, block1 on
extended slabs, the sampling across slabs, the contracts, and the JAX
anchor (the port's 2-rank run against the JAX package's unsharded run on
its own coordinates).

Ranks are processes of ``strotss_torch.parallel.launch`` over gloo, one
thread each; their functions live in ``tests/torch_ranks.py``, which
imports no JAX. One launch serves several cases. Limits: sampled rows
bit for bit the unsharded rows given the same maps; layers and
gradients within 1e-5 of their largest value in float32 (a convolution
on fewer rows may take another algorithm and sum in another order); the
JAX anchor at the JAX test's limits (``tests/test_parallel.py:295-336``:
rtol 2e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import strotss_torch
import torch_ranks as R
from strotss_torch.models.vgg import STROTSS_DEFAULT_TAPS, VGG
from strotss_torch.models.weights import params_from_jax, random_params
from strotss_torch.ops.kernels import block1 as K3
from strotss_torch.ops.sampling import sample_hypercolumn
from strotss_torch.parallel import launch as L
from strotss_torch.parallel.spatial import depth_of, slab_bounds
from strotss_torch.parallel import stylize_batch
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops import sampling as JS
from strotss_tpu.solve import stylize_single as jax_stylize_single

TIMEOUT = 180


def _launch(fn, n, *args):
    return L.launch(fn, ["cpu"] * n, args=args, timeout=TIMEOUT, threads=1)


def _close(got, want, frac):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


# --- (1) the slab plan -----------------------------------------------------

@pytest.mark.parametrize("parts", range(1, 9))
def test_slab_plan(parts):
    for depth in (0, 1, 4):
        unit = 1 << depth
        for height in range(1, 81):
            bounds = slab_bounds(height, parts, depth)
            assert len(bounds) == parts
            # contiguous and covering
            assert bounds[0][0] == 0 and bounds[-1][1] == height
            assert all(bounds[r][1] == bounds[r + 1][0]
                       for r in range(parts - 1))
            sizes = [e - s for s, e in bounds]
            # boundaries on multiples of the unit (or the image's end)
            assert all(s % unit == 0 or s == height for s, _ in bounds)
            # the units balanced as tensor_split balances them
            units = -(-height // unit)
            want = [len(t) for t in torch.arange(units).tensor_split(parts)]
            assert [-(-n // unit) for n in sizes] == want
            # empty slabs last
            full = [n > 0 for n in sizes]
            assert full == sorted(full, reverse=True)
            # every level's rows add up to the pooled height, and the
            # ranks with rows at a level are the first ones
            for level in range(depth + 1):
                rows = [(e >> level) - (s >> level) for s, e in bounds]
                assert sum(rows) == height >> level
                has = [n > 0 for n in rows]
                assert has == sorted(has, reverse=True)


def test_slab_plan_examples():
    assert slab_bounds(48, 4, 4) == [(0, 16), (16, 32), (32, 48), (48, 48)]
    assert slab_bounds(43, 3, 4) == [(0, 16), (16, 32), (32, 43)]
    assert [(e >> 4) - (s >> 4) for s, e in slab_bounds(43, 3, 4)] == [
        1, 1, 0]
    assert slab_bounds(5, 2, 0) == [(0, 3), (3, 5)]
    assert depth_of(STROTSS_DEFAULT_TAPS) == 4
    assert depth_of(("block1_conv1",)) == 0
    assert depth_of(("block1_conv2", "block3_conv1")) == 2


# --- (2) halo convolutions and pooling ---------------------------------------

def _conv_cases(seed):
    """(x, kernel, cotangent, height, depth, level, pool): the full-size
    map of a 40-row image, and maps after 3 and 4 poolings of a 43-row
    image (16/16/11 rows on 3 ranks: 2/2/1 rows after three poolings, 1/1/0
    after four, a rank without rows); with ``depth`` 0, 9 rows split row by
    row (no pooling there)."""
    rng = np.random.default_rng(seed)
    cases = []
    for height, depth, level, pool in ((40, 4, 0, True), (43, 4, 3, True),
                                       (43, 4, 4, False), (9, 0, 0, False)):
        rows = height >> level
        x = rng.standard_normal((1, 6, rows, 7)).astype(np.float32)
        k = rng.standard_normal((5, 6, 3, 3)).astype(np.float32)
        cot = rng.standard_normal(
            (1, 5, rows // 2 if pool else rows, 3 if pool else 7)).astype(
            np.float32)
        cases.append((x, k, cot, height, depth, level, pool))
    return cases


@pytest.fixture(scope="module")
def conv_runs():
    cache = {}

    def runs(p):
        if p not in cache:
            cases = _conv_cases(p)
            cache[p] = cases, _launch(R.spatial_conv, p, cases)
        return cache[p]
    return runs


@pytest.mark.parametrize("p", [2, 3, 4])
def test_halo_conv_and_pool_match_whole_image(conv_runs, p):
    cases, ranks = conv_runs(p)
    for k, (x, kern, cot, _, _, _, pool) in enumerate(cases):
        xt = torch.tensor(x, requires_grad=True)
        y = F.conv2d(xt, torch.tensor(kern), padding=1)
        z = F.max_pool2d(y, 2, 2) if pool else y
        g, = torch.autograd.grad((z * torch.tensor(cot)).sum(), xt)
        got_y, got_z, got_g = (np.concatenate([r[k][i] for r in ranks],
                                              axis=2) for i in range(3))
        assert [r[k][3][1] - r[k][3][0] for r in ranks] == [
            r[k][0].shape[2] for r in ranks]
        _close(got_y, y.detach().numpy(), 1e-6)
        _close(got_z, z.detach().numpy(), 1e-6)
        _close(got_g, g.numpy(), 1e-6)
    # after four poolings of 43 rows on 3 or 4 ranks a rank has no rows
    if p >= 3:
        assert min(r[2][3][1] - r[2][3][0] for r in ranks) == 0


def _vgg_cases(seed, params):
    """(image, tap cotangents, taps, dtype, block1 route): the 9 taps in
    float32 at 43 and 40 rows, and the fused block1's plain version under
    the bf16 policy."""
    rng = np.random.default_rng(seed)
    cases = []
    for h, w, dtype, b1 in ((43, 64, "float32", "xla"),
                            (40, 36, "float32", "xla"),
                            (37, 30, "bfloat16", "plain")):
        img = rng.random((1, h, w, 3)).astype(np.float32)
        vgg = VGG(params, taps=STROTSS_DEFAULT_TAPS, compute_dtype=dtype,
                  block1_impl=b1)
        taps = vgg(torch.tensor(img))
        cots = [rng.standard_normal(t.shape).astype(np.float32)
                for t in taps]
        cases.append((img, cots, STROTSS_DEFAULT_TAPS, dtype, b1))
    return cases


@pytest.fixture(scope="module")
def vgg_runs():
    params = random_params("16", seed=0)
    cache = {}

    def runs(p):
        if p not in cache:
            cases = _vgg_cases(10 + p, params)
            cache[p] = cases, _launch(R.spatial_vgg, p, cases)
        return cache[p], params
    return runs


@pytest.mark.parametrize("p", [2, 3, 4])
def test_vgg_on_slabs_matches_whole_image(vgg_runs, p):
    """Every tap (rows gathered over the ranks) and the image gradient,
    forward and backward through block1 on extended slabs and the halo
    convolutions and poolings of blocks 2-5."""
    (cases, ranks), params = vgg_runs(p)
    for k, (img, cots, taps, dtype, b1) in enumerate(cases):
        vgg = VGG(params, taps=taps, compute_dtype=dtype, block1_impl=b1)
        x = torch.tensor(img, requires_grad=True)
        want = vgg(x)
        loss = sum((t.float() * torch.tensor(c)).sum()
                   for t, c in zip(want, cots))
        g, = torch.autograd.grad(loss, x)
        # float32: 1e-5; bf16 blocks 2-5: a few bf16 roundings apart
        frac = 1e-5 if dtype == "float32" else 2e-2
        for i, t in enumerate(want):
            got = np.concatenate([r[k][0][i] for r in ranks], axis=1)
            _close(got, t.detach().float().numpy(), frac)
        for r in ranks:
            _close(r[k][1], g.numpy(), frac)
            # every rank holds the same whole gradient, bit for bit
            assert np.array_equal(r[k][1], ranks[0][k][1])
        assert ranks[0][k][2] == slab_bounds(img.shape[1], p, 4)


# --- (3) block1 on extended slabs --------------------------------------------

def _block1_cases(seed):
    """(x, k1, b1, k2, b2, g1, g2) at 40x24, 43x17, 48x20 and 9x11 with
    dense cotangents on both taps."""
    rng = np.random.default_rng(seed)
    cases = []
    for h, w in ((40, 24), (43, 17), (48, 20), (9, 11)):
        f = lambda *shape, s=1.0: (  # noqa: E731
            rng.standard_normal(shape) * s).astype(np.float32)
        cases.append((f(1, h, w, 3), f(64, 3, 3, 3, s=0.3), f(64, s=0.1),
                      f(64, 64, 3, 3, s=0.05), f(64, s=0.1), f(1, h, w, 64),
                      f(1, h, w, 64)))
    return cases


@pytest.mark.parametrize("p", [2, 3, 4])
def test_fused_block1_on_extended_slabs(p):
    """K3's plain version on each rank's rows with 4 extra a side
    (``Slab.fused_block1``, split row by row): the taps on its rows are
    the whole image's, and the image gradient, each rank's dx on its own
    rows from the whole image's cotangents, summed by the slice's
    all-reduce, is the whole image's. Limits: tap1 1e-5 of max, tap2 and
    dx 1e-3 (block1's bf16 limits: a sum in another order can cross a
    bf16 rounding boundary); in practice the convolutions' sums agree."""
    cases = _block1_cases(p)
    ranks = _launch(R.spatial_block1, p, cases)
    for k, (x, k1, b1, k2, b2, g1, g2) in enumerate(cases):
        t = [torch.tensor(a) for a in (x, k1, b1, k2, b2, g1, g2)]
        t1, t2 = K3.block1_plain(*t[:5])
        dx = K3.block1_bwd_plain(t1, t2, t[5], t[6], t[1], t[3])
        _close(np.concatenate([r[k][0] for r in ranks], 1), t1.numpy(), 1e-5)
        _close(np.concatenate([r[k][1] for r in ranks], 1), t2.numpy(), 1e-3)
        for r in ranks:
            _close(r[k][2], dx.numpy(), 1e-3)
            assert np.array_equal(r[k][2], ranks[0][k][2])


# --- (4) sampling across slabs ---------------------------------------------

_LEVELS = [0, 0, 1, 1, 2, 2, 2, 3, 4]


def _sampling_inputs(h, w, seed):
    """The image, one map a tap level of VGG16's default taps (5 channels),
    and per case (coords, bilinear, integer_coords, cotangent):
    coordinates on every slab boundary row (16, 32, 48 of each level's
    grid and the row before), past the borders, fractional ones, and a
    strided grid."""
    rng = np.random.default_rng(seed)
    image = rng.random((1, h, w, 3)).astype(np.float32)
    maps = [rng.standard_normal((1, h >> j, w >> j, 5)).astype(np.float32)
            for j in _LEVELS]
    rows = np.array([r for b in (16, 32, 48, 64) for r in (b - 1, b)
                     if r < h] + [0, h - 1, -3, h + 2], np.float32)
    cols = rng.integers(-2, w + 2, rows.size).astype(np.float32)
    edge = np.stack([rows, cols], 1)
    frac = np.stack([rng.uniform(-2, h + 1, 300),
                     rng.uniform(-2, w + 1, 300)], 1).astype(np.float32)
    grid = JS.strided_grid_coords(jax.random.PRNGKey(seed), (h, w), 200)
    cases = []
    for coords, integer in ((edge, False), (frac, False),
                            (np.asarray(grid), True),
                            (np.floor(np.clip(frac, 0, None)), True)):
        for bilinear in (True, False):
            cot = rng.standard_normal((coords.shape[0], 3 + 5 * 9)).astype(
                np.float32)
            cases.append((coords, bilinear, integer, cot))
    return image, maps, cases


@pytest.fixture(scope="module", params=[(2, 64, 40), (3, 43, 36),
                                        (4, 80, 52)])
def sampling_runs(request):
    p, h, w = request.param
    image, maps, cases = _sampling_inputs(h, w, p)
    return image, maps, cases, _launch(R.spatial_sampling, p, image, maps,
                                       _LEVELS, cases)


def test_sampling_across_slabs_is_bit_for_bit(sampling_runs):
    image, maps, cases, ranks = sampling_runs
    feats = [torch.tensor(image)] + [torch.tensor(m) for m in maps]
    for k, (coords, bilinear, integer, _) in enumerate(cases):
        want = sample_hypercolumn(feats, torch.tensor(coords), bilinear,
                                  integer).numpy()
        for r in ranks:
            assert np.array_equal(r[k][0], want), (k, bilinear, integer)


def test_sampling_across_slabs_map_gradients(sampling_runs):
    """The gradients with respect to each rank's rows of the maps, put
    together, are the unsharded gradients: the halo row's gradient reaches
    its owner, and the replicated rows' cotangent is not scaled by p."""
    image, maps, cases, ranks = sampling_runs
    for k, (coords, bilinear, integer, cot) in enumerate(cases):
        feats = [torch.tensor(m, requires_grad=True) for m in maps]
        rows = sample_hypercolumn([torch.tensor(image)] + feats,
                                  torch.tensor(coords), bilinear, integer)
        want = torch.autograd.grad((rows * torch.tensor(cot)).sum(), feats)
        for i, g in enumerate(want):
            got = np.concatenate([r[k][1][i] for r in ranks], axis=1)
            np.testing.assert_allclose(got, g.numpy(), rtol=0, atol=1e-5)


# --- (5) contracts ---------------------------------------------------------

class _Mesh:
    """What the contracts read of a mesh: its axes' names."""

    device_type = "cpu"

    def __init__(self, names):
        self.mesh_dim_names = names

    def get_rank(self):
        return 0


_SPATIAL_ERROR = ("cfg.shard_spatial needs a mesh with a 'spatial' axis — "
                  "pass stylize(..., mesh=make_mesh((N,), ('spatial',)))")


@pytest.mark.parametrize("mesh", [None, _Mesh(("sample",)),
                                  _Mesh(("data",))])
def test_spatial_contract_gives_the_jax_message(mesh):
    img = np.zeros((1, 16, 16, 3), np.float32)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=1,
                                      shard_spatial=True, **R.TINY)
    with pytest.raises(ValueError) as got:
        strotss_torch.stylize(img, img, cfg, device="cpu", mesh=mesh)
    assert str(got.value) == _SPATIAL_ERROR
    # the JAX package's own text
    with pytest.raises(ValueError) as want:
        jax_stylize_single(jnp.asarray(img), jnp.asarray(img), JaxConfig(
            levels=1, max_iter=1, shard_spatial=True, **R.TINY),
            jax_random_params("16", 0))
    assert str(want.value) == _SPATIAL_ERROR


def test_batch_refuses_spatial_as_single_pair_only():
    imgs = np.zeros((2, 16, 16, 3), np.float32)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=1,
                                      shard_spatial=True, **R.TINY)
    with pytest.raises(ValueError, match="single-pair"):
        stylize_batch(imgs, imgs, cfg, device="cpu")


# --- (6) the JAX anchor ----------------------------------------------------

def _jax_table(seed, hw, n, steps):
    """The JAX package's coordinates of a one-scale run
    (``tests/test_torch_step.py``'s key splits), as a table."""
    key = jax.random.PRNGKey(seed)
    _, k_style, k_run = jax.random.split(jax.random.fold_in(key, 0), 3)
    table = {(0, "style", -1): np.asarray(JS.full_grid_coords(k_style, hw,
                                                              n))}
    for step in range(steps):
        k_run, k_step = jax.random.split(k_run)
        table[(0, "paired", step)] = np.asarray(
            JS.strided_grid_coords(k_step, hw, n))
    return table


def test_two_rank_spatial_run_matches_jax():
    """The port's 2-rank ``shard_spatial`` run against the JAX package's
    ``stylize_single`` at the setting of ``tests/test_parallel.py:295-336``
    (40x40, ``taps=("block1_conv1",)``, float32, 3 steps, 32 samples), on
    the JAX package's coordinates; the JAX side runs unsharded on one CPU
    device."""
    rng = np.random.default_rng(0)
    content = rng.random((1, 40, 40, 3)).astype(np.float32)
    style = rng.random((1, 40, 40, 3)).astype(np.float32)
    kw = dict(levels=1, max_iter=3, log_every=3, seed=3, **R.TINY)
    jparams = jax_random_params("16", 0)
    _, jinfo = jax_stylize_single(jnp.asarray(content), jnp.asarray(style),
                                  JaxConfig(**kw), jparams)
    table = _jax_table(3, (64, 64), 32, 3)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    ranks = _launch(R.spatial_runs, 2, content, style,
                    [(kw, {"coords_source": R.Table(table)})], None,
                    ("spatial",), params)
    want = np.asarray(jinfo["scales"][0]["curve"])
    for r in ranks:
        curve = r[0][0][0]
        assert curve.shape == want.shape == (3, 3)
        np.testing.assert_allclose(curve, want, rtol=2e-4, atol=1e-5)
    assert ranks[0][0][3] == ranks[1][0][3]
