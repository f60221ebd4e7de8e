"""The port's sampling against the JAX package.

Gathers are fed the JAX package's coordinates and must return exactly the
same rows. The coordinate generators draw from a torch.Generator, which
cannot reproduce JAX's PRNG, so they are checked by their statistics:
count, validity, range, distinctness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strotss_torch.ops import sampling as TS
from strotss_tpu.ops import sampling as JS

_SHAPES = [(64, 48), (512, 384), (37, 53), (128, 85), (54, 64)]


@pytest.mark.parametrize("hw", _SHAPES)
def test_static_helpers_match_jax(hw):
    assert TS.strided_grid_params(*hw) == JS.strided_grid_params(*hw)
    h, w = hw
    chain = [(h, w), (h, w), (h // 2, w // 2), (h // 4, w // 4),
             (h // 8, w // 8), (h // 16, w // 16)]
    assert TS.coordinate_factors(chain) == JS.coordinate_factors(chain)


def _maps(seed):
    rng = np.random.default_rng(seed)
    shapes = [(37, 53, 3), (37, 53, 8), (18, 26, 16), (9, 13, 32)]
    return [rng.standard_normal((1,) + s).astype(np.float32) for s in shapes]


def test_gathers_equal_jax_exactly():
    maps = _maps(0)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    # fractional coords, including ones past the border (clipping)
    frac = jax.random.uniform(k1, (50, 2), minval=-1.5,
                              maxval=54.0).astype(jnp.float32)
    grid = JS.strided_grid_coords(k2, (37, 53), 64)
    for coords in (frac, grid):
        ct = torch.tensor(np.asarray(coords))
        for m in maps:
            np.testing.assert_array_equal(
                TS.bilinear_gather(torch.tensor(m), ct).numpy(),
                np.asarray(JS.bilinear_gather(jnp.asarray(m), coords)))
            np.testing.assert_array_equal(
                TS.nearest_gather(torch.tensor(m), ct).numpy(),
                np.asarray(JS.nearest_gather(jnp.asarray(m), coords)))


def test_hypercolumn_and_paired_equal_jax_exactly():
    xs, ys = _maps(1), _maps(2)
    key = jax.random.PRNGKey(5)
    coords = JS.strided_grid_coords(key, (37, 53), 64)
    ct = torch.tensor(np.asarray(coords))
    # the JAX one-hot-matmul gate forced shut: plain gathers on both sides
    want = JS.sample_hypercolumn([jnp.asarray(m) for m in xs], coords,
                                 matmul_px=0, integer_coords=True)
    c_t, p_t = TS.sample_paired(ct, [torch.tensor(m) for m in xs],
                                [torch.tensor(m) for m in ys])
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(want))
    assert tuple(p_t.shape) == (64, 3 + 8 + 16 + 32)
    s_coords = JS.full_grid_coords(key, (37, 53), 64)
    want_s = JS.sample_hypercolumn([jnp.asarray(m) for m in xs], s_coords,
                                   bilinear=False)
    got_s = TS.sample_style(torch.tensor(np.asarray(s_coords)),
                            [torch.tensor(m) for m in xs])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("hw,n", [((48, 56), 64), ((512, 384), 1024),
                                  ((20, 30), 100)])
def test_full_grid_coords_statistics(hw, n):
    gen = torch.Generator().manual_seed(0)
    c = TS.full_grid_coords(gen, hw, n, "cpu")
    assert c.dtype == torch.float32 and tuple(c.shape) == (n, 2)
    assert torch.equal(c, c.round())
    assert bool(((c[:, 0] >= 0) & (c[:, 0] < hw[0])).all())
    assert bool(((c[:, 1] >= 0) & (c[:, 1] < hw[1])).all())
    flat = (c[:, 0] * hw[1] + c[:, 1]).long()
    assert len(torch.unique(flat)) == n  # without replacement


@pytest.mark.parametrize("hw,n", [((512, 384), 1024), ((256, 192), 1024),
                                  ((54, 64), 64), ((30, 20), 1024)])
def test_strided_grid_coords_statistics(hw, n):
    h, w = hw
    step_x, step_y, nx, ny = TS.strided_grid_params(h, w)
    gen = torch.Generator().manual_seed(1)
    offsets = set()
    for _ in range(8):
        c = TS.strided_grid_coords(gen, hw, n, "cpu").long()
        assert tuple(c.shape) == (n, 2)
        assert bool(((c[:, 0] < h) & (c[:, 1] < w) & (c >= 0).all(1)).all())
        ox, oy = c[:, 0] % step_x, c[:, 1] % step_y
        assert len(torch.unique(ox)) == 1 and len(torch.unique(oy)) == 1
        offsets.add((int(ox[0]), int(oy[0])))
        flat = c[:, 0] * w + c[:, 1]
        n_valid = len(range(int(ox[0]), h, step_x)) * len(
            range(int(oy[0]), w, step_y))
        # distinct while the grid has enough points, topped up after that
        assert len(torch.unique(flat)) == min(n, n_valid)
    if step_x * step_y > 1:
        assert len(offsets) > 1  # the offset is drawn, not fixed
