"""The port's optimizer, step and scale driver against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch.models.weights import params_from_jax, random_params
from strotss_torch.programs import RMSprop
from strotss_torch.solve import scale_mode_shapes, stylize_single
from strotss_tpu.aot import scale_mode_shapes as jax_scale_mode_shapes
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops import sampling as JS
from strotss_tpu.solve import stylize_single as jax_stylize_single


def test_rmsprop_matches_keras_golden(golden):
    g = golden("rmsprop")
    var = torch.tensor(g["init"])
    opt = RMSprop([var], 2e-3)
    for i, grad in enumerate(g["grads"]):
        opt.step([torch.tensor(grad)])
        np.testing.assert_allclose(var.numpy(), g["traj"][i], atol=1e-6,
                                   err_msg=f"diverged at step {i}")


@pytest.mark.parametrize("levels", [2, 4])
def test_scale_mode_shapes_match_jax(levels):
    cfg_t = strotss_torch.StrotssConfig(levels=levels)
    cfg_j = JaxConfig(levels=levels)
    for i, scl in enumerate(cfg_t.scale_sizes()):
        assert scale_mode_shapes(cfg_t, (1, 480, 640, 3), (1, 720, 560, 3),
                                 i, scl) == jax_scale_mode_shapes(
            cfg_j, (1, 480, 640, 3), (1, 720, 560, 3), i, scl, False)


def _jax_coords(seed):
    """Rebuild the JAX package's sample coordinates from its key splits
    (``solve.py:345`` per scale, ``programs.py:529`` per step)."""
    cache = {}

    def coords(i, kind, step, hw, n):
        if (i, kind, step) not in cache:
            key = jax.random.PRNGKey(seed)
            _, k_style, k_run = jax.random.split(jax.random.fold_in(key, i), 3)
            if kind == "style":
                c = JS.full_grid_coords(k_style, hw, n)
            else:
                for _ in range(step + 1):
                    k_run, k_step = jax.random.split(k_run)
                c = JS.strided_grid_coords(k_step, hw, n)
            cache[(i, kind, step)] = torch.tensor(np.asarray(c))
        return cache[(i, kind, step)]

    return coords


def test_ten_steps_match_jax():
    """tests/test_e2e_golden.py's run: both packages from the same weights,
    images and sample coordinates; per-step losses to rtol 1e-4."""
    rng = np.random.default_rng(42)
    content = rng.random((1, 48, 56, 3)).astype(np.float32)
    style = rng.random((1, 52, 44, 3)).astype(np.float32)
    kw = dict(levels=1, max_iter=10, log_every=10, sample_size=64,
              compute_dtype="float32", use_pallas=False,
              taps=("block1_conv1",), seed=7)
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
    assert got.shape == want.shape == (10, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tuple(img.shape) == (54, 64, 3) and img.dtype == torch.uint8


def test_full_width_step_on_cpu():
    """The main path's widths (VGG16, 9 taps, 2179 channels, 1024 samples,
    bf16 policy) at the 64 px scale for 2 steps, plain versions."""
    rng = np.random.default_rng(0)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=2)
    img, info = strotss_torch.stylize(
        rng.random((1, 48, 64, 3)), rng.random((1, 64, 56, 3)), cfg,
        vgg_params=random_params("16", 0), device="cpu")
    curve = info["scales"][0]["curve"]
    assert curve.shape == (2, 3) and np.all(np.isfinite(curve))
    assert tuple(img.shape) == (48, 64, 3)
