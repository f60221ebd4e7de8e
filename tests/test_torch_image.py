"""The port's image ops against the TF goldens (at tests/test_image_ops.py's
tolerances) and against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strotss_torch.ops import image as TI
from strotss_tpu.ops import image as JI


def test_resize_matches_tf(golden):
    g = golden("resize")
    img = torch.tensor(g["img"])
    for key in g.files:
        if not key.startswith("r_"):
            continue
        h, w = map(int, key[2:].split("x"))
        out = TI.resize_bilinear(img, (h, w))
        np.testing.assert_allclose(out.numpy(), g[key], atol=2e-6)


@pytest.mark.parametrize("hw", [(18, 26), (74, 106), (7, 11), (31, 47)])
def test_resize_matches_jax(hw):
    img = np.random.default_rng(0).random((1, 37, 53, 3)).astype(np.float32)
    want = JI.resize_bilinear(jnp.asarray(img), hw)
    got = TI.resize_bilinear(torch.tensor(img), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    hwc = TI.resize_bilinear(torch.tensor(img[0]), hw)
    np.testing.assert_allclose(hwc.numpy(), np.asarray(want)[0], atol=2e-6)


def test_resize_max_and_cap_max_arithmetic():
    for shape, size in (((1, 481, 321, 3), 512), ((1, 48, 64, 3), 128),
                        ((1, 31, 16, 3), 30)):
        t = TI.resize_max(torch.zeros(shape), size)
        j = JI.resize_max(jnp.zeros(shape), size)
        assert tuple(t.shape) == tuple(j.shape)
    once = TI.resize_max(torch.zeros((1, 31, 16, 3)), 30)
    assert tuple(TI.resize_max(once, 30).shape) == (1, 30, 15, 3)
    assert TI.cap_max(once, 30) is once
    small = torch.zeros((1, 8, 8, 3))
    assert TI.cap_max(small, 30) is small and TI.cap_max(small, None) is small


def test_pyramid_matches_tf(golden):
    g = golden("pyramid")
    pyr = TI.make_laplacian_pyramid(torch.tensor(g["im"]), levels=5)
    assert len(pyr) == 6
    for i, p in enumerate(pyr):
        np.testing.assert_allclose(p.numpy(), g[f"lvl{i}"], atol=3e-6)
    fold = TI.fold_laplacian_pyramid(pyr)
    np.testing.assert_allclose(fold.numpy(), g["fold"], atol=3e-6)


def test_pyramid_matches_jax():
    im = np.random.default_rng(1).random((1, 40, 56, 3)).astype(np.float32)
    tp = TI.make_laplacian_pyramid(torch.tensor(im), levels=5)
    jp = JI.make_laplacian_pyramid(jnp.asarray(im), levels=5)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-6)
    assert TI.laplacian_pyramid_shapes((64, 42), 5) == \
        JI.laplacian_pyramid_shapes((64, 42), 5)


def test_yuv_matches_tf_and_jax(golden):
    g = golden("yuv")
    out = TI.rgb_to_yuv(torch.tensor(g["feat"][:, :3]))
    np.testing.assert_allclose(out.numpy(), g["yuv"], atol=1e-6)
    j = JI.rgb_to_yuv(jnp.asarray(g["feat"]))
    np.testing.assert_allclose(TI.rgb_to_yuv(torch.tensor(g["feat"])).numpy(),
                               np.asarray(j), atol=1e-6)


def test_postprocess_matches_jax():
    x = np.linspace(-0.5, 1.5, 24 * 5, dtype=np.float32).reshape(1, 8, 5, 3)
    got = TI.postprocess(torch.tensor(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (8, 5, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JI.postprocess(jnp.asarray(x))))
