"""The port's VGG against the JAX package's ``vgg_apply``, with the JAX
package's random weights carried across by ``params_from_jax``.

The JAX side stays at block1 and small images: XLA:CPU compiles each conv
shape for tens of seconds. Both sides run float32 convolutions at full
precision; 2e-4 is the tolerance tests/test_vgg.py holds the JAX VGG to
against tf.keras.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from strotss_torch.models import vgg as TV
from strotss_torch.models.weights import params_from_jax, random_params
from strotss_tpu.models import vgg as JV
from strotss_tpu.models.weights import random_params as jax_random_params


def _jax_params():
    return jax.tree.map(np.asarray, jax_random_params("16", 0))


def test_block1_taps_match_jax():
    img = np.random.default_rng(0).random((1, 40, 48, 3)).astype(np.float32)
    taps = ("block1_conv1", "block1_conv2")
    jp = _jax_params()
    want = JV.vgg_apply(jp, jnp.asarray(img), taps=taps)
    got = TV.vgg_apply(params_from_jax(jp), torch.tensor(img), taps=taps)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4)


def test_keras_preprocess_matches_jax():
    x = np.random.default_rng(1).random((1, 4, 5, 3)).astype(np.float32)
    for mode in ("norm", "keras"):
        np.testing.assert_allclose(
            TV.preprocess(torch.tensor(x), mode).numpy(),
            np.asarray(JV.preprocess(jnp.asarray(x), mode)), atol=1e-5)


def test_layer_tables_match_jax():
    for t in ("16", "19"):
        assert TV.vgg_layer_names(t) == JV.vgg_layer_names(t)
        assert TV.vgg_layer_channels(t) == JV.vgg_layer_channels(t)
    assert TV.STROTSS_DEFAULT_TAPS == JV.STROTSS_DEFAULT_TAPS


def test_params_from_jax_layout():
    jp = _jax_params()
    tp = params_from_jax(jp)
    k = jp["block2_conv1"]["kernel"]  # (3, 3, 64, 128) HWIO
    assert tuple(tp["block2_conv1"]["kernel"].shape) == (128, 64, 3, 3)
    np.testing.assert_array_equal(
        tp["block2_conv1"]["kernel"][5, 7].numpy(), k[:, :, 7, 5])


def test_full_vgg16_hypercolumn_width():
    """Torch only: the 9 default taps plus the image give 2179 channels,
    and the bf16 policy keeps block1 in float32."""
    img = torch.rand((1, 32, 48, 3), generator=torch.Generator().manual_seed(0))
    feats = TV.vgg_apply(random_params("16", 0), img,
                         compute_dtype="bfloat16")
    assert 3 + sum(f.shape[-1] for f in feats) == 2179
    assert TV.hypercolumn_channels() == 2179
    assert [f.dtype for f in feats[:2]] == [torch.float32] * 2
    assert all(f.dtype == torch.bfloat16 for f in feats[2:])
    assert tuple(feats[-1].shape) == (1, 2, 3, 512)


def test_random_params_shapes_and_scale():
    p = random_params("16", 0)
    jp = _jax_params()
    for name in TV.vgg_layer_names("16"):
        k = p[name]["kernel"]
        assert tuple(k.shape) == tuple(np.transpose(jp[name]["kernel"],
                                                    (3, 2, 0, 1)).shape)
        std = float(np.sqrt(2.0 / (9 * k.shape[1])))
        assert abs(float(k.std()) / std - 1) < 0.05
