"""The port's VGG weight loading: Keras-layout ``.h5`` files read by the
port and by the JAX package, ``$STROTSS_TPU_WEIGHTS`` naming one, and
``~/.keras`` with the normalised and Keras weights kept apart.

The files are written here with h5py at VGG16's full conv shapes (the
loaders hold a file to the exact shape chain), from a seeded numpy
generator.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from strotss_torch.models import weights as TW
from strotss_torch.models.vgg import vgg_layer_channels, vgg_layer_names
from strotss_tpu.models import weights as JW


def _raw(seed):
    """{name: (HWIO kernel, bias)} of VGG16's 13 convolutions."""
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for name in vgg_layer_names("16"):
        cout = vgg_layer_channels("16")[name]
        out[name] = (rng.standard_normal((3, 3, cin, cout), np.float32),
                     rng.standard_normal((cout,), np.float32))
        cin = cout
    return out


def _write(path, raw, layout):
    with h5py.File(path, "w") as f:
        if layout == "keras2":  # model.save_weights
            root = f.create_group("model_weights")
            for name, (k, b) in raw.items():
                g = root.create_group(name).create_group(name)
                g["kernel:0"], g["bias:0"] = k, b
        elif layout == "keras3":  # .weights.h5: conv2d, conv2d_1, ...
            for i, (k, b) in enumerate(raw.values()):
                g = f.create_group(f"layers/conv2d{'' if i == 0 else f'_{i}'}"
                                   "/vars")
                g["0"], g["1"] = k, b
        else:  # Theano-era: one flat group, <name>_W / <name>_b
            g = f.create_group("weights")
            for name, (k, b) in raw.items():
                g[f"{name}_W"], g[f"{name}_b"] = k, b
    return str(path)


def _equal(params, raw):
    want = TW.params_from_jax({n: {"kernel": k, "bias": b}
                               for n, (k, b) in raw.items()})
    assert set(params) == set(want)
    for name in want:
        for part in ("kernel", "bias"):
            assert torch.equal(params[name][part], want[name][part]), name


@pytest.mark.parametrize("layout", ["keras2", "keras3", "theano"])
def test_load_h5_matches_jax(tmp_path, layout):
    raw = _raw(1)
    path = _write(tmp_path / "vgg16.h5", raw, layout)
    got = TW._load_h5(path, "16")
    want = JW._load_h5(path, "16")
    assert got is not None and want is not None
    _equal(got, raw)
    jp = TW.params_from_jax(jax.tree.map(np.asarray, want))
    for name in got:
        for part in ("kernel", "bias"):
            assert torch.equal(got[name][part], jp[name][part])


def test_load_h5_refuses_a_file_without_the_vgg_chain(tmp_path):
    raw = dict(list(_raw(2).items())[:3])
    path = _write(tmp_path / "short.h5", raw, "keras2")
    assert TW._load_h5(path, "16") is None
    assert JW._load_h5(path, "16") is None


def test_natural_key_matches_jax():
    names = ["conv2d_10", "conv2d_2", "conv2d", "conv2d_1", "x/7a", "x/10"]
    assert sorted(names, key=TW._natural_key) == sorted(
        names, key=JW._natural_key)


def test_env_names_an_h5(tmp_path, monkeypatch):
    raw = _raw(3)
    path = _write(tmp_path / "mine.h5", raw, "keras2")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("STROTSS_TPU_WEIGHTS", path)
    _equal(TW.load_vgg_params("16"), raw)


def test_keras_home_keeps_the_modes_apart(tmp_path, monkeypatch):
    """The default mode takes only the normalised weights' file, the Keras
    mode never does; each converts into its own npz cache, in the JAX
    package's format, which later runs read."""
    home = tmp_path / "home"
    models = home / ".keras" / "models"
    models.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("STROTSS_TPU_WEIGHTS", raising=False)
    norm, keras = _raw(4), _raw(5)
    _write(models / "vgg16_norm_weights.h5", norm, "keras2")
    _write(models / "vgg16_weights_tf_dim_ordering_tf_kernels_notop.h5",
           keras, "keras2")
    _equal(TW.load_vgg_params("16", use_keras_weight=False), norm)
    _equal(TW.load_vgg_params("16", use_keras_weight=True), keras)
    cache = home / ".cache" / "strotss_tpu"
    for tag, raw in (("norm", norm), ("imagenet", keras)):
        jp = JW._load_npz(str(cache / f"vgg16_{tag}.npz"), "16")
        _equal(TW.params_from_jax(jax.tree.map(np.asarray, jp)), raw)
    for f in models.iterdir():
        f.unlink()
    _equal(TW.load_vgg_params("16", use_keras_weight=False), norm)
