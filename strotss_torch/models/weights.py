"""VGG weights for the port: the JAX package's npz files, local Keras
``.h5`` files, or a seeded init.

Counterpart of ``strotss_tpu/models/weights.py`` (lines 46-191,
253-316). Weights are resolved in the JAX package's order:

1. ``$STROTSS_TPU_WEIGHTS``: an ``.npz`` in the JAX package's format, or
   a Keras-layout ``.h5``;
2. ``~/.cache/strotss_tpu/vgg{16,19}_{norm,imagenet}.npz``;
3. the same path with ``.random.npz`` appended (the JAX package's cached
   random init);
4. ``~/.keras/{models,datasets}/*vgg{16,19}*.h5``: the normalised
   weights' file (its name holds "norm") for the default mode, any other
   for ``use_keras_weight``; the first that parses is converted into the
   npz cache of 2.;
5. a He-normal init drawn here from a seeded numpy generator, with a loud
   warning. Its shapes and scale are those of the JAX package's
   ``random_params``, but its values are not: those come from JAX's PRNG,
   which the port cannot run. Tests carry the JAX arrays across with
   :func:`params_from_jax` instead.

The JAX package's download branches are not ported: the port never
reaches the network. Params are ``{name: {'kernel': (cout, cin, 3, 3),
'bias': (cout,)}}`` float32 CPU tensors.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from strotss_torch.models.vgg import vgg_layer_channels, vgg_layer_names
from strotss_torch.utils.logging import logger

Params = Dict[str, Dict[str, torch.Tensor]]


def _cache_path(vgg_type: str, use_keras_weight: bool) -> str:
    tag = "imagenet" if use_keras_weight else "norm"
    return os.path.join(os.path.expanduser("~"), ".cache", "strotss_tpu",
                        f"vgg{vgg_type}_{tag}.npz")


def params_from_jax(np_params: Mapping) -> Params:
    """JAX pytree ``{name: {'kernel': (3,3,cin,cout), 'bias'}}`` (numpy or
    any array) -> the port's OIHW tensors."""
    out: Params = {}
    for name, p in np_params.items():
        k = np.asarray(p["kernel"], dtype=np.float32)
        out[name] = {
            "kernel": torch.tensor(k.transpose(3, 2, 0, 1)).contiguous(),
            "bias": torch.tensor(np.asarray(p["bias"], dtype=np.float32)),
        }
    return out


def save_npz(params: Params, path: str) -> None:
    """Write ``params`` in the JAX package's npz format (HWIO kernels)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = {}
    for name, p in params.items():
        flat[f"{name}.kernel"] = np.ascontiguousarray(
            p["kernel"].numpy().transpose(2, 3, 1, 0), dtype=np.float32)
        flat[f"{name}.bias"] = p["bias"].numpy().astype(np.float32)
    np.savez(path, **flat)


def _load_npz(path: str, vgg_type: str) -> Params:
    with np.load(path) as data:
        return params_from_jax({
            name: {"kernel": data[f"{name}.kernel"],
                   "bias": data[f"{name}.bias"]}
            for name in vgg_layer_names(vgg_type)
        })


def _natural_key(s: str):
    """Digit-aware sort key: 'conv2d_2' < 'conv2d_10' (a plain string
    sort puts _10 before _2 and scrambles Keras 3's layer order)."""
    return [(0, int(t), "") if t.isdigit() else (1, 0, t)
            for t in re.split(r"(\d+)", s)]


def _load_h5(path: str, vgg_type: str) -> Optional[Params]:
    """A Keras-layout VGG ``.h5`` as params, or None when h5py is missing
    or the file does not hold the VGG chain
    (``strotss_tpu/models/weights.py:78-160``).

    Reads the three layouts of the JAX package: Keras 2
    ``model.save_weights`` (``model_weights`` root, groups of
    ``kernel:0``/``bias:0``), Theano-era ``<name>_W``/``<name>_b`` and
    Keras 3 ``layers/conv2d_N/vars/{0,1}``. Each 4-D kernel takes the one
    1-D dataset of its length in its group, or, where a flat group holds
    several, the bias named after it. Layers are ordered by a
    digit-aware sort of their names and held to the VGG shape chain.
    """
    try:
        import h5py
    except ImportError:
        return None
    pairs = []  # (group name, kernel, bias)

    def visit(name, obj):
        if not (hasattr(obj, "shape") and obj.ndim == 4):
            return
        cands = [(sname, sib) for sname, sib in obj.parent.items()
                 if hasattr(sib, "shape") and sib.ndim == 1
                 and sib.shape[0] == obj.shape[-1]]
        bias = None
        if len(cands) == 1:
            bias = np.asarray(cands[0][1])
        else:
            # a flat legacy group: only the exact name pairing is safe
            leaf = name.rsplit("/", 1)[-1]
            if leaf.endswith("_W"):
                want = leaf[:-2] + "_b"
                bias = next((np.asarray(sib) for sname, sib in cands
                             if sname == want), None)
        if bias is not None:
            pairs.append((name, np.asarray(obj), bias))

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)

    pairs.sort(key=lambda t: _natural_key(t[0]))
    names = vgg_layer_names(vgg_type)
    chans = vgg_layer_channels(vgg_type)
    if len(pairs) < len(names):
        return None
    raw = {}
    cin = 3
    for name, (gname, k, b) in zip(names, pairs):
        if (k.shape[-1] != chans[name] or k.shape[-2] != cin
                or k.shape[:2] != (3, 3) or b.shape[0] != chans[name]):
            logger.warning(
                f"h5 layer shape mismatch at {name} "
                f"(expect (3,3,{cin},{chans[name]})): {k.shape}/{b.shape} "
                f"from '{gname}'; skipping this weight file")
            return None
        raw[name] = {"kernel": k, "bias": b}
        cin = chans[name]
    return params_from_jax(raw)


def random_params(vgg_type: str = "16", seed: int = 0) -> Params:
    """He-normal init from a seeded numpy generator (biases zero)."""
    rng = np.random.default_rng(seed)
    raw = {}
    cin = 3
    for name in vgg_layer_names(vgg_type):
        cout = vgg_layer_channels(vgg_type)[name]
        std = float(np.sqrt(2.0 / (3 * 3 * cin)))
        raw[name] = {
            "kernel": rng.standard_normal((3, 3, cin, cout),
                                          dtype=np.float32) * std,
            "bias": np.zeros((cout,), np.float32),
        }
        cin = cout
    return params_from_jax(raw)


def load_vgg_params(vgg_type: str = "16",
                    use_keras_weight: bool = False) -> Params:
    vgg_type = str(vgg_type)
    env = os.environ.get("STROTSS_TPU_WEIGHTS")
    if env and os.path.exists(env):
        if env.endswith(".npz"):
            return _load_npz(env, vgg_type)
        p = _load_h5(env, vgg_type)
        if p is not None:
            return p
        logger.warning(f"Could not parse STROTSS_TPU_WEIGHTS={env}")
    cache = _cache_path(vgg_type, use_keras_weight)
    if os.path.exists(cache):
        return _load_npz(cache, vgg_type)
    if os.path.exists(cache + ".random.npz"):
        logger.warning("Using cached RANDOM-init VGG weights (no pretrained "
                       "weights available offline).")
        return _load_npz(cache + ".random.npz", vgg_type)
    keras_home = os.path.join(os.path.expanduser("~"), ".keras")
    for sub in ("models", "datasets"):
        d = os.path.join(keras_home, sub)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            # the two weight modes never cross: the default mode takes only
            # the normalised VGG's file, the Keras mode never does
            if (not fn.endswith(".h5") or f"vgg{vgg_type}" not in fn.lower()
                    or ("norm" in fn.lower()) != (not use_keras_weight)):
                continue
            path = os.path.join(d, fn)
            p = _load_h5(path, vgg_type)
            if p is not None:
                logger.info(f"Converted VGG weights from {path}")
                save_npz(p, cache)
                return p
    logger.warning(
        f"No pretrained VGG{vgg_type} weights found. Falling back to a "
        "seeded random init (numpy, seed 0) — stylization quality will not "
        "match ImageNet-feature STROTSS. Provide weights via "
        "$STROTSS_TPU_WEIGHTS."
    )
    return random_params(vgg_type, seed=0)
