"""VGG weights for the port: the JAX package's npz files, or a seeded init.

Counterpart of ``strotss_tpu/models/weights.py`` (lines 46-66, 171-191,
253-316). Weights are resolved in the JAX package's order:

1. ``$STROTSS_TPU_WEIGHTS`` (an ``.npz`` in the JAX package's format);
2. ``~/.cache/strotss_tpu/vgg{16,19}_{norm,imagenet}.npz``;
3. the same path with ``.random.npz`` appended (the JAX package's cached
   random init);
4. a He-normal init drawn here from a seeded numpy generator, with a loud
   warning. Its shapes and scale are those of the JAX package's
   ``random_params``, but its values are not: those come from JAX's PRNG,
   which the port cannot run. Tests carry the JAX arrays across with
   :func:`params_from_jax` instead.

The ``.h5`` conversion and download branches of the JAX package are not
ported yet (ROADMAP.md). Params are ``{name: {'kernel': (cout, cin, 3, 3),
'bias': (cout,)}}`` float32 CPU tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

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


def _load_npz(path: str, vgg_type: str) -> Params:
    with np.load(path) as data:
        return params_from_jax({
            name: {"kernel": data[f"{name}.kernel"],
                   "bias": data[f"{name}.bias"]}
            for name in vgg_layer_names(vgg_type)
        })


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
        logger.warning(f"STROTSS_TPU_WEIGHTS={env} is not an .npz; the "
                       "port reads only the npz format")
    cache = _cache_path(vgg_type, use_keras_weight)
    if os.path.exists(cache):
        return _load_npz(cache, vgg_type)
    if os.path.exists(cache + ".random.npz"):
        logger.warning("Using cached RANDOM-init VGG weights (no pretrained "
                       "weights available offline).")
        return _load_npz(cache + ".random.npz", vgg_type)
    logger.warning(
        f"No pretrained VGG{vgg_type} weights found. Falling back to a "
        "seeded random init (numpy, seed 0) — stylization quality will not "
        "match ImageNet-feature STROTSS. Provide weights via "
        "$STROTSS_TPU_WEIGHTS."
    )
    return random_params(vgg_type, seed=0)
