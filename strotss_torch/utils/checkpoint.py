"""Checkpoint and resume of a run's optimization state, the counterpart of
``strotss_tpu/utils/checkpoint.py``.

The state of the scale in progress is a flat mapping of named tensors:
the Laplacian-pyramid leaves, the RMSprop slots and the scale's step
generator state (``torch.Generator.get_state()``; a batch saves one a
pair). With the scale index, the steps done and alpha (a batch's per-pair
list) it is saved after every chunk into one
``state.npz``, replaced atomically, which also holds the metadata; a
``state.json`` beside it mirrors that metadata for people. The metadata
carries the run's *fingerprint* (the configuration fields and input
shapes that decide the trajectory) and a *structure digest* (each leaf's
name, shape and dtype, hashed). A resume with another fingerprint, or
into a template of another structure, raises a clean error instead of
restoring the wrong state; no pickle is involved.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_STATE_NPZ = "state.npz"
_STATE_META = "state.json"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def structure_digest(state: Mapping[str, Any]) -> str:
    """Stable hash of every leaf's name, shape and dtype, in order: a
    template with the same leaf count but other shapes (another tap set,
    pyramid depth or image size) does not match."""
    desc = ";".join(f"{name}:{tuple(np.shape(v))}:{_numpy(v).dtype}"
                    for name, v in state.items())
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def check_fingerprint(meta: Dict[str, Any], fingerprint: Dict[str, Any],
                      directory: str) -> None:
    """Refuse to resume when the run's configuration changed.

    ``fingerprint`` is a JSON-compatible dict of everything that decides
    the trajectory. A checkpoint without one (the JAX package writes
    ``None`` for its legacy runs) or with another one is refused: the
    port's fingerprint names its package, so a checkpoint of the JAX
    package is never restored here."""
    saved = meta.get("fingerprint") or {}
    if saved != fingerprint:
        diffs = sorted(k for k in set(saved) | set(fingerprint)
                       if saved.get(k) != fingerprint.get(k))
        raise ValueError(
            f"Checkpoint at {directory} was written by a different run "
            f"configuration (mismatched: {diffs or 'entire fingerprint'}). "
            "Delete the checkpoint directory to start fresh.")


def save_state(directory: str, scale_index: int, done_steps: int,
               alpha, state: Mapping[str, Any],
               fingerprint: Optional[Dict[str, Any]] = None,
               extras: Optional[Mapping[str, Any]] = None) -> None:
    """Persist the state of the scale in progress, atomically.

    ``extras``: named arrays saved beside the state (the chunk's float
    image and its uint8 image), returned by :func:`restore_extras`: a
    resume on a completed scale boundary hands them to the next scale as
    they were. ``alpha``: a float, or a batch's list of per-pair floats."""
    os.makedirs(directory, exist_ok=True)
    arrays = {f"leaf_{name}": _numpy(v) for name, v in state.items()}
    for name, v in (extras or {}).items():
        arrays[f"extra_{name}"] = _numpy(v)
    meta = {
        "scale_index": int(scale_index),
        "done_steps": int(done_steps),
        "alpha": ([float(a) for a in alpha]
                  if isinstance(alpha, (list, tuple)) else float(alpha)),
        "n_leaves": len(state),
        "structure": structure_digest(state),
        "fingerprint": fingerprint,
    }
    # the metadata rides inside the npz, so state and metadata commit in
    # the one os.replace below and cannot be torn apart by a crash
    arrays["meta_json"] = np.asarray(json.dumps(meta))
    # the suffix must end in .npz, or np.savez writes "<tmp>.npz"
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(directory, _STATE_NPZ))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    # the mirror; if a crash falls between the two replaces, load_meta
    # reads the npz's copy
    tmp_meta = os.path.join(directory, _STATE_META + ".tmp")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_meta, os.path.join(directory, _STATE_META))


def restore_extras(directory: str) -> Dict[str, np.ndarray]:
    """The named arrays saved beside the state (empty if none)."""
    path = os.path.join(directory, _STATE_NPZ)
    if not os.path.exists(path):
        return {}
    with np.load(path) as data:
        return {f[len("extra_"):]: data[f] for f in data.files
                if f.startswith("extra_")}


def load_meta(directory: Optional[str]) -> Optional[Dict[str, Any]]:
    """The checkpoint's metadata, or None when there is no checkpoint.
    The copy inside ``state.npz`` wins over the ``state.json`` mirror; a
    checkpoint whose metadata is only in the mirror still loads."""
    if not directory:
        return None
    npz = os.path.join(directory, _STATE_NPZ)
    if os.path.exists(npz):
        try:
            with np.load(npz) as data:
                if "meta_json" in data.files:
                    return json.loads(data["meta_json"].item())
        except Exception:
            pass  # unreadable npz: restore_state raises the clean error
    path = os.path.join(directory, _STATE_META)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def restore_state(directory: str,
                  template: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The saved leaves, as tensors with each template leaf's dtype and
    device. The saved structure digest must be the template's."""
    path = os.path.join(directory, _STATE_NPZ)
    try:
        with np.load(path) as data:
            saved = {f[len("leaf_"):]: data[f] for f in data.files
                     if f.startswith("leaf_")}
    except Exception as e:
        raise ValueError(
            f"Corrupt or unreadable checkpoint at {path}: {e}. "
            "Delete the checkpoint directory to restart from scratch."
        ) from e
    meta = load_meta(directory)
    if meta is not None and "structure" in meta:
        want = structure_digest(template)
        if meta["structure"] != want:
            raise ValueError(
                f"Checkpoint at {directory} has structure "
                f"{meta['structure']} but this run expects {want} — "
                "config/shape mismatch with the saved run. Delete the "
                "checkpoint directory to restart from scratch.")
    if set(saved) != set(template):
        raise ValueError(
            f"checkpoint has leaves {sorted(saved)}, expected "
            f"{sorted(template)} — config/shape mismatch with the saved run")
    return {name: torch.from_numpy(np.array(saved[name])).to(
        device=t.device, dtype=t.dtype).reshape(t.shape)
        for name, t in template.items()}
