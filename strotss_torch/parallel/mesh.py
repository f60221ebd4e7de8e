"""Device meshes over ``torch.distributed`` ranks, the counterpart of
``strotss_tpu/parallel/mesh.py`` (lines 29-56).

The JAX package drives every device of a mesh from one Python process.
The port runs one process a device (SPMD): every rank calls the same
entry point with the same inputs, and every rank returns the whole
result. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group, with the JAX package's axis
names:

- ``data``: independent (content, style) pairs of a batch, split over
  the axis (``stylize_batch(mesh=...)``); no traffic but the final
  gather.
- ``sample``: the style samples of the transport losses under
  ``cfg.shard_samples`` (:mod:`strotss_torch.parallel.transport`); one
  (p, N) all-gather, one scalar all-reduce and one (N, C) gradient
  all-reduce a REMD term a step, five (M,) all-reduces an iteration a
  Sinkhorn term a step.
- ``spatial``: the rows of one image under ``cfg.shard_spatial``
  (:mod:`strotss_torch.parallel.spatial`); two halo all-gathers a
  convolution of blocks 2-5 and one a sampled tap map, one (n, C)
  all-reduce a sampling and one (H, W, 3) gradient all-reduce a step.

The ranks start through :mod:`strotss_torch.parallel.launch` or through
``torchrun``; each then calls :func:`make_mesh`. The backend is NCCL when
every rank has a card of its own and gloo on the CPU (and where ranks
share a card).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",), devices=None):
    """A ``DeviceMesh`` of ``shape`` over the initialised default process
    group; rank r sits at the row-major position r.

    ``make_mesh()``: a 1-D 'data' mesh over every rank;
    ``make_mesh((2, 2), ('data', 'sample'))``: a 2-D mesh. ``devices``:
    the ranks' device type, 'cuda' or 'cpu'; default 'cuda' under NCCL
    and 'cpu' under gloo (ranks that share a card over gloo pass 'cuda').
    Each rank computes on :func:`rank_device`.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group, "
            "one process a device: start the ranks with "
            "strotss_torch.parallel.launch.launch(fn, devices), or with "
            "torchrun and torch.distributed.init_process_group() in each "
            "rank, then call make_mesh in every rank")
    k = dist.get_world_size()
    shape = (k,) if shape is None else tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes but "
                         f"{len(axis_names)} names {axis_names}")
    n = 1
    for s in shape:
        n *= s
    if n != k:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {k}")
    from torch.distributed.device_mesh import init_device_mesh

    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got {devices!r}")
    return init_device_mesh(devices, shape, mesh_dim_names=axis_names)


def rank_device(mesh) -> torch.device:
    """This rank's device under ``mesh``: the card the rank selected
    (``torch.cuda.set_device``, as the launcher does) under a 'cuda' mesh,
    else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def batch_sharding(mesh, n: int, axis: str = "data") -> slice:
    """This rank's part of a leading axis of length ``n`` split over
    ``axis`` (the JAX package's ``NamedSharding(mesh, P(axis))``): the
    ``torch.tensor_split`` slice, so uneven parts work."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return slice(0, n)
    p, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    lo = r * (n // p) + min(r, n % p)
    return slice(lo, lo + n // p + (r < n % p))
