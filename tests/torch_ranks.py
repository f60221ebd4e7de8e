"""Rank functions of the port's multi-rank tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_cuda.py``).

``strotss_torch.parallel.launch`` starts each rank with ``spawn``, which
imports the module that holds the rank's function: this one imports no
JAX, so a rank starts in seconds. Inputs come in as numpy arrays made
by the tests; each rank returns numpy arrays and plain values.
"""

import os
import shutil
import time

import torch
import torch.distributed as dist

import strotss_torch
from strotss_torch.models.weights import random_params
from strotss_torch.parallel import make_mesh, stylize_batch
from strotss_torch.parallel.mesh import batch_sharding
from strotss_torch.parallel.transport import relaxed_emd_sharded
from strotss_torch.utils import checkpoint as ckpt

#: the tests' tiny configuration (one tap, 32 samples, float32)
TINY = dict(sample_size=32, compute_dtype="float32", use_pallas=False,
            taps=("block1_conv1",))


def mesh_facts(meshes, bad):
    """For each (shape, names) of ``meshes``: the mesh's shape and names,
    this rank's coordinates, the sizes of its axis groups and the slices
    a leading axis of 5 and of 4 takes here. Then the errors of
    ``make_mesh`` on each of ``bad``."""
    facts = []
    for shape, names in meshes:
        mesh = make_mesh(shape, names)
        facts.append({
            "shape": tuple(mesh.shape), "names": tuple(mesh.mesh_dim_names),
            "rank": dist.get_rank(),
            "coords": [mesh.get_local_rank(n) for n in names],
            "group_sizes": [dist.get_world_size(mesh.get_group(n))
                            for n in names],
            "part5": batch_sharding(mesh, 5, names[0]),
            "part4": batch_sharding(mesh, 4, names[0])})
    errors = []
    for shape, names in bad:
        try:
            make_mesh(shape, names)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return facts, errors


def raise_on(bad_rank):
    """Rank ``bad_rank`` raises; the others wait for it in a barrier."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"boom from rank {bad_rank}")
    dist.barrier()


def sleep(seconds):
    time.sleep(seconds)


def sharded_remd(cases, device="cpu"):
    """For each (x, y, distance): ``relaxed_emd_sharded`` over a 1-D
    'sample' mesh of every rank, its value and the gradients of x and y,
    and the launches of kernel K1's wrapper."""
    from strotss_torch.ops.kernels import remd

    mesh = make_mesh((dist.get_world_size(),), ("sample",),
                     devices=torch.device(device).type)
    out = []
    for x, y, distance in cases:
        xt = torch.tensor(x, device=device, requires_grad=True)
        yt = torch.tensor(y, device=device, requires_grad=True)
        remd.mins.launches = 0
        loss = relaxed_emd_sharded(xt, yt, mesh, distance)
        launches = remd.mins.launches
        loss.backward()
        out.append((loss.item(), xt.grad.cpu().numpy(),
                    yt.grad.cpu().numpy(), launches))
    return out


def _params():
    return random_params("16", seed=0)


def shard_samples_runs(content, style, masks, shape=(2,),
                       names=("sample",)):
    """``stylize`` under ``shard_samples`` on a 'sample' mesh: the tiny
    one-scale run of ``tests/test_parallel.py:264-292``, without and (if
    ``masks``) with region masks. Returns (curve, float image) per run."""
    mesh = make_mesh(shape, names)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=3, log_every=3,
                                      shard_samples=True, **TINY)
    params = _params()
    out = []
    for kw in [{}] + ([dict(content_masks=masks[0], style_masks=masks[1])]
                      if masks is not None else []):
        _, info = strotss_torch.stylize(content, style, cfg,
                                        vgg_params=params, mesh=mesh, **kw)
        out.append((info["scales"][0]["curve"],
                    info["stylized"].cpu().numpy()))
    return out


def batch_run(contents, styles, shape, names, cfg_kw, seeds=None):
    """``stylize_batch`` on a mesh of ``shape``: the images, the float
    images and each scale's curve."""
    mesh = make_mesh(shape, names)
    cfg = strotss_torch.StrotssConfig(**cfg_kw)
    imgs, info = stylize_batch(contents, styles, cfg, _params(), mesh=mesh,
                               pair_seeds=seeds)
    return (imgs.numpy(), info["stylized"].numpy(),
            [s["curve"] for s in info["scales"]])


class Interrupt(Exception):
    pass


def _stop_at(scale):
    def boom(scl, done, total, metrics):
        if scl == scale:
            raise Interrupt
    return boom


def checkpoint_runs(content, style, contents, styles, directory):
    """Interrupted and resumed runs under a mesh: a single run under
    ``shard_samples`` on a (2,) 'sample' mesh and a batch of 2 pairs on a
    (2,) 'data' mesh, each stopped after the first chunk of scale 128 and
    resumed from the checkpoint (rank 0 copies the checkpoint aside first,
    to ``<name>_copy``). Returns how many states this rank saved, and for
    each run the uninterrupted and the resumed float images and last
    curves and where the checkpoint stopped."""
    saves = []
    save_state = ckpt.save_state

    def counted(*a, **k):
        saves.append(a[0])
        return save_state(*a, **k)

    ckpt.save_state = counted
    params = _params()
    base = dict(levels=2, max_iter=4, log_every=2, **TINY)
    out = {}
    try:
        for name, mesh_args, run in (
                ("single", ((2,), ("sample",)), lambda cfg, mesh, **k:
                 strotss_torch.stylize(content, style, cfg,
                                       vgg_params=params, mesh=mesh, **k)),
                ("batch", ((2,), ("data",)), lambda cfg, mesh, **k:
                 stylize_batch(contents, styles, cfg, params, mesh=mesh,
                               pair_seeds=[5, 9], **k))):
            mesh = make_mesh(*mesh_args)
            cfg = strotss_torch.StrotssConfig(
                shard_samples=name == "single", **base)
            _, full = run(cfg, mesh)
            d = os.path.join(directory, name)
            run_ck = strotss_torch.StrotssConfig(
                shard_samples=name == "single", checkpoint_dir=d, **base)
            try:
                run(run_ck, mesh, progress_cb=_stop_at(128))
            except Interrupt:
                pass
            dist.barrier()
            meta = ckpt.load_meta(d)
            if dist.get_rank() == 0:
                # a copy the tests resume from without a mesh
                shutil.copytree(d, d + "_copy")
            dist.barrier()
            _, resumed = run(run_ck, mesh)
            out[name] = (full["stylized"].numpy(),
                         resumed["stylized"].numpy(),
                         full["scales"][-1]["curve"],
                         resumed["scales"][-1]["curve"],
                         (meta["scale_index"], meta["done_steps"]))
    finally:
        ckpt.save_state = save_state
    out["saves"] = len(saves)
    return out
