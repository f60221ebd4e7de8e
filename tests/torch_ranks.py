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
from strotss_torch.utils import timing

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
    mesh = make_mesh((dist.get_world_size(),), ("sample",),
                     devices=torch.device(device).type)
    out = []
    for x, y, distance in cases:
        xt = torch.tensor(x, device=device, requires_grad=True)
        yt = torch.tensor(y, device=device, requires_grad=True)
        before = timing.counters().get("launch.remd_mins", 0)
        loss = relaxed_emd_sharded(xt, yt, mesh, distance)
        launches = timing.counters().get("launch.remd_mins", 0) - before
        loss.backward()
        out.append((loss.item(), xt.grad.cpu().numpy(),
                    yt.grad.cpu().numpy(), launches))
    return out


def sharded_sinkhorn(cases, lam, n_iter):
    """For each (x, y, distance): ``sinkhorn_over_group`` with x's rows
    split over every rank, its value and the gradients of x and y."""
    from strotss_torch.parallel.transport import sinkhorn_over_group

    out = []
    for x, y, distance in cases:
        xt = torch.tensor(x, requires_grad=True)
        yt = torch.tensor(y, requires_grad=True)
        loss = sinkhorn_over_group(xt, yt, dist.group.WORLD, distance, lam,
                                   n_iter)
        loss.backward()
        out.append((loss.item(), xt.grad.numpy(), yt.grad.numpy()))
    return out


def _params():
    return random_params("16", seed=0)


def shard_samples_runs(content, style, masks, shape=(2,),
                       names=("sample",)):
    """``stylize`` under ``shard_samples`` on a 'sample' mesh: the tiny
    one-scale run of ``tests/test_parallel.py:264-292``, with REMD and
    with Sinkhorn, without and (if ``masks``) with region masks. Returns (curve, float image) per run,
    by (use_sinkhorn, masked)."""
    mesh = make_mesh(shape, names)
    params = _params()
    out = {}
    for use_sinkhorn in (False, True):
        cfg = strotss_torch.StrotssConfig(
            levels=1, max_iter=3, log_every=3, shard_samples=True,
            use_sinkhorn=use_sinkhorn, **TINY)
        for kw in [{}] + ([dict(content_masks=masks[0],
                                style_masks=masks[1])]
                          if masks is not None else []):
            _, info = strotss_torch.stylize(content, style, cfg,
                                            vgg_params=params, mesh=mesh,
                                            **kw)
            out[use_sinkhorn, bool(kw)] = (info["scales"][0]["curve"],
                                           info["stylized"].cpu().numpy())
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


# --- shard_spatial (tests/test_torch_spatial*.py) --------------------------

def _spatial(depth_taps, shape=None, names=("spatial",)):
    """A 'spatial' mesh of every rank (or ``shape``/``names``) and the
    :class:`Spatial` of ``depth_taps``."""
    from strotss_torch.parallel.spatial import Spatial

    mesh = make_mesh(shape or (dist.get_world_size(),), names)
    return mesh, Spatial(mesh.get_group("spatial"), depth_taps)


def spatial_vgg(cases):
    """For each (image, cotangents, taps, dtype, block1_impl): this rank's
    rows of each tap of VGG16 on the image split by height, and the image
    gradient of sum(tap * cotangent) over this rank's rows (the whole
    image's, after the slice's all-reduce), and the slab bounds."""
    from strotss_torch.models.vgg import VGG

    out = []
    for img, cots, taps, dtype, b1 in cases:
        _, spatial = _spatial(taps)
        vgg = VGG(_params(), taps=taps, compute_dtype=dtype, block1_impl=b1)
        x = torch.tensor(img, requires_grad=True)
        slab = spatial.slab(x.shape[1])
        got = vgg(x, slab)
        loss = 0.0
        for t, c, name in zip(got, cots, taps):
            a, b = slab.rows(int(name[5]) - 1)
            loss = loss + (t.float() * torch.tensor(c[:, a:b])).sum()
        g, = torch.autograd.grad(loss, x)
        out.append(([t.detach().float().numpy() for t in got], g.numpy(),
                    slab.bounds))
    return out


def spatial_conv(cases):
    """For each (x NCHW, kernel, cotangent, height, depth, level, pool):
    ``Slab.conv`` on this rank's rows of x, the map after ``level``
    poolings of an image of ``height`` rows, then ``Slab.pool`` if
    ``pool``; and the gradient of sum(out * cotangent) with respect to
    the rows. Returns (conv rows, out rows, gradient rows, rows)."""
    from strotss_torch.parallel.spatial import Slab

    out = []
    for x, k, cot, height, depth, level, pool in cases:
        slab = Slab(height, dist.group.WORLD, depth)
        a, b = slab.rows(level)
        h = torch.tensor(x[:, :, a:b], requires_grad=True)
        y = slab.conv(h, torch.tensor(k), level)
        z = slab.pool(y) if pool else y
        za, zb = slab.rows(level + pool)
        loss = (z * torch.tensor(cot[:, :, za:zb])).sum()
        g, = torch.autograd.grad(loss, h)
        out.append((y.detach().numpy(), z.detach().numpy(), g.numpy(),
                    (a, b)))
    return out


def spatial_block1(cases, device="cpu", impl="plain", depth=0):
    """For each (x, k1, b1, k2, b2, g1, g2): fused block1
    (``Slab.fused_block1``: K3a and K3b with ``impl`` 'auto' on the card,
    or their plain versions) on this rank's extended slab of x, split in
    units of ``2^depth`` rows: this rank's rows of both taps and the
    image gradient of sum(tap1 * g1 + tap2 * g2) over its rows, summed
    over the ranks by the slice's all-reduce."""
    from strotss_torch.parallel.spatial import Slab

    def t(a):
        return torch.tensor(a, device=device)

    out = []
    for x, k1, b1, k2, b2, g1, g2 in cases:
        xt = t(x).requires_grad_(True)
        slab = Slab(x.shape[1], dist.group.WORLD, depth)
        a, b = slab.rows(0)
        t1, t2 = slab.fused_block1(slab.extended(xt), *map(t, (k1, b1, k2,
                                                             b2)), impl=impl)
        loss = (t1 * t(g1[:, a:b])).sum() + (t2 * t(g2[:, a:b])).sum()
        g, = torch.autograd.grad(loss, xt)
        out.append((t1.detach().cpu().numpy(), t2.detach().cpu().numpy(),
                    g.cpu().numpy()))
    return out


def spatial_sampling(image, maps, levels, cases):
    """For each (coords, bilinear, integer_coords, cotangent): the rows
    ``SlabColumns.sample`` gives from this rank's rows of ``maps`` and the
    gradient of sum(rows * cotangent) with respect to those rows."""
    from strotss_torch.parallel.spatial import Slab, SlabColumns

    slab = Slab(image.shape[1], dist.group.WORLD, max(levels))
    out = []
    for coords, bilinear, integer, cot in cases:
        local = []
        for m, j in zip(maps, levels):
            a, b = slab.rows(j)
            local.append(torch.tensor(m[:, a:b], requires_grad=True))
        cols = SlabColumns(torch.tensor(image), local, levels, slab)
        rows = cols.sample(torch.tensor(coords), bilinear, integer)
        grads = torch.autograd.grad((rows * torch.tensor(cot)).sum(), local)
        out.append((rows.detach().numpy(), [g.numpy() for g in grads],
                    [slab.rows(j) for j in levels]))
    return out


class Table:
    """A ``coords_source`` that replays coordinates made elsewhere (the
    JAX package's, computed by the test): ``table[(scale, kind, step)]``."""

    def __init__(self, table):
        self.table = table

    def __call__(self, i, kind, step, hw, n, *region):
        return torch.tensor(self.table[(i, kind, step)])


def spatial_runs(content, style, runs, shape=None, names=("spatial",),
                 params=None):
    """``stylize`` under ``shard_spatial`` on a mesh of every rank (or
    ``shape``/``names``) for each (cfg kwargs, stylize kwargs; a
    ``style`` there replaces ``style``): each scale's curve, the float
    and uint8 images, and a digest of the pyramid after each scale."""
    import hashlib

    from strotss_torch import solve

    mesh = make_mesh(shape or (dist.get_world_size(),), names)
    params = _params() if params is None else params
    out = []
    for cfg_kw, kw in runs:
        kw = dict(kw)
        style_k = kw.pop("style", style)
        digests = []
        check = solve.check_replicas

        def digest(pyramid, group, scale):
            digests.append(hashlib.sha256(b"".join(
                p.detach().numpy().tobytes() for p in pyramid)).hexdigest())
            return check(pyramid, group, scale)

        solve.check_replicas = digest
        cfg = strotss_torch.StrotssConfig(shard_spatial=True, **cfg_kw)
        try:
            if "coords_source" in kw:  # solve's own argument
                img, info = solve.stylize_single(
                    torch.tensor(content), torch.tensor(style_k), cfg,
                    params, mesh=mesh, **kw)
            else:
                img, info = strotss_torch.stylize(
                    content, style_k, cfg, vgg_params=params, mesh=mesh,
                    **kw)
        finally:
            solve.check_replicas = check
        out.append(([s["curve"] for s in info["scales"]],
                    info["stylized"].numpy(), img.numpy(), digests))
    return out


def spatial_steps(content, style, cfg_kw, shape=None,
                  names=("spatial",)):
    """Every step of a ``shard_spatial`` run held to the unsharded step
    from the same pyramid: per step the sharded and the unsharded (loss,
    loss_c, loss_s) and the largest difference of the pyramid gradients
    over their largest value. The unsharded step runs here, on this
    rank's replica, with the same coordinates."""
    from strotss_torch import programs, solve
    from strotss_torch.ops.image import fold_laplacian_pyramid

    mesh = make_mesh(shape or (dist.get_world_size(),), names)
    held = []
    run_steps = solve.optimization_steps

    def grads(spec, vgg, cf, pyramid, args, coords, spatial, group):
        leaves = [p.detach().clone().requires_grad_(True) for p in pyramid]
        pred = programs.extract_for_grad(
            spec, vgg, fold_laplacian_pyramid(leaves), spatial)
        loss = programs.step_losses(spec, cf, pred, *args, coords,
                                    sample_group=group)
        return (torch.stack(loss).detach(),
                torch.autograd.grad(loss[0], leaves))

    def held_steps(spec, n, vgg, content_feats, targets, moments, alpha,
                   pyramid, opt, coords_fn, group=None, spatial=None,
                   step_gens=None):
        whole = programs.extract_hypercolumn(vgg, content_feats.image)
        rows = []
        for t in range(n):
            # one draw a step (the generator moves on at every call)
            coords = coords_fn(t)
            args = (targets, moments, alpha)
            got, g = grads(spec, vgg, content_feats, pyramid, args, coords,
                           spatial, group)
            ref, gu = grads(spec._replace(shard_samples=False), vgg, whole,
                            pyramid, args, coords, None, None)
            flat = torch.cat([x.reshape(-1) for x in g])
            flat_u = torch.cat([x.reshape(-1) for x in gu])
            held.append((got.numpy(), ref.numpy(), float(
                (flat - flat_u).abs().max() / flat_u.abs().max())))
            rows.append(run_steps(spec, 1, vgg, content_feats, targets,
                                  moments, alpha, pyramid, opt,
                                  lambda s, c=coords: c, group, spatial))
        return torch.cat(rows)

    solve.optimization_steps = held_steps
    try:
        strotss_torch.stylize(content, style, strotss_torch.StrotssConfig(
            shard_spatial=True, **cfg_kw), vgg_params=_params(), mesh=mesh)
    finally:
        solve.optimization_steps = run_steps
    return held


def spatial_resume(content, style, directory):
    """A ``shard_spatial`` run (2 scales of 4 steps, chunks of 2) whole,
    then stopped after the first chunk of scale 128 and resumed from its
    checkpoint: how many states this rank saved, and (the whole and the
    resumed float images, their last curves, where the checkpoint
    stopped)."""
    saves = []
    save_state = ckpt.save_state

    def counted(*a, **k):
        saves.append(a[0])
        return save_state(*a, **k)

    ckpt.save_state = counted
    mesh = make_mesh((dist.get_world_size(),), ("spatial",))
    base = dict(levels=2, max_iter=4, log_every=2, shard_spatial=True,
                **TINY)
    base["taps"] = None  # the 9 default taps
    params = _params()
    try:
        _, full = strotss_torch.stylize(
            content, style, strotss_torch.StrotssConfig(**base),
            vgg_params=params, mesh=mesh)
        cfg = strotss_torch.StrotssConfig(checkpoint_dir=directory, **base)
        try:
            strotss_torch.stylize(content, style, cfg, vgg_params=params,
                                  mesh=mesh, progress_cb=_stop_at(128))
        except Interrupt:
            pass
        dist.barrier()
        meta = ckpt.load_meta(directory)
        dist.barrier()
        _, resumed = strotss_torch.stylize(content, style, cfg,
                                           vgg_params=params, mesh=mesh)
    finally:
        ckpt.save_state = save_state
    return {"saves": len(saves),
            "run": (full["stylized"].numpy(), resumed["stylized"].numpy(),
                    full["scales"][-1]["curve"],
                    resumed["scales"][-1]["curve"],
                    (meta["scale_index"], meta["done_steps"]))}
