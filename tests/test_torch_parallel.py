"""The port's multi-device half (``strotss_torch.parallel``: ``make_mesh``,
the launcher, the sample-sharded REMD and Sinkhorn, ``stylize(mesh=)``
under ``shard_samples``, ``stylize_batch(mesh=)`` and serve's
``--data_devices``) on the CPU: ranks are processes of the launcher,
joined over gloo, one thread each.

The sharded REMD is held to the JAX package's ``relaxed_emd`` and, on 8
ranks, to its ``relaxed_emd_sharded`` on the 8-device CPU mesh; the
sharded Sinkhorn to its materialized ``sinkhorn(impl='xla')``, which
GSPMD partitions under ``shard_samples``: values to rtol 1e-5, gradients
to 1e-4 of max|g| (a gradient scaled by the world size fails by far). Sharded runs are held to the port's unsharded
runs with the JAX test's own tolerance (``tests/test_parallel.py:
264-292``: rtol 2e-4, atol 1e-5), every rank's result bit for bit the
others'; a batch over a 'data' mesh is the unsharded batch bit for bit
(one thread on both sides). The rank functions live in
``tests/torch_ranks.py``, which imports no JAX. Each launch has a
timeout, so no test can hang.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strotss_torch
import torch_ranks as R
from strotss_torch.models.weights import random_params
from strotss_torch.parallel import launch as L
from strotss_torch.parallel import make_mesh, stylize_batch
from strotss_torch.parallel.mesh import batch_sharding
from strotss_tpu.ops import losses as JL
from strotss_tpu.parallel.mesh import make_mesh as jax_make_mesh
from strotss_tpu.parallel.transport import (
    relaxed_emd_sharded as jax_relaxed_emd_sharded,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds for a launch and for each collective of its ranks
TIMEOUT = 120
DISTANCES = ("cosine", "l2", "both")


def _launch(fn, n, *args):
    return L.launch(fn, ["cpu"] * n, args=args, timeout=TIMEOUT, threads=1)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return random_params("16", seed=0)


def _images(n, seed, hw=(40, 40)):
    return np.random.default_rng(seed).random((n, *hw, 3)).astype(np.float32)


# --- (1) make_mesh ---------------------------------------------------------

MESHES = [((4,), ("data",)), ((2, 2), ("data", "sample")),
          ((1, 4), ("data", "sample")), ((4,), ("sample",))]


@pytest.fixture(scope="module")
def mesh_facts():
    return _launch(R.mesh_facts, 4, MESHES,
                   [((3,), ("data",)), ((2, 2), ("data",))])


@pytest.mark.parametrize("which", range(len(MESHES)))
def test_make_mesh_shapes_and_names(mesh_facts, which):
    shape, names = MESHES[which]
    facts = [r[0][which] for r in mesh_facts]
    for rank, f in enumerate(facts):
        assert f["shape"] == shape and f["names"] == names
        assert f["rank"] == rank
        # row-major: rank r sits at np.unravel_index(r, shape)
        assert f["coords"] == list(np.unravel_index(rank, shape))
        assert f["group_sizes"] == list(shape)
        parts = [torch.arange(n).tensor_split(shape[0]) for n in (5, 4)]
        d = f["coords"][0]
        for part, n, got in zip(parts, (5, 4), (f["part5"], f["part4"])):
            assert list(range(n))[got] == part[d].tolist()


def test_make_mesh_errors(mesh_facts):
    for _, errors in mesh_facts:
        assert errors == ["mesh shape (3,) needs 3 devices, have 4",
                          "mesh shape (2, 2) has 2 axes but 1 names "
                          "('data',)"]
    # the JAX package's text for the count
    with pytest.raises(ValueError, match=r"needs 16 devices, have 8"):
        jax_make_mesh((16,), ("data",), devices=jax.devices("cpu"))


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="launch.launch"):
        make_mesh((1,), ("data",))


class _Mesh:
    """The two things ``batch_sharding`` asks of a mesh."""

    def __init__(self, size, rank):
        self.mesh_dim_names = ("data",)
        self._size, self._rank = size, rank

    def size(self, dim):
        return self._size

    def get_local_rank(self, axis):
        return self._rank


@pytest.mark.parametrize("n,p", [(8, 2), (10, 3), (2, 4), (7, 7)])
def test_batch_sharding_is_tensor_split(n, p):
    want = torch.arange(n).tensor_split(p)
    for r in range(p):
        got = list(range(n))[batch_sharding(_Mesh(p, r), n)]
        assert got == want[r].tolist()


# --- (2) the launcher ------------------------------------------------------

def test_a_rank_that_raises_stops_the_launch():
    with pytest.raises(L.RankError) as err:
        _launch(R.raise_on, 2, 1)
    msg = str(err.value)
    assert msg.startswith("rank 1 raised:")
    assert "ValueError: boom from rank 1" in msg and "raise_on" in msg


def test_a_rank_that_hangs_times_out():
    with pytest.raises(L.RankError, match=r"rank\(s\) \[0\] did not finish "
                       r"within 6 s"):
        L.launch(R.sleep, ["cpu"], args=(60,), timeout=6, threads=1)


def test_backend_choice():
    assert L.choose_backend(["cpu", "cpu"]) == "gloo"
    assert L.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert L.choose_backend(["cuda:0", "cuda:0"]) == "gloo"


# --- (3) the sample-sharded REMD --------------------------------------------

def _remd_cases(p):
    """Per distance: a wide case (N = 1.5 M, the row term active) and a
    tall one (N = M / 2, the column term); at p = 3, M = 1000 rows split
    334/333/333 (and 2000: 667/667/666)."""
    rng = np.random.default_rng(10 + p)
    m = 1000 if p == 3 else 64
    cases = []
    for distance in DISTANCES:
        for n, mm, c in ((3 * m // 2, m, 12), (m // 2, 2 * m, 6)):
            cases.append((rng.standard_normal((n, c)).astype(np.float32),
                          rng.standard_normal((mm, c)).astype(np.float32),
                          distance))
    return cases


@pytest.fixture(scope="module")
def remd_runs():
    cache = {}

    def runs(p):
        if p not in cache:
            cases = _remd_cases(p)
            cache[p] = cases, _launch(R.sharded_remd, p, cases)
        return cache[p]
    return runs


def _close_grad(g, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("distance", DISTANCES)
def test_sharded_remd_matches_jax_relaxed_emd(remd_runs, p, distance):
    cases, ranks = remd_runs(p)
    active = set()
    for k, (x, y, d) in enumerate(cases):
        if d != distance:
            continue
        fn = lambda a, b: JL.relaxed_emd(a, b, d)  # noqa: E731
        ref = float(fn(jnp.asarray(x), jnp.asarray(y)))
        gx, gy = jax.grad(fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        c = np.asarray(JL.dist_metrics[d](jnp.asarray(x), jnp.asarray(y)))
        active.add(c.min(1).mean() > c.min(0).mean())
        for value, dx, dy, launches in (r[k] for r in ranks):
            np.testing.assert_allclose(value, ref, rtol=1e-5)
            assert launches == 0  # on the CPU: K1's plain version
            _close_grad(dx, np.asarray(gx))
            _close_grad(dy, np.asarray(gy))
            # a gradient scaled by p (the world size) is p - 1 max|g| off
            assert not np.allclose(dx, p * np.asarray(gx), atol=1e-6)
        # every rank holds the same bits
        for r in ranks[1:]:
            assert r[k][0] == ranks[0][k][0]
            assert np.array_equal(r[k][1], ranks[0][k][1])
    # the cases run both the row-minimum and the column-minimum gradient
    assert active == {True, False}


@pytest.mark.parametrize("distance", DISTANCES)
def test_sharded_remd_matches_jax_sharded_on_8(remd_runs, distance):
    cases, ranks = remd_runs(8)
    mesh = jax_make_mesh((8,), ("sample",), devices=jax.devices("cpu")[:8])
    for k, (x, y, d) in enumerate(cases):
        if d != distance:
            continue
        fn = lambda a: jax_relaxed_emd_sharded(  # noqa: E731
            a, jnp.asarray(y), mesh, d)
        ref = float(fn(jnp.asarray(x)))
        gx = np.asarray(jax.grad(fn)(jnp.asarray(x)))
        for value, dx, _, _ in (r[k] for r in ranks):
            np.testing.assert_allclose(value, ref, rtol=1e-5)
            _close_grad(dx, gx)


# --- (3b) the sample-sharded Sinkhorn ---------------------------------------

SINKHORN_DISTANCES = ("cosine", "both")
#: lam and iterations of the sharded Sinkhorn's cases
SINKHORN_LAM, SINKHORN_ITERS = 10.0, 20


def _sinkhorn_cases(p):
    """Per distance: a wide case (N = 1.5 M) and a tall one (N = M / 2),
    N the split rows; at p = 3, M = 101: 151 rows as 51/50/50 and 50 as
    17/17/16."""
    rng = np.random.default_rng(30 + p)
    m = 101 if p == 3 else 64
    cases = {}
    for distance in SINKHORN_DISTANCES:
        for shape, n, mm, c in (("wide", 3 * m // 2, m, 12),
                                ("tall", m // 2, 2 * m, 6)):
            cases[distance, shape] = (
                rng.standard_normal((n, c)).astype(np.float32),
                rng.standard_normal((mm, c)).astype(np.float32), distance)
    return cases


@pytest.fixture(scope="module")
def sinkhorn_runs():
    cache = {}

    def runs(p):
        if p not in cache:
            cases = _sinkhorn_cases(p)
            ranks = _launch(R.sharded_sinkhorn, p, list(cases.values()),
                            SINKHORN_LAM, SINKHORN_ITERS)
            cache[p] = {key: (case, [r[k] for r in ranks])
                        for k, (key, case) in enumerate(cases.items())}
        return cache[p]
    return runs


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("distance", SINKHORN_DISTANCES)
@pytest.mark.parametrize("shape", ["wide", "tall"])
def test_sharded_sinkhorn_matches_jax_sinkhorn(sinkhorn_runs, p, distance,
                                               shape):
    (x, y, d), ranks = sinkhorn_runs(p)[distance, shape]
    if p == 3:
        assert x.shape[0] % 3  # the shards are uneven
    fn = lambda a, b: JL.sinkhorn(  # noqa: E731
        a, b, d, SINKHORN_LAM, SINKHORN_ITERS, impl="xla")
    ref = float(fn(jnp.asarray(x), jnp.asarray(y)))
    gx, gy = map(np.asarray, jax.grad(fn, argnums=(0, 1))(jnp.asarray(x),
                                                           jnp.asarray(y)))
    for value, dx, dy in ranks:
        np.testing.assert_allclose(value, ref, rtol=1e-5)
        _close_grad(dx, gx)
        _close_grad(dy, gy)
        # a gradient scaled by p (the world size) is p - 1 max|g| off
        assert not np.allclose(dx, p * gx, atol=1e-6)
        assert not np.allclose(dy, p * gy, atol=1e-6)
    # every rank holds the same bits
    for value, dx, dy in ranks[1:]:
        assert value == ranks[0][0]
        assert np.array_equal(dx, ranks[0][1])
        assert np.array_equal(dy, ranks[0][2])


# --- (4) stylize(mesh=) under shard_samples --------------------------------

def _masks():
    """Two regions: content left/right, style top/bottom (K, 40, 40, 1)."""
    cm = np.zeros((2, 40, 40, 1), np.float32)
    sm = np.zeros((2, 40, 40, 1), np.float32)
    cm[0, :, :20], cm[1, :, 20:] = 1.0, 1.0
    sm[0, :20], sm[1, 20:] = 1.0, 1.0
    return cm, sm


@pytest.fixture(scope="module")
def shard_runs():
    content, style = _images(1, 1), _images(1, 2)
    return content, style, _launch(R.shard_samples_runs, 2, content, style,
                                   _masks())


@pytest.mark.parametrize("masked,use_sinkhorn", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(False, True, id="False-sinkhorn"),
    pytest.param(True, True, id="True-sinkhorn")])
def test_shard_samples_matches_unsharded(shard_runs, params, one_thread,
                                         masked, use_sinkhorn):
    """The unsharded run takes the materialized Sinkhorn too (below the
    memory gate), as the sharded one does at every size."""
    content, style, ranks = shard_runs
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=3, log_every=3,
                                      use_sinkhorn=use_sinkhorn, **R.TINY)
    kw = {}
    if masked:
        kw = dict(zip(("content_masks", "style_masks"), _masks()))
    _, ref = strotss_torch.stylize(content, style, cfg, vgg_params=params,
                                   device="cpu", **kw)
    curve, img = ranks[0][use_sinkhorn, masked]
    np.testing.assert_allclose(curve, ref["scales"][0]["curve"], rtol=2e-4,
                               atol=1e-5)
    assert np.all(np.isfinite(img))
    # both ranks hold the same pyramid: the same image and curve, bit for bit
    assert np.array_equal(ranks[1][use_sinkhorn, masked][0], curve)
    assert np.array_equal(ranks[1][use_sinkhorn, masked][1], img)


def test_stylize_mesh_contracts():
    """The mesh contracts that remain under ``shard_samples`` with
    ``use_sinkhorn``: a 'sample' axis for ``stylize``, a 'data' axis for
    ``stylize_batch``; given those, the sample group comes back and the
    Sinkhorn takes the materialized solve at every size."""
    from strotss_torch import solve
    from strotss_torch.ops.losses import sinkhorn_route
    from strotss_torch.programs import spec_from_config

    img = np.zeros((1, 8, 8, 3), np.float32)
    cfg = strotss_torch.StrotssConfig(shard_samples=True, use_sinkhorn=True)
    with pytest.raises(ValueError, match="needs a mesh with a 'sample'"):
        strotss_torch.stylize(img, img, cfg, device="cpu",
                              mesh=_SampleMesh(("data",)))
    with pytest.raises(ValueError, match="over the mesh's 'data' axis"):
        stylize_batch(img, img, cfg, device="cpu", mesh=_SampleMesh())
    assert solve.sample_group(cfg, _SampleMesh(), "stylize", "(N,)") == (
        "sample group", None)
    for batched in (False, True):
        spec = spec_from_config(cfg, "cpu", batched=batched)
        assert spec.shard_samples and spec.remd_impl == "plain"
        assert sinkhorn_route(32769, 32769, spec.remd_impl) == "plain"


class _SampleMesh:
    """A mesh that has a 'sample' axis (the contracts read its names and
    take its groups)."""

    device_type = "cpu"

    def __init__(self, names=("sample",)):
        self.mesh_dim_names = names

    def get_rank(self):
        return 0

    def get_group(self, axis):
        return f"{axis} group"


# --- (5) stylize_batch(mesh=) ----------------------------------------------

BATCH_CFG = dict(levels=1, max_iter=3, log_every=3, **R.TINY)


@pytest.fixture(scope="module")
def batch_inputs():
    return _images(4, 11), _images(4, 12), [3, 5, 7, 9]


def test_batch_over_data_mesh_is_bitwise(batch_inputs, params, one_thread):
    contents, styles, seeds = batch_inputs
    ranks = _launch(R.batch_run, 2, contents, styles, (2,), ("data",),
                    BATCH_CFG, seeds)
    imgs, info = stylize_batch(contents, styles,
                               strotss_torch.StrotssConfig(**BATCH_CFG),
                               params, pair_seeds=seeds, device="cpu")
    for r_imgs, r_float, r_curves in ranks:
        assert np.array_equal(r_imgs, imgs.numpy())
        assert np.array_equal(r_float, info["stylized"].numpy())
        assert np.array_equal(r_curves[0], info["scales"][0]["curve"])


def _batch_over_data_sample_mesh(batch_inputs, params, **cfg_kw):
    contents, styles, seeds = batch_inputs
    ranks = _launch(R.batch_run, 4, contents, styles, (2, 2),
                    ("data", "sample"),
                    dict(BATCH_CFG, shard_samples=True, **cfg_kw), seeds)
    _, info = stylize_batch(contents, styles,
                            strotss_torch.StrotssConfig(**BATCH_CFG,
                                                        **cfg_kw),
                            params, pair_seeds=seeds, device="cpu")
    np.testing.assert_allclose(ranks[0][2][0], info["scales"][0]["curve"],
                               rtol=2e-4, atol=1e-5)
    for r in ranks[1:]:
        assert np.array_equal(r[0], ranks[0][0])
        assert np.array_equal(r[1], ranks[0][1])


def test_batch_over_data_sample_mesh(batch_inputs, params, one_thread):
    _batch_over_data_sample_mesh(batch_inputs, params)


def test_batch_over_data_sample_mesh_sinkhorn(batch_inputs, params,
                                              one_thread):
    """Each pair's Sinkhorn terms split over the 'sample' axis."""
    _batch_over_data_sample_mesh(batch_inputs, params, use_sinkhorn=True)


# --- (6) checkpoints under a mesh ------------------------------------------

def test_checkpoint_rank_zero_writes_and_resume_is_bitwise(tmp_path, params,
                                                          one_thread):
    content, style = _images(1, 21), _images(1, 22)
    contents, styles = _images(2, 23), _images(2, 24)
    ranks = _launch(R.checkpoint_runs, 2, content, style, contents, styles,
                    str(tmp_path))
    assert ranks[0]["saves"] > 0 and ranks[1]["saves"] == 0
    for name in ("single", "batch"):
        for r in ranks:
            full, resumed, full_curve, resumed_curve, at = r[name]
            assert at == (1, 2)  # stopped after scale 128's first chunk
            assert np.array_equal(resumed, full)
            assert np.array_equal(resumed_curve, full_curve[2:])
    # the batch's checkpoint holds the whole batch: it resumes without a
    # mesh, bit for bit
    d = str(tmp_path / "batch_copy")
    assert os.path.isdir(d)
    cfg = strotss_torch.StrotssConfig(levels=2, max_iter=4, log_every=2,
                                      checkpoint_dir=d, **R.TINY)
    _, info = stylize_batch(contents, styles, cfg, params, pair_seeds=[5, 9],
                            device="cpu")
    assert np.array_equal(info["stylized"].numpy(), ranks[0]["batch"][0])


# --- (7) serve --data_devices ----------------------------------------------

def test_serve_data_devices_shards_full_batches(tmp_path):
    """Mirror of ``tests/test_serve.py:330-347``: with ``--batch 2
    --data_devices 2`` on 3 jobs the first two run as one group over 2
    CPU ranks (``--allow_cpu_devices``) and the flush of one runs alone."""
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for name, hw in (("c.png", (40, 48)), ("s.png", (44, 36))):
        Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(
            tmp_path / name)
        paths.append(str(tmp_path / name))
    outs = [str(tmp_path / f"dd{i}.png") for i in range(3)]
    jp, rp = tmp_path / "jobs.jsonl", tmp_path / "results.jsonl"
    jp.write_text("".join(json.dumps({"content": paths[0], "style": paths[1],
                                      "output": o, "seed": i}) + "\n"
                          for i, o in enumerate(outs)))
    cmd = [sys.executable, "-m", "strotss_torch.serve", "--jobs", str(jp),
           "--results", str(rp), "--cpu", "--level", "1", "--max_iter", "2",
           "--taps", "block1_conv1", "--compute_dtype", "float32",
           "--sample_size", "32", "--batch", "2", "--data_devices", "2",
           "--allow_cpu_devices"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=TIMEOUT,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = [json.loads(line) for line in rp.read_text().splitlines()]
    assert [r["ok"] for r in results] == [True, True, True]
    assert [r.get("data_devices") for r in results] == [2, 2, None]
    assert [r.get("batched") for r in results] == [2, 2, None]
    assert "running the 2 ranks on the CPU" in proc.stderr
    for o in outs:
        assert os.path.exists(o)
    shutil.rmtree(tmp_path, ignore_errors=True)


def _children(pid):
    """The PIDs of ``pid``'s child processes (Linux /proc)."""
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{task}/children") as f:
            out += [int(c) for c in f.read().split()]
    return out


def test_serve_ends_nonzero_when_a_follower_dies(tmp_path):
    """A follower rank that dies ends serve with a non-zero exit code (it
    does not hang): the next full group meets the dead rank, and rank 0
    raises when it finds the follower's process gone."""
    import threading

    from PIL import Image

    rng = np.random.default_rng(1)
    paths = []
    for name in ("c.png", "s.png"):
        Image.fromarray((rng.random((40, 40, 3)) * 255).astype(np.uint8)
                        ).save(tmp_path / name)
        paths.append(str(tmp_path / name))
    cmd = [sys.executable, "-m", "strotss_torch.serve", "--jobs", "-",
           "--cpu", "--level", "1", "--max_iter", "2", "--taps",
           "block1_conv1", "--compute_dtype", "float32", "--sample_size",
           "32", "--batch", "2", "--data_devices", "2",
           "--allow_cpu_devices"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PYTHONPATH=REPO,
                                                OMP_NUM_THREADS="1"))
    ready, lines = threading.Event(), []

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if " over gloo." in line:
                ready.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        assert ready.wait(TIMEOUT), "".join(lines)[-3000:]
        followers = []
        for pid in _children(proc.pid):
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"spawn_main" in f.read():
                    followers.append(pid)
        assert len(followers) == 1
        os.kill(followers[0], 9)
        jobs = "".join(json.dumps({"content": paths[0], "style": paths[1],
                                   "output": str(tmp_path / f"o{i}.png")})
                       + "\n" for i in range(2))
        proc.stdin.write(jobs)
        proc.stdin.close()
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    assert rc != 0
    assert "RankError: rank 1 ended" in "".join(lines)


def _serve_inputs(tmp_path, n_jobs, first=None):
    """A content and a style image on disk and the jobs file of
    ``n_jobs`` jobs on them (seed i), the first updated with ``first``."""
    from PIL import Image

    rng = np.random.default_rng(2)
    paths = []
    for name, hw in (("c.png", (40, 48)), ("s.png", (44, 36))):
        Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(
            tmp_path / name)
        paths.append(str(tmp_path / name))
    jobs = [{"content": paths[0], "style": paths[1],
             "output": str(tmp_path / f"o{i}.png"), "seed": i}
            for i in range(n_jobs)]
    jobs[0].update(first or {})
    jp = tmp_path / "jobs.jsonl"
    jp.write_text("".join(json.dumps(j) + "\n" for j in jobs))
    return str(jp), str(tmp_path / "results.jsonl")


def _serve_data_devices(jp, rp):
    """serve on ``jp`` in this process, 2 CPU ranks; its results."""
    from strotss_torch import serve

    assert serve.main(["--jobs", jp, "--results", rp, "--cpu", "--level",
                       "1", "--max_iter", "2", "--taps", "block1_conv1",
                       "--compute_dtype", "float32", "--sample_size", "32",
                       "--batch", "2", "--data_devices", "2",
                       "--allow_cpu_devices"]) == 0
    with open(rp) as f:
        return [json.loads(line) for line in f]


def test_serve_single_job_outlasts_the_rank_timeout(tmp_path, monkeypatch,
                                                    one_thread):
    """A job that rank 0 runs alone for longer than the ranks' collective
    timeout keeps no follower waiting in a collective: the full group
    after it still runs over the mesh."""
    from strotss_torch import serve

    monkeypatch.setattr(serve, "_RANK_TIMEOUT", 15.0)
    run_single = serve._run_single

    def held_single(*a, **k):
        time.sleep(20.0)
        return run_single(*a, **k)

    monkeypatch.setattr(serve, "_run_single", held_single)
    # start_level opts the first job out of batching: rank 0 runs it alone
    results = _serve_data_devices(*_serve_inputs(tmp_path, 3,
                                                 {"start_level": 0}))
    assert [r["ok"] for r in results] == [True, True, True]
    assert [r.get("data_devices") for r in results] == [None, 2, 2]


def test_serve_restarts_the_ranks_after_a_failed_group(tmp_path,
                                                       monkeypatch,
                                                       one_thread):
    """A group that fails on rank 0 leaves the follower inside the group's
    collectives: serve starts fresh ranks, retries the group job by job,
    and the next full group runs over the new mesh."""
    from strotss_torch import serve

    monkeypatch.setattr(serve, "_RANK_TIMEOUT", 60.0)
    stylize_group, failed = serve._stylize_group, []

    def fail_once(args, group, vgg_params, mesh=None):
        if mesh is not None and not failed:
            failed.append(True)
            raise RuntimeError("a failure on rank 0 alone")
        return stylize_group(args, group, vgg_params, mesh)

    monkeypatch.setattr(serve, "_stylize_group", fail_once)
    results = _serve_data_devices(*_serve_inputs(tmp_path, 4))
    assert failed
    assert [r["ok"] for r in results] == [True] * 4
    assert [r.get("data_devices") for r in results] == [None, None, 2, 2]
