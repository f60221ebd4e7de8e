"""``stylize(..., StrotssConfig(shard_spatial=True), mesh=...)`` on CPU
ranks against the port's unsharded run, and with what it composes with:
masks, blended styles, ``remat``, checkpoint and resume, ``use_sinkhorn``
(the materialized solve, as at every size under sharding) and the 2-D
('spatial', 'sample') mesh, with REMD or Sinkhorn split over 'sample'.

VGG16 with its 9 taps, float32, 40x40 images (64x64 at the first scale:
slabs of 32/32 rows on 2 ranks, 16 a rank on 4, down to 1 or 2 rows at
block5). Whole runs are held to the JAX test's limits
(``tests/test_parallel.py:295-336``: curves rtol 2e-4, atol 1e-5; uint8
images within 1 level), every rank's pyramid bit for bit the others'.
A convolution on a slab may sum in another order than on the whole image
(1e-6 of max in float32), and the trajectory is chaotic: the unsharded
run itself, its content scaled by 1 + 1e-7, leaves those limits after 3
steps (2.6x the curve limit at the first scale, 97x at the second, 15
uint8 levels). So whole runs here are 2 steps a scale, or 1 step a scale
for 2 scales, and every step of a longer run is held to the unsharded
step from the same pyramid (:func:`torch_ranks.spatial_steps`): losses
to rtol 1e-5, the pyramid gradient to 1e-2 of its largest value.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import strotss_torch
import torch_ranks as R
from strotss_torch.models.weights import random_params
from strotss_torch.parallel import launch as L

TIMEOUT = 300
BASE = dict(levels=1, max_iter=2, log_every=2, sample_size=32,
            compute_dtype="float32", use_pallas=False)
TWO_SCALES = dict(BASE, levels=2, max_iter=1, log_every=1)


def _launch(fn, n, *args):
    return L.launch(fn, ["cpu"] * n, args=args, timeout=TIMEOUT, threads=1)


def _img(seed, h=40, w=40):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(
        np.float32)


def _masks():
    """Two regions: content left/right, style top/bottom (K, 40, 40, 1)."""
    cm = np.zeros((2, 40, 40, 1), np.float32)
    sm = np.zeros((2, 40, 40, 1), np.float32)
    cm[0, :, :20], cm[1, :, 20:] = 1.0, 1.0
    sm[0, :20], sm[1, 20:] = 1.0, 1.0
    return cm, sm


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return random_params("16", seed=0)


CONTENT, STYLE = _img(1), _img(2)
RUNS = {
    "plain": (BASE, {}),
    "two_scales": (TWO_SCALES, {}),
    "masked": (BASE, dict(zip(("content_masks", "style_masks"),
                              _masks()))),
    "blended": (BASE, dict(style=[_img(3), _img(4, 36, 44)],
                           style_weights=[0.7, 0.3])),
    "sinkhorn": (dict(BASE, use_sinkhorn=True), {}),
    "remat": (dict(BASE, remat=True), {}),
}
MESH_RUNS = {
    # p = 4 on a 1-D mesh, and the 2x2 ('spatial', 'sample') mesh with
    # the transport terms' style samples (REMD's or Sinkhorn's) split over
    # 'sample'
    4: ((4,), ("spatial",), ["plain", "two_scales"]),
    "2x2": ((2, 2), ("spatial", "sample"),
            ["plain", "two_scales", "sinkhorn"]),
}


@pytest.fixture(scope="module")
def runs():
    """Every run of :data:`RUNS` on 2 ranks in one launch; the runs of
    :data:`MESH_RUNS` in one launch a mesh."""
    ranks = _launch(R.spatial_runs, 2, CONTENT, STYLE, list(RUNS.values()))
    out = {2: {name: [r[k] for r in ranks] for k, name in enumerate(RUNS)}}
    for mesh, (shape, names, which) in MESH_RUNS.items():
        two_d = len(shape) == 2
        cfgs = [(dict(RUNS[w][0], shard_samples=two_d), RUNS[w][1])
                for w in which]
        ranks = _launch(R.spatial_runs, int(np.prod(shape)), CONTENT, STYLE,
                        cfgs, shape, names)
        out[mesh] = {w: [r[k] for r in ranks] for k, w in enumerate(which)}
    return out


def _unsharded(params, name):
    cfg_kw, kw = RUNS[name]
    kw = dict(kw)
    style = kw.pop("style", STYLE)
    return strotss_torch.stylize(CONTENT, style,
                                 strotss_torch.StrotssConfig(**cfg_kw),
                                 vgg_params=params, device="cpu", **kw)


def _check(ranks, params, name):
    img, info = _unsharded(params, name)
    curves, _, u8, digests = ranks[0]
    assert len(curves) == len(info["scales"])
    for curve, sc in zip(curves, info["scales"]):
        assert curve.shape == sc["curve"].shape
        np.testing.assert_allclose(curve, sc["curve"], rtol=2e-4,
                                   atol=1e-5)
    assert np.abs(u8.astype(int) - img.numpy().astype(int)).max() <= 1
    assert u8.shape == tuple(img.shape) and u8.dtype == np.uint8
    # every rank holds the same pyramid after each scale, bit for bit
    assert len(digests) == len(curves)
    for r in ranks[1:]:
        assert r[3] == digests
        assert np.array_equal(r[2], u8)


@pytest.mark.parametrize("name", list(RUNS))
def test_spatial_two_ranks_match_unsharded(runs, params, one_thread, name):
    _check(runs[2][name], params, name)


@pytest.mark.parametrize("mesh,name", [(m, w) for m, v in MESH_RUNS.items()
                                       for w in v[2]])
def test_spatial_meshes_match_unsharded(runs, params, one_thread, mesh,
                                        name):
    _check(runs[mesh][name], params, name)


def test_remat_is_the_run_without_it_bit_for_bit(runs):
    """Under ``remat`` the backward recomputes the slabs' forward, halo
    exchanges and all: the same bits as the run that keeps them."""
    for a, b in zip(runs[2]["remat"], runs[2]["plain"]):
        assert a[3] == b[3]
        assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))


@pytest.mark.parametrize("p", [2, 4])
def test_spatial_steps_match_the_unsharded_step(p):
    """Every step of a 2-scale, 3-step run on p ranks, held to the
    unsharded step from the same pyramid (this rank's replica): losses to
    rtol 1e-5, the pyramid gradient to 1e-2 of its largest value (the
    card's limit). The gradient jumps where sums 1e-6 apart flip a REMD
    argmin or a self-similarity sign, and VGG's backward spreads a jump
    over many pixels: most steps here differ by 1e-6 of max|g|, one in
    three by 2e-4 to 5e-4 (2% of the entries past 1e-4). A gradient
    scaled by p, or a wrong boundary row, is off by far more."""
    kw = dict(BASE, levels=2, max_iter=3, log_every=3)
    ranks = _launch(R.spatial_steps, p, CONTENT, STYLE, kw)
    for held in ranks:
        assert len(held) == 2 * 3
        for got, ref, grad_err in held:
            np.testing.assert_allclose(got, ref, rtol=1e-5)
            assert grad_err <= 1e-2
    assert all(np.array_equal(r[-1][0], ranks[0][-1][0]) for r in ranks)


def test_spatial_resume_is_bit_for_bit(tmp_path):
    """Stopped after the first chunk of scale 128 and resumed from the
    checkpoint (rank 0 writes it), the run ends as the uninterrupted run,
    bit for bit."""
    ranks = _launch(R.spatial_resume, 2, CONTENT, STYLE, str(tmp_path))
    assert ranks[0]["saves"] > 0 and ranks[1]["saves"] == 0
    for r in ranks:
        full, resumed, full_curve, resumed_curve, at = r["run"]
        assert at == (1, 2)
        assert np.array_equal(resumed, full)
        assert np.array_equal(resumed_curve, full_curve[2:])
    shutil.rmtree(tmp_path, ignore_errors=True)
    assert not os.path.exists(tmp_path)
