"""The port's batched pairs (``strotss_torch.parallel.stylize_batch``)
against the JAX package's ``stylize_batch`` and against the port's own
single runs, and VGG block1 over an image axis.

Tiny sizes (one tap, 32 samples, 40x40 images, float32). Against JAX the
per-pair coordinates are replayed from the JAX package's keys
(``coords_source``) and the losses held to rtol 1e-4, as
``tests/test_torch_step.py`` holds a single run. Against the port's
single runs each pair draws from its own seed's generators: curves to
rtol 1e-5 and images within one uint8 step (the contract of
``tests/test_parallel.py:109-151``; VGG on a batch sums in another order
than on one image). Bitwise comparisons of two port runs run on one
thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch.models import vgg as TV
from strotss_torch.models.weights import params_from_jax
from strotss_torch.ops.kernels import block1 as B
from strotss_torch.parallel import stylize_batch
from strotss_torch.parallel.batch import pair_seed
from strotss_torch.programs import spec_from_config
from strotss_torch.solve import stylize_single
from strotss_torch.utils import checkpoint as ckpt
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops import sampling as JS
from strotss_tpu.ops.kernels.block1 import block1_pallas
from strotss_tpu.parallel.batch import stylize_batch as jax_stylize_batch
from test_torch_block1 import _args, _rel_err, _weights

TINY = dict(sample_size=32, compute_dtype="float32", use_pallas=False,
            taps=("block1_conv1",))


@pytest.fixture(scope="module")
def jparams():
    return jax_random_params("16", 0)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imgs(seed, b, h=40, w=40):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(
        np.float32)


def _masks(b):
    """(B, 2, 40, 40, 1) stacks: content left/right, style top/bottom."""
    cm = np.zeros((b, 2, 40, 40, 1), np.float32)
    sm = np.zeros((b, 2, 40, 40, 1), np.float32)
    cm[:, 0, :, :20], cm[:, 1, :, 20:] = 1.0, 1.0
    sm[:, 0, :20, :], sm[:, 1, 20:, :] = 1.0, 1.0
    return cm, sm


def _jax_batch_coords(pair_keys, cm=None, sm=None):
    """The JAX package's per-pair coordinates: pair b's key chained over
    the scales (``batch.py:449-456``, ``solve.py:345``), its style draws
    from ``k_style`` and one ``split`` of ``k_run`` a step
    (``batch.py:207-212``); under masks ``split`` over all K regions
    (``programs.py:274,665``), each under its region's prepared mask."""
    cache = {}

    def coords(b, i, kind, step, hw, n, region=None):
        at = (b, i, kind, step, region)
        if at not in cache:
            key = pair_keys[b]
            for j in range(i + 1):
                key, k_style, k_run = jax.random.split(
                    jax.random.fold_in(key, j), 3)
            raw = sm if kind == "style" else cm
            mask = (None if region is None
                    else JS.prepare_mask(jnp.asarray(raw[b, region]), hw))
            if kind == "style":
                k = k_style
            else:
                for _ in range(step + 1):
                    k_run, k = jax.random.split(k_run)
            if region is not None:
                k = jax.random.split(k, raw.shape[1])[region]
            draw = (JS.full_grid_coords if kind == "style"
                    else JS.strided_grid_coords)
            cache[at] = torch.tensor(np.asarray(draw(k, hw, n, mask)))
        return cache[at]

    return coords


@pytest.mark.parametrize("masked", [None, [[1, 1], [1, 0]],
                                    [[1, 1], [0, 0]]])
def test_batch_matches_jax(jparams, params, masked):
    """B = 2, 2 scales x 3 steps, per-pair alphas and keys, the JAX
    coordinates replayed: every pair's curve to rtol 1e-4. Masked: pair 1
    has one real region, its second padded with ``region_valid`` 0; or no
    region at all (its rows are 0 and its pyramid does not move)."""
    contents, styles = _imgs(1, 2), _imgs(2, 2)
    kw = dict(levels=2, max_iter=3, log_every=3, **TINY)
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(11)]
    alphas = [1.0, 4.0]
    mk = {}
    cm = sm = None
    if masked:
        cm, sm = _masks(2)
        valid = np.array(masked, np.float32)
        mk = dict(content_masks=cm, style_masks=sm, region_valid=valid)
    _, jinfo = jax_stylize_batch(
        jnp.asarray(contents), jnp.asarray(styles),
        JaxConfig(precompile=False, **kw), jparams, alphas=alphas,
        pair_keys=keys, **{k: jnp.asarray(v) for k, v in mk.items()})
    img, info = stylize_batch(
        contents, styles, strotss_torch.StrotssConfig(**kw), params,
        alphas=alphas, pair_seeds=[3, 11],
        coords_source=_jax_batch_coords(keys, cm, sm), device="cpu", **mk)
    assert info["batch"] == 2 and img.shape == (2, 128, 128, 3)
    for sc in range(2):
        want = np.asarray(jinfo["scales"][sc]["curve"])
        got = info["scales"][sc]["curve"]
        assert got.shape == want.shape == (3, 2, 3)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   err_msg=f"scale {sc}")
        assert info["scales"][sc]["alpha"] == jinfo["scales"][sc]["alpha"]
        np.testing.assert_allclose(info["scales"][sc]["loss"],
                                   jinfo["scales"][sc]["loss"], rtol=1e-4)


def _single(params, cfg, content, style, seed, alpha, **kw):
    return stylize_single(torch.tensor(content[None]),
                          torch.tensor(style[None]),
                          dataclasses.replace(cfg, seed=seed, alpha=alpha),
                          params, **kw)


@pytest.mark.parametrize("case", ["cold", "warm", "masked"])
def test_batch_matches_port_singles(params, case):
    """B = 3 with seeds and alphas of their own: pair b is the port's
    single run with ``seed=pair_seeds[b]``, ``alpha=alphas[b]``. Warm:
    per-pair inits of another shape than the contents. Masked: pair 1 runs
    only its region 1 (``region_valid`` [0, 1]), pair 2 only region 0."""
    contents, styles = _imgs(3, 3), _imgs(4, 3)
    cfg = strotss_torch.StrotssConfig(levels=2, max_iter=3, log_every=3,
                                      **TINY)
    seeds, alphas = [5, 17, 2 ** 40 + 3], [1.0, 4.0, 0.5]
    kw, single_kw = {}, [{} for _ in range(3)]
    if case == "warm":
        inits = _imgs(5, 3, 56, 64)
        kw = dict(init_images=inits)
        single_kw = [dict(init_image=torch.tensor(x[None])) for x in inits]
    if case == "masked":
        cm, sm = _masks(3)
        valid = np.array([[1, 1], [0, 1], [1, 0]], np.float32)
        kw = dict(content_masks=cm, style_masks=sm, region_valid=valid)
        single_kw = [dict(content_masks=torch.tensor(cm[b][valid[b] > 0]),
                          style_masks=torch.tensor(sm[b][valid[b] > 0]))
                     for b in range(3)]
    img, info = stylize_batch(contents, styles, cfg, params, alphas=alphas,
                              pair_seeds=seeds, device="cpu", **kw)
    assert info["scales"][0]["alpha"] == [16.0, 64.0, 8.0]
    for b in range(3):
        one, sinfo = _single(params, cfg, contents[b], styles[b], seeds[b],
                             alphas[b], **single_kw[b])
        for sc in range(2):
            np.testing.assert_allclose(
                info["scales"][sc]["curve"][:, b],
                sinfo["scales"][sc]["curve"], rtol=1e-5, atol=1e-7,
                err_msg=f"pair {b} scale {sc}")
        diff = (img[b].int() - one.int()).abs().max()
        assert diff <= 1, f"pair {b}: images {int(diff)} steps apart"
    assert info["stylized"].shape == (3, 128, 128, 3)


def test_default_pair_seeds_are_distinct_streams(params):
    """Without ``pair_seeds`` pair b draws from ``pair_seed(cfg.seed, b)``:
    the same pair twice in a batch gets two trajectories, and pair 1 is
    the single run with that seed."""
    contents = np.repeat(_imgs(6, 1), 2, axis=0)
    styles = np.repeat(_imgs(7, 1), 2, axis=0)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=2, log_every=2,
                                      seed=9, **TINY)
    _, info = stylize_batch(contents, styles, cfg, params, device="cpu")
    curve = info["scales"][0]["curve"]
    assert len({pair_seed(9, b) for b in range(8)}) == 8
    assert not np.allclose(curve[:, 0], curve[:, 1])
    _, sinfo = _single(params, cfg, contents[1], styles[1], pair_seed(9, 1),
                       cfg.alpha)
    np.testing.assert_allclose(curve[:, 1], sinfo["scales"][0]["curve"],
                               rtol=1e-5)


_C, _S = _imgs(8, 2), _imgs(9, 2)
_BAD = {
    "batch mismatch": dict(styles=_imgs(9, 3)),
    "init_images batch": dict(init_images=_imgs(10, 3)),
    "init_images rank": dict(init_images=_imgs(10, 2)[0]),
    "alphas shape": dict(alphas=[1.0, 2.0, 3.0]),
    "alphas finite": dict(alphas=[1.0, np.nan]),
    "region_valid shape": dict(content_masks=_masks(2)[0],
                               style_masks=_masks(2)[1],
                               region_valid=np.ones((2, 3), np.float32)),
    "region_valid alone": dict(region_valid=np.ones((2, 2), np.float32)),
    "mask batch": dict(content_masks=_masks(3)[0],
                       style_masks=_masks(3)[1]),
    "contents rank": dict(contents=_C[0]),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_errors_match_jax(jparams, params, case):
    """Each refusal raises the JAX package's ValueError, word for word."""
    kw = {"contents": _C, "styles": _S, **_BAD[case]}
    cfg_kw = dict(levels=1, max_iter=1, **TINY)
    with pytest.raises(ValueError) as want:
        jax_stylize_batch(cfg=JaxConfig(**cfg_kw), vgg_params=jparams,
                          **{k: jnp.asarray(v) if k != "alphas" else v
                             for k, v in kw.items()})
    with pytest.raises(ValueError) as got:
        stylize_batch(cfg=strotss_torch.StrotssConfig(**cfg_kw),
                      vgg_params=params, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seeds", [7, [1, 2, 3], [[1, 2], [3, 4]]])
def test_pair_seeds_shape_refused(params, seeds):
    """One seed where a batch needs one a pair (or a stack of the wrong
    shape) is refused at the boundary, as the JAX package refuses
    ``pair_keys`` of the wrong shape."""
    with pytest.raises(ValueError, match=r"pair_seeds must be 2 per-pair "
                       r"seeds \(shape \(2,\)\)"):
        stylize_batch(_C, _S, strotss_torch.StrotssConfig(**TINY), params,
                      pair_seeds=seeds, device="cpu")


def test_shard_spatial_raises_the_jax_error(jparams, params):
    kw = dict(levels=1, max_iter=1, shard_spatial=True, **TINY)
    with pytest.raises(ValueError) as want:
        jax_stylize_batch(jnp.asarray(_C), jnp.asarray(_S), JaxConfig(**kw),
                          jparams)
    with pytest.raises(ValueError) as got:
        stylize_batch(_C, _S, strotss_torch.StrotssConfig(**kw), params,
                      device="cpu")
    assert str(got.value) == str(want.value)


class _Mesh:
    """What the batch's mesh contracts read of a mesh: its axes' names
    and sizes."""

    def __init__(self, names, size):
        self.mesh_dim_names, self._size = names, size

    def size(self, dim):
        return self._size


@pytest.mark.parametrize("what", ["mesh", "shard_samples", "indivisible"])
def test_multi_device_options_are_unported(params, jparams, what):
    """The mesh contracts of ``strotss_tpu/parallel/batch.py:303-321``: a
    mesh without a 'data' axis and ``shard_samples`` without a 'sample'
    axis are refused with the JAX package's errors, and a batch that the
    'data' axis does not divide (JAX fails inside ``NamedSharding``)
    with the port's own."""
    from strotss_tpu.parallel.mesh import make_mesh as jax_make_mesh

    cfg = strotss_torch.StrotssConfig(shard_samples=what == "shard_samples",
                                      **TINY)
    if what == "indivisible":
        with pytest.raises(ValueError, match=r"splits the 2 pairs over the "
                           r"mesh's 'data' axis of size 3"):
            stylize_batch(_C, _S, cfg, params, device="cpu",
                          mesh=_Mesh(("data",), 3))
        return
    jmesh = (jax_make_mesh((8,), ("sample",), devices=jax.devices("cpu")[:8])
             if what == "mesh" else None)
    with pytest.raises(ValueError) as want:
        jax_stylize_batch(jnp.asarray(_C), jnp.asarray(_S),
                          JaxConfig(**dict(TINY, shard_samples=cfg
                                           .shard_samples)),
                          jparams, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        stylize_batch(_C, _S, cfg, params, device="cpu",
                      mesh=_Mesh(("sample",), 8) if what == "mesh" else None)
    assert str(got.value) == str(want.value)


class Interrupt(Exception):
    pass


def _stop_at(scale):
    def boom(scl, done, total, metrics):
        if scl == scale:
            raise Interrupt
    return boom


@pytest.mark.parametrize("masked", [False, True])
def test_resume_bit_exact(params, one_thread, tmp_path, masked):
    """Interrupted after the first chunk of scale 128, then resumed: the
    images and the last scale's curve are the uninterrupted run's, bit for
    bit; a resume with other ``pair_seeds`` is refused."""
    cfg = strotss_torch.StrotssConfig(levels=2, max_iter=4, log_every=2,
                                      **TINY)
    kw = dict(alphas=[1.0, 2.0], pair_seeds=[4, 8], device="cpu")
    if masked:
        cm, sm = _masks(2)
        kw.update(content_masks=cm, style_masks=sm,
                  region_valid=np.array([[1, 1], [1, 0]], np.float32))
    img_full, info_full = stylize_batch(_C, _S, cfg, params, **kw)
    d = str(tmp_path / "ckpt")
    run = dataclasses.replace(cfg, checkpoint_dir=d)
    with pytest.raises(Interrupt):
        stylize_batch(_C, _S, run, params, progress_cb=_stop_at(128), **kw)
    meta = ckpt.load_meta(d)
    assert (meta["scale_index"], meta["done_steps"]) == (1, 2)
    assert meta["alpha"] == [8.0, 16.0]
    img_res, info_res = stylize_batch(_C, _S, run, params, **kw)
    assert torch.equal(img_res, img_full)
    assert torch.equal(info_res["stylized"], info_full["stylized"])
    np.testing.assert_array_equal(info_res["scales"][-1]["curve"][-2:],
                                  info_full["scales"][-1]["curve"][-2:])
    assert len(info_res["scales"]) == 1
    with pytest.raises(ValueError, match="pair_seeds"):
        stylize_batch(_C, _S, run, params, **dict(kw, pair_seeds=[4, 9]))


def test_progress_reports_the_batch_mean(params):
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=4, log_every=2,
                                      **TINY)
    seen = []
    _, info = stylize_batch(_C, _S, cfg, params, device="cpu",
                            progress_cb=lambda *a: seen.append(a))
    assert [a[1] for a in seen] == [1, 2, 3, 4]
    mean = info["scales"][0]["curve"].mean(axis=1)
    np.testing.assert_allclose([a[3]["loss"] for a in seen], mean[:, 0],
                               rtol=1e-6)
    assert info["scales"][0]["loss"] == pytest.approx(float(mean[-1, 0]))


def test_batched_sinkhorn_takes_the_plain_route():
    """A batched Sinkhorn run is materialized at every N (the JAX
    package's batched route); without Sinkhorn REMD keeps 'auto'."""
    big = strotss_torch.StrotssConfig(use_sinkhorn=True, sample_size=32769)
    assert spec_from_config(big, "cuda", batched=True).remd_impl == "plain"
    assert spec_from_config(big, "cuda").remd_impl == "auto"
    spec = spec_from_config(strotss_torch.StrotssConfig(), "cuda",
                            batched=True)
    assert (spec.remd_impl, spec.selfsim_impl, spec.block1_impl) == (
        "auto", "auto", "pallas")


# --- VGG block1 over an image axis ----------------------------------------

@pytest.mark.parametrize("shape", [(13, 11), (5, 7)])
def test_batched_block1_plain_matches_per_image_and_jax(shape):
    """block1_plain and block1_bwd_plain on (3, H, W, .) against one call
    an image and against the JAX package's ``block1_pallas`` (interpret
    mode) an image: taps to 1e-5 of their largest value; dx to 1e-5 of its
    largest against JAX (the test_torch_block1 limit) and to 1e-3 of it
    against the per-image call (batched convolutions on the CPU sum in
    another order, and a bf16 rounding of dy1 that the order moves changes
    one operand by 2^-8)."""
    h, w = shape
    rng = np.random.default_rng(h * 7 + w)
    x = rng.standard_normal((3, h, w, 3)).astype(np.float32)
    g1 = rng.standard_normal((3, h, w, 64)).astype(np.float32)
    g2 = rng.standard_normal((3, h, w, 64)).astype(np.float32)
    hwio = _weights(h + w)
    k1, b1, k2, b2 = _args(params_from_jax(hwio))
    t1, t2 = B.block1_plain(torch.tensor(x), k1, b1, k2, b2)
    dx = B.block1_bwd_plain(t1, t2, torch.tensor(g1), torch.tensor(g2),
                            k1, k2)
    assert t1.shape == t2.shape == (3, h, w, 64) and dx.shape == (3, h, w, 3)
    for i in range(3):
        o1, o2 = B.block1_plain(torch.tensor(x[i]), k1, b1, k2, b2)
        assert _rel_err(t1[i], o1) <= 1e-5 and _rel_err(t2[i], o2) <= 1e-5
        odx = B.block1_bwd_plain(t1[i], t2[i], torch.tensor(g1[i]),
                                 torch.tensor(g2[i]), k1, k2)
        assert _rel_err(dx[i], odx) <= 1e-3
        (j1, j2), vjp = jax.vjp(
            lambda v: block1_pallas(v, *map(jnp.asarray, _args(hwio)), 4,
                                    jnp.bfloat16, True), jnp.asarray(x[i]))
        (jdx,) = vjp((jnp.asarray(g1[i]), jnp.asarray(g2[i])))
        assert _rel_err(t1[i], j1) <= 1e-5 and _rel_err(t2[i], j2) <= 1e-5
        jdx_own = B.block1_bwd_plain(torch.tensor(np.asarray(j1)),
                                     torch.tensor(np.asarray(j2)),
                                     torch.tensor(g1[i]),
                                     torch.tensor(g2[i]), k1, k2)
        assert _rel_err(jdx_own, jdx) <= 1e-5


def test_vgg_batch_takes_the_fused_route(params, monkeypatch):
    """``vgg_apply`` with B = 2 and ``block1_impl='pallas'`` on the CPU:
    one call of the fused plain version for both images (no F.conv2d for
    block1), each image's taps those of a one-image call."""
    calls = []
    real = B.block1_plain

    def spy(x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(x, *a, **kw)

    monkeypatch.setattr(B, "block1_plain", spy)
    x = torch.tensor(_imgs(11, 2, 24, 20))
    taps = ("block1_conv1", "block1_conv2", "block2_conv1")
    out = TV.vgg_apply(params, x, taps, compute_dtype="bfloat16",
                       block1_impl="pallas")
    assert calls == [(2, 24, 20, 3)]
    assert [tuple(t.shape) for t in out] == [(2, 24, 20, 64),
                                              (2, 24, 20, 64),
                                              (2, 12, 10, 128)]
    for i in range(2):
        one = TV.vgg_apply(params, x[i:i + 1], taps,
                           compute_dtype="bfloat16", block1_impl="pallas")
        for a, b in zip(out, one):
            assert _rel_err(a[i].float(), b[0].float()) <= 1e-2
        assert _rel_err(out[0][i], one[0][0]) <= 1e-5
