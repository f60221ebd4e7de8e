"""The rest of the port's single-pair run against the JAX package:
blended styles, warm start and ``start_level``, checkpoint and resume,
activation recompute, the snapshot cadence and the CLI's flags for them.

Tiny sizes (one tap, 32-64 samples, 40x40 images, float32), as
``tests/test_solve_extras.py``. Where the JAX package has the function
the same inputs go through both; randomness is replayed from the JAX
package's keys (``coords_source``), never drawn again. Comparisons of two
port runs bit for bit run on one thread: the CPU's multi-threaded sums
are not repeatable in their order.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch import cli as tcli
from strotss_torch.models.weights import params_from_jax
from strotss_torch.ops.image import resize_bilinear
from strotss_torch.programs import scale_seed, style_sample_counts, \
    warm_init_hw
from strotss_torch.solve import scale_mode_shapes, stylize_single
from strotss_torch.utils import checkpoint as ckpt
from strotss_tpu import programs as JP
from strotss_tpu.aot import scale_mode_shapes as jax_scale_mode_shapes
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops import sampling as JS
from strotss_tpu.ops.image import resize_bilinear as jax_resize
from strotss_tpu.solve import stylize_single as jax_stylize_single

TINY = dict(compute_dtype="float32", use_pallas=False,
            taps=("block1_conv1",))


@pytest.fixture(scope="module")
def params():
    return params_from_jax(jax.tree.map(np.asarray,
                                        jax_random_params("16", 0)))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.random((1, h, w, 3)), dtype=torch.float32)


def _cfg(**kw):
    base = dict(levels=1, max_iter=2, log_every=2, sample_size=32, **TINY)
    base.update(kw)
    return strotss_torch.StrotssConfig(**base)


# --- blended styles -------------------------------------------------------

_WEIGHTS = [
    ([1.0], 64), ([0.5, 0.5], 64), ([2.0, 1.0, 1.0], 64),
    ([0.4, 0.35, 0.25], 10), ([1.0, 0.0], 64), ([0.0, 1.0], 64),
    ([0.3, 0.3, 0.4], 1024), ([1.0] * 7, 100), ([0.7, 0.3], 1024),
    ([0.004, 0.996], 1024), ([1.0, 1.0, 1.0], 64), ([3.0, 0.0, 1.0, 0.0], 7),
    ([0.1, 0.2, 0.3, 0.4], 33), ([1e-9, 1.0], 1024), ([5.0], 1),
]


@pytest.mark.parametrize("weights,n", _WEIGHTS)
def test_style_sample_counts_match_jax(weights, n):
    got = style_sample_counts(weights, n)
    assert got == JP.style_sample_counts(weights, n)
    assert sum(got) == n


@pytest.mark.parametrize("weights", [[-1.0, 2.0], [0.0, 0.0], [],
                                     [float("nan"), 1.0],
                                     [float("inf"), 1.0], [[1.0, 2.0]]])
def test_style_sample_counts_errors_match_jax(weights):
    with pytest.raises(ValueError) as want:
        JP.style_sample_counts(weights, 64)
    with pytest.raises(ValueError) as got:
        style_sample_counts(weights, 64)
    assert str(got.value) == str(want.value)


def _jax_blend_coords(seed, n_styles):
    """The JAX package's coordinates of a blended run: per scale the style
    key split once a style (``programs.py:332``), per step the scan's
    split (``programs.py:529``)."""
    cache = {}

    def coords(i, kind, step, hw, n, style=None):
        if (i, kind, step, style) not in cache:
            key = jax.random.PRNGKey(seed)
            _, k_style, k_run = jax.random.split(jax.random.fold_in(key, i), 3)
            if kind == "style":
                k = jax.random.split(k_style, n_styles)[style]
                c = JS.full_grid_coords(k, hw, n)
            else:
                for _ in range(step + 1):
                    k_run, k_step = jax.random.split(k_run)
                c = JS.strided_grid_coords(k_step, hw, n)
            cache[(i, kind, step, style)] = torch.tensor(np.asarray(c))
        return cache[(i, kind, step, style)]

    return coords


def test_blended_run_matches_jax(params):
    """Two styles at 0.7/0.3 (45/19 of 64 samples), the JAX package's
    coordinates replayed: the 3-step curve to rtol 1e-5."""
    content, sa, sb = _img(1, 40, 48), _img(2, 44, 36), _img(3, 28, 52)
    kw = dict(levels=1, max_iter=3, log_every=3, sample_size=64, seed=5,
              **TINY)
    _, jinfo = jax_stylize_single(
        jnp.asarray(content.numpy()),
        [jnp.asarray(sa.numpy()), jnp.asarray(sb.numpy())], JaxConfig(**kw),
        jax_random_params("16", 0), style_weights=[0.7, 0.3])
    img, info = stylize_single(content, [sa, sb],
                               strotss_torch.StrotssConfig(**kw), params,
                               coords_source=_jax_blend_coords(5, 2),
                               style_weights=[0.7, 0.3])
    want = np.asarray(jinfo["scales"][0]["curve"])
    assert info["scales"][0]["curve"].shape == want.shape == (3, 3)
    np.testing.assert_allclose(info["scales"][0]["curve"], want, rtol=1e-5)
    assert tuple(img.shape) == (53, 64, 3) and img.dtype == torch.uint8


def test_blended_first_scale_seed_matches_jax():
    """The blended seed to 1e-6. The content comes at scale 0's own shape:
    the packages' bilinear upsampling differs by up to ~1.3e-6 by itself
    (held to 2e-6 in ``tests/test_torch_image.py``)."""
    content, sa, sb = _img(1, 48, 64), _img(2, 44, 36), _img(3, 28, 52)
    cfg = _cfg()
    shapes = (tuple(sa.shape), tuple(sb.shape))
    mode, chw, shw = scale_mode_shapes(cfg, content.shape, shapes, 0, 64)
    assert (mode, chw, shw) == jax_scale_mode_shapes(
        JaxConfig(levels=1), content.shape, shapes, 0, 64, False)
    assert shw == ((64, 52), (34, 64))
    _, scl_s, pyr = scale_seed(mode, chw, shw, 5, content, (sa, sb), None,
                               style_weights=(0.7, 0.3))
    _, jscl_s, jpyr = JP._scale_seed(
        mode, chw, shw, 5, jnp.asarray(content.numpy()),
        (jnp.asarray(sa.numpy()), jnp.asarray(sb.numpy())), None,
        style_weights=jnp.asarray([0.7, 0.3], jnp.float32))
    assert len(pyr) == len(jpyr) == 6
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(scl_s, jscl_s):  # each style's resize, as there
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


def test_same_style_twice_seeds_like_one():
    content, sa = _img(1, 40, 48), _img(2, 44, 36)
    _, _, one = scale_seed("first", (53, 64), (64, 52), 5, content, sa, None)
    _, _, two = scale_seed("first", (53, 64), ((64, 52), (64, 52)), 5,
                           content, (sa, sa), None, style_weights=(0.5, 0.5))
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_zero_weight_style_is_the_single_style_run(params, one_thread):
    content, sa, sb = _img(1, 40, 48), _img(2, 44, 36), _img(3, 28, 52)
    cfg = _cfg(max_iter=3, log_every=3)
    img_s, info_s = stylize_single(content, sa, cfg, params)
    img_m, info_m = stylize_single(content, [sa, sb], cfg, params,
                                   style_weights=[1.0, 0.0])
    assert torch.equal(img_m, img_s)
    np.testing.assert_array_equal(info_m["scales"][0]["curve"],
                                  info_s["scales"][0]["curve"])


def test_blended_run_draws_from_every_style(params):
    """Each kept style's draw at its own shape and count, in order."""
    content, sa, sb = _img(1, 40, 48), _img(2, 44, 36), _img(3, 28, 52)
    seen = []
    base = _jax_blend_coords(0, 2)

    def spy(i, kind, step, hw, n, *rest):
        if kind == "style":
            seen.append((hw, n) + tuple(rest))
        return base(i, kind, step, hw, n, *rest)

    _, info = stylize_single(content, [sa, sb, sa], _cfg(sample_size=64),
                             params, coords_source=spy,
                             style_weights=[0.7, 0.3, 0.0])
    assert seen == [((64, 52), 45, 0), ((34, 64), 19, 1)]
    assert np.all(np.isfinite(info["scales"][0]["curve"]))


@pytest.mark.parametrize("case", ["short_weights", "single_weights",
                                  "empty", "masks"])
def test_blend_validation_matches_jax(params, case):
    content, sa, sb = _img(1, 40, 48), _img(2, 44, 36), _img(3, 28, 52)
    args = {"short_weights": ([sa, sb], dict(style_weights=[1.0])),
            "single_weights": (sa, dict(style_weights=[1.0])),
            "empty": ([], {}),
            "masks": ([sa, sb], dict(
                style_weights=[0.5, 0.5],
                content_masks=torch.ones((1, 40, 48, 1)),
                style_masks=torch.ones((1, 44, 36, 1))))}[case]
    style, kw = args
    jstyle = ([jnp.asarray(s.numpy()) for s in style]
              if isinstance(style, list) else jnp.asarray(style.numpy()))
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    with pytest.raises(ValueError) as want:
        jax_stylize_single(jnp.asarray(content.numpy()), jstyle,
                           JaxConfig(**dataclasses.asdict(_cfg())),
                           jax_random_params("16", 0), **jkw)
    with pytest.raises(ValueError) as got:
        stylize_single(content, style, _cfg(), params, **kw)
    assert str(got.value) == str(want.value)


# --- warm start and start_level -------------------------------------------

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("blended", [False, True])
def test_scale_mode_shapes_match_jax(warm, blended):
    """Under a warm start scale 0's mode is 'mid'; under blending each
    style gets its own shape (``strotss_tpu/aot.py:90-114``)."""
    style = (((1, 720, 560, 3), (1, 600, 800, 3)) if blended
             else (1, 720, 560, 3))
    cfg = strotss_torch.StrotssConfig()
    for i, scl in enumerate(cfg.scale_sizes()):
        assert scale_mode_shapes(cfg, (1, 480, 640, 3), style, i, scl,
                                 warm) == jax_scale_mode_shapes(
            JaxConfig(), (1, 480, 640, 3), style, i, scl, warm)


@pytest.mark.parametrize("h,w,levels,start", [
    (40, 40, 2, 1), (100, 80, 4, 0), (321, 481, 4, 3), (480, 640, 4, 2),
    (37, 129, 3, 1)])
def test_warm_init_hw_matches_jax(h, w, levels, start):
    cfg = strotss_torch.StrotssConfig(levels=levels, start_level=start)
    assert warm_init_hw(h, w, cfg) == JP.warm_init_hw(
        h, w, JaxConfig(levels=levels, start_level=start))


def test_warm_first_scale_seed_matches_jax():
    """The warm seed: one direct resize of the init to scale 0's shape,
    then the 'mid' rule, as the JAX package's (``solve.py:191-203``)."""
    content, style, init = _img(1, 40, 40), _img(2, 44, 36), _img(4, 24, 20)
    cfg = _cfg()
    mode, chw, shw = scale_mode_shapes(cfg, content.shape, style.shape, 0,
                                       64, warm_start=True)
    assert mode == "mid"
    prev = resize_bilinear(init, warm_init_hw(40, 40, cfg))
    _, _, pyr = scale_seed(mode, chw, shw, 5, content, style, prev)
    jprev = jax_resize(jnp.asarray(init.numpy()),
                       JP.warm_init_hw(40, 40, JaxConfig()))
    _, _, jpyr = JP._scale_seed(mode, chw, shw, 5,
                                jnp.asarray(content.numpy()),
                                jnp.asarray(style.numpy()), jprev)
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_start_level_refine_matches_full_run_tail(params, one_thread):
    """``tests/test_solve_extras.py``'s contract: a levels=1 run is the
    full run's scale 0 bit for bit; its float result fed into a
    start_level=1 refine reproduces the full run's scale 1."""
    content, style = _img(1, 40, 40), _img(2, 96, 96)
    cfg = _cfg(levels=2, max_iter=3, log_every=3)
    img_full, info_full = stylize_single(content, style, cfg, params)
    _, info_c = stylize_single(content, style,
                               dataclasses.replace(cfg, levels=1), params)
    np.testing.assert_array_equal(info_c["scales"][0]["curve"],
                                  info_full["scales"][0]["curve"])
    img_r, info_r = stylize_single(
        content, style, dataclasses.replace(cfg, start_level=1), params,
        init_image=info_c["stylized"])
    assert [s["scale"] for s in info_r["scales"]] == [128]
    assert info_r["scales"][0]["alpha"] == info_full["scales"][1]["alpha"]
    np.testing.assert_allclose(info_r["scales"][0]["curve"],
                               info_full["scales"][1]["curve"], rtol=2e-4,
                               atol=1e-6)
    diff = (img_r.to(torch.int16) - img_full.to(torch.int16)).abs().max()
    assert int(diff) <= 1


def test_warm_start_differs_from_cold_and_ignores_init_size(params):
    content, style = _img(1, 40, 40), _img(2, 40, 40)
    init = _img(4, 24, 20)
    cold, _ = stylize_single(content, style, _cfg(), params)
    warm, info = stylize_single(content, style, _cfg(), params,
                                init_image=init)
    assert np.isfinite(info["scales"][0]["loss"])
    assert (warm.int() - cold.int()).abs().max() > 0
    pre = resize_bilinear(init, warm_init_hw(40, 40, _cfg()))
    warm2, _ = stylize_single(content, style, _cfg(), params,
                              init_image=pre)
    assert torch.equal(warm, warm2)


def test_start_level_validation_matches_jax(params):
    content = _img(1, 40, 40)
    with pytest.raises(ValueError, match="start_level") as want:
        jax_stylize_single(jnp.asarray(content.numpy()),
                           jnp.asarray(content.numpy()),
                           JaxConfig(levels=2, start_level=2),
                           jax_random_params("16", 0))
    with pytest.raises(ValueError, match="start_level") as got:
        stylize_single(content, content, _cfg(levels=2, start_level=2),
                       params)
    assert str(got.value) == str(want.value)


# --- snapshot cadence -----------------------------------------------------

def test_snapshot_cadence_survives_coarse_log_every(params):
    """``save_every=2`` under ``log_every=6`` fires at every multiple: the
    run chunks at gcd(log_every, save_every) when a snapshot consumer
    exists (``strotss_tpu/solve.py:207-226``)."""
    calls = []
    stylize_single(_img(1, 40, 40), _img(2, 40, 40),
                   _cfg(max_iter=6, log_every=6, save_every=2), params,
                   snapshot_cb=lambda scl, it, img: calls.append((scl, it)))
    assert calls == [(64, 2), (64, 4), (64, 6)]


def test_no_snapshot_cb_keeps_chunking(params):
    steps = []
    _, info = stylize_single(
        _img(1, 40, 40), _img(2, 40, 40),
        _cfg(max_iter=4, log_every=4, save_every=3), params,
        progress_cb=lambda scl, it, tot, m: steps.append(it))
    assert steps == [1, 2, 3, 4]
    assert info["scales"][0]["curve"].shape == (4, 3)


# --- checkpoint and resume ------------------------------------------------

class Interrupt(Exception):
    pass


def _stop_at(scale):
    def boom(scl, done, total, metrics):
        if scl == scale:
            raise Interrupt
    return boom


@pytest.mark.parametrize("scale", [64, 128])
def test_resume_bit_exact(params, one_thread, tmp_path, scale):
    """Interrupted after a chunk of scale ``scale`` (the checkpoint is
    saved before the callbacks run), then resumed: the image and the last
    scale's curve are the uninterrupted run's."""
    content, style = _img(1, 40, 40), _img(2, 40, 40)
    cfg = _cfg(levels=2, max_iter=4, log_every=2)
    img_full, info_full = stylize_single(content, style, cfg, params)
    d = str(tmp_path / "ckpt")
    with pytest.raises(Interrupt):
        stylize_single(content, style,
                       dataclasses.replace(cfg, checkpoint_dir=d), params,
                       progress_cb=_stop_at(scale))
    meta = ckpt.load_meta(d)
    assert (meta["scale_index"], meta["done_steps"]) == (
        [64, 128].index(scale), 2)
    img_res, info_res = stylize_single(
        content, style, dataclasses.replace(cfg, checkpoint_dir=d), params)
    assert torch.equal(img_res, img_full)
    np.testing.assert_array_equal(info_res["scales"][-1]["curve"][-2:],
                                  info_full["scales"][-1]["curve"][-2:])
    assert len(info_res["scales"]) == (2 if scale == 64 else 1)


def test_resume_on_a_completed_scale_boundary(params, one_thread, tmp_path):
    """A checkpoint at the end of scale 0: the resume runs no step there,
    hands the saved images on, and ends bit for bit as the full run."""
    content, style = _img(1, 40, 40), _img(2, 40, 40)
    cfg = _cfg(levels=2, max_iter=4, log_every=4)
    img_full, _ = stylize_single(content, style, cfg, params)
    d = str(tmp_path / "ckpt")
    with pytest.raises(Interrupt):
        stylize_single(content, style,
                       dataclasses.replace(cfg, checkpoint_dir=d), params,
                       progress_cb=_stop_at(64))
    assert ckpt.load_meta(d)["done_steps"] == 4
    assert set(ckpt.restore_extras(d)) == {"stylized", "image_u8"}
    img_res, info = stylize_single(
        content, style, dataclasses.replace(cfg, checkpoint_dir=d), params)
    assert info["scales"][0]["curve"].shape == (0, 3)
    assert torch.equal(img_res, img_full)


def test_resume_config_fingerprint_guard(params, tmp_path):
    content, style = _img(1, 40, 40), _img(2, 40, 40)
    d = str(tmp_path / "ckpt")
    stylize_single(content, style, _cfg(checkpoint_dir=d), params)
    with pytest.raises(ValueError, match="different run configuration"):
        stylize_single(content, style,
                       _cfg(checkpoint_dir=d, pyramid_levels=3), params)
    with pytest.raises(ValueError, match="different run configuration"):
        stylize_single(_img(3, 44, 40), style, _cfg(checkpoint_dir=d),
                       params)


def test_blended_checkpoint_refused_by_single_style_run(params, tmp_path):
    content, sa, sb = _img(1, 40, 48), _img(2, 44, 36), _img(3, 28, 52)
    d = str(tmp_path / "ckpt")
    stylize_single(content, [sa, sb], _cfg(checkpoint_dir=d), params,
                   style_weights=[0.5, 0.5])
    with pytest.raises(ValueError, match="style_ns"):
        stylize_single(content, sa, _cfg(checkpoint_dir=d), params)


@pytest.mark.parametrize("with_fingerprint", [True, False])
def test_jax_package_checkpoint_refused(params, tmp_path, with_fingerprint):
    """A checkpoint that the JAX package's ``save_state`` wrote, with the
    fingerprint of this very run but for the package, or with none (the
    JAX package's legacy form), is refused and never restored."""
    from strotss_tpu.utils import checkpoint as jckpt

    content, style = _img(1, 40, 40), _img(2, 40, 40)
    own = str(tmp_path / "own")
    stylize_single(content, style, _cfg(checkpoint_dir=own), params)
    fp = ckpt.load_meta(own)["fingerprint"]
    fp.pop("package")
    d = str(tmp_path / "jax")
    pyr = tuple(np.zeros((1, 4, 4, 3), np.float32) for _ in range(5))
    jckpt.save_state(d, 0, 2, 16.0, pyr, {"nu": pyr},
                     np.zeros((2,), np.uint32),
                     fingerprint=fp if with_fingerprint else None)
    with pytest.raises(ValueError, match="different run configuration"
                       ".*package" if with_fingerprint else
                       "different run configuration"):
        stylize_single(content, style, _cfg(checkpoint_dir=d), params)


def test_restore_structure_digest_guard(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"a": torch.zeros((4, 4)), "b": torch.ones((2,)),
             "rng": torch.zeros((16,), dtype=torch.uint8)}
    ckpt.save_state(d, 0, 1, 1.0, state)
    bad = dict(state, a=torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_state(d, bad)
    out = ckpt.restore_state(d, state)
    assert all(torch.equal(out[k], state[k]) for k in state)
    assert out["rng"].dtype == torch.uint8


def test_corrupt_checkpoint_raises_cleanly(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "state.npz").write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="Corrupt or unreadable"):
        ckpt.restore_state(str(d), {"a": torch.zeros(2)})


def test_torn_sidecar_meta_is_ignored(tmp_path):
    d = str(tmp_path / "ck")
    state = {"pyramid.0": torch.zeros((1, 4, 4, 3))}
    ckpt.save_state(d, 0, 100, 1.0, state)
    stale = str(tmp_path / "stale.json")
    shutil.copy(os.path.join(d, "state.json"), stale)
    ckpt.save_state(d, 1, 200, 1.0, state)
    shutil.copy(stale, os.path.join(d, "state.json"))
    meta = ckpt.load_meta(d)
    assert meta["scale_index"] == 1 and meta["done_steps"] == 200


def test_sidecar_only_meta_still_loads(tmp_path):
    import json

    d = tmp_path / "ck"
    d.mkdir()
    np.savez(str(d / "state.npz"), leaf_a=np.zeros((2,), np.float32))
    with open(d / "state.json", "w") as f:
        json.dump({"scale_index": 2, "done_steps": 50}, f)
    meta = ckpt.load_meta(str(d))
    assert meta["scale_index"] == 2 and meta["done_steps"] == 50
    assert torch.equal(ckpt.restore_state(str(d), {"a": torch.ones(2)})["a"],
                       torch.zeros(2))


# --- activation recompute -------------------------------------------------

def test_remat_is_numerically_exact(params):
    content, style = _img(1, 40, 40), _img(2, 40, 40)
    cfg = _cfg(max_iter=3, log_every=3)
    img, info = stylize_single(content, style, cfg, params)
    img_r, info_r = stylize_single(content, style,
                                   dataclasses.replace(cfg, remat=True),
                                   params)
    np.testing.assert_allclose(info_r["scales"][0]["curve"],
                               info["scales"][0]["curve"], rtol=1e-6,
                               atol=1e-8)
    assert int((img_r.int() - img.int()).abs().max()) <= 1


def test_remat_recomputes_block1_forward(params, monkeypatch):
    """Under ``remat`` the fused block1 route's forward runs again in the
    backward pass, so it runs twice a step (on the CPU its plain version,
    which K3a replaces on the card), plus once for the content and once
    for the style."""
    from strotss_torch.ops.kernels import block1

    calls = []
    plain = block1.block1_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(block1, "block1_plain", counted)
    content, style = _img(1, 40, 40), _img(2, 40, 40)
    cfg = _cfg(max_iter=3, log_every=3, compute_dtype="bfloat16",
               block1_impl="pallas", taps=("block1_conv1", "block1_conv2"))
    got = []
    for remat in (False, True):
        calls.clear()
        _, info = stylize_single(content, style,
                                 dataclasses.replace(cfg, remat=remat),
                                 params)
        got.append(len(calls))
        assert np.all(np.isfinite(info["scales"][0]["curve"]))
    assert got == [3 + 2, 2 * 3 + 2]


# --- the CLI's flags ------------------------------------------------------

_CLI = ["--cpu", "--max_iter", "2", "--taps", "block1_conv1",
        "--compute_dtype", "float32", "--sample_size", "64", "--max_size",
        "48"]


@pytest.fixture
def pngs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name, shape in (("c.png", (40, 48, 3)), ("s.png", (36, 52, 3)),
                        ("s2.png", (44, 36, 3)), ("s3.png", (30, 40, 3))):
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            tmp_path / name)
    return tmp_path


@pytest.fixture
def calls(monkeypatch):
    """Each stylize_single call the CLI makes: (args, kwargs, info)."""
    import strotss_torch.api as api

    seen = []
    real = api.stylize_single

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, kw, out[1]))
        return out

    monkeypatch.setattr(api, "stylize_single", spy)
    return seen


def _main(d, *flags, level=1, out="out.jpg"):
    return tcli.main([str(d / "c.png"), str(d / "s.png"), "-o",
                      str(d / out), "--level", str(level)] + _CLI
                     + [str(d / f) if f.endswith(".png") else f
                        for f in flags])


def test_cli_styles_with_weights(pngs, calls, caplog):
    caplog.set_level("INFO")
    assert _main(pngs, "--styles", "s2.png", "s3.png", "--style_weights",
                 "0.5", "0.3", "0.2") == 0
    (args, kw, info), = calls
    assert len(args[1]) == 3 and kw["style_weights"] == [0.5, 0.3, 0.2]
    assert "Blending styles" in caplog.text
    assert (pngs / "out.jpg").exists()


def test_cli_style2_with_blend(pngs, calls, caplog):
    caplog.set_level("INFO")
    assert _main(pngs, "--style2", "s2.png", "--style_blend", "0.25") == 0
    (args, kw, info), = calls
    assert len(args[1]) == 2 and kw["style_weights"] == [0.75, 0.25]
    assert "(0.75) +" in caplog.text


@pytest.mark.parametrize("flags,match", [
    (["--style_blend", "0.3"], "requires --style2"),
    (["--style2", "s2.png", "--style_blend", "1.5"], r"in \[0, 1\]"),
    (["--styles", "s2.png", "--style2", "s3.png"], "mutually exclusive"),
    (["--style_weights", "1", "2"], "requires --styles"),
    (["--styles", "s2.png", "--style_weights", "1"], "needs 2 numbers"),
])
def test_cli_blend_flag_errors(pngs, flags, match):
    with pytest.raises(ValueError, match=match):
        _main(pngs, *flags)


def test_cli_init_with_start_level(pngs, calls):
    assert _main(pngs, "--init", "c.png", "--start_level", "1",
                 level=2) == 0
    (args, kw, info), = calls
    assert args[2].start_level == 1 and kw["init_image"] is not None
    assert [s["scale"] for s in info["scales"]] == [128]


def test_cli_checkpoint_dir_twice_resumes(pngs, calls):
    ck = str(pngs / "ck")
    assert _main(pngs, "--checkpoint_dir", ck, out="a.jpg") == 0
    assert _main(pngs, "--checkpoint_dir", ck, out="b.jpg") == 0
    assert calls[0][2]["scales"][0]["curve"].shape == (2, 3)
    # the second run found the first one's last chunk and ran no step
    assert calls[1][2]["scales"][0]["curve"].shape == (0, 3)
    assert (pngs / "a.jpg").read_bytes() == (pngs / "b.jpg").read_bytes()


def test_cli_remat(pngs, calls):
    assert _main(pngs, "--remat") == 0
    (args, kw, info), = calls
    assert args[2].remat
    assert np.all(np.isfinite(info["scales"][0]["curve"]))


def test_cli_profile_dir_writes_a_trace(pngs):
    import json

    prof = pngs / "prof"
    assert _main(pngs, "--profile_dir", str(prof)) == 0
    (trace,) = list(prof.iterdir())
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    # the program's spans on their own track, on the profiler's clock: a
    # step's convolution lies inside its step.vgg span
    vgg = [e for e in events if e.get("name") == "step.vgg"]
    assert vgg and {(e["ph"], e["tid"]) for e in vgg} == {("X", 0)}
    convs = [e for e in events if e.get("name") == "aten::conv2d"]
    assert any(v["ts"] <= c["ts"] and c["ts"] + c["dur"] <= v["ts"] + v["dur"]
               for v in vgg for c in convs)


def test_run_leaves_the_precision_switches_as_found(params):
    """A run sets full float32 matmuls for itself and puts every switch it
    set back: a later computation in the process (another test in the
    same worker) sees the state it had before."""
    b = torch.backends

    def state():
        return (torch.get_float32_matmul_precision(),
                b.mkldnn.matmul.fp32_precision,
                b.cuda.matmul.fp32_precision, b.cudnn.allow_tf32)

    before = state()
    torch.set_float32_matmul_precision("high")
    b.cudnn.allow_tf32 = True
    try:
        set_by_test = state()
        stylize_single(_img(1, 40, 40), _img(2, 40, 40), _cfg(), params)
        assert state() == set_by_test
    finally:
        torch.set_float32_matmul_precision(before[0])
        b.mkldnn.matmul.fp32_precision = before[1]
        b.cuda.matmul.fp32_precision = before[2]
        b.cudnn.allow_tf32 = before[3]
    assert state() == before
