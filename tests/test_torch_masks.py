"""Region masks in the port against the JAX package: loading and
partition, mask preparation, masked coordinates, validation, the masked
step and the masked CLI run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import strotss_torch
from strotss_torch import cli as tcli
from strotss_torch.models.weights import params_from_jax, random_params
from strotss_torch.ops import losses as TL
from strotss_torch.ops import masks as TM
from strotss_torch.ops import sampling as TS
from strotss_torch.programs import spec_from_config
from strotss_torch.solve import stylize_single
from strotss_torch.validation import check_masks
from strotss_tpu.config import StrotssConfig as JaxConfig
from strotss_tpu.models.weights import random_params as jax_random_params
from strotss_tpu.ops import masks as JM
from strotss_tpu.ops import sampling as JS
from strotss_tpu.solve import stylize_single as jax_stylize_single
from strotss_tpu.validation import check_masks as jax_check_masks

RED, GREEN, BLUE = (255, 0, 0), (0, 255, 0), (0, 0, 255)


def _two_colour(h, w, split, axis, soft=0):
    """(h, w, 3) uint8: RED before ``split`` along ``axis``, GREEN after;
    ``soft`` > 0 blends a ramp of that width across the edge (an
    anti-aliased boundary)."""
    pos = np.arange(h if axis == 0 else w, dtype=np.float64)
    t = np.clip((pos - split) / soft + 0.5, 0, 1) if soft else (
        pos >= split).astype(np.float64)
    t = t[:, None] if axis == 0 else t[None, :]
    t = np.broadcast_to(t, (h, w))[..., None]
    img = (1 - t) * np.array(RED) + t * np.array(GREEN)
    return np.round(img).astype(np.uint8)


def _save(tmp_path, name, arr):
    path = str(tmp_path / name)
    Image.fromarray(arr).save(path)
    return path


def _equal(port, ref):
    for t, j in zip(port, ref):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("max_size,soft", [(None, 0), (None, 7), (256, 0),
                                           (256, 9), (203, 13), (512, 5)])
def test_load_mask_matches_jax(tmp_path, max_size, soft):
    """Both regions survive; under max_size the resized float is
    floor-quantized, so anti-aliased edge pixels below 255 drop out."""
    c = _save(tmp_path, "c.png", _two_colour(400, 360, 200, 0, soft))
    s = _save(tmp_path, "s.png", _two_colour(300, 330, 165, 1, soft))
    got = TM.load_mask(c, s, max_size=max_size)
    want = JM.load_mask(c, s, max_size=max_size)
    _equal(got, want)
    assert got[0].shape[0] == 2


def test_load_mask_counts_pixels_after_the_resize(tmp_path):
    """192 x 160 regions of 15360 px each shrink to 9375 px at 150 px: no
    region is left, on either side."""
    c = _save(tmp_path, "c.png", _two_colour(192, 160, 96, 0))
    s = _save(tmp_path, "s.png", _two_colour(180, 200, 100, 1))
    assert TM.load_mask(c, s)[0].shape[0] == 2
    for fn in (TM.load_mask, JM.load_mask):
        with pytest.raises(Exception, match="No mask found"):
            fn(c, s, max_size=150)


@pytest.mark.parametrize("count,regions", [(9999, 1), (10000, 2)])
def test_partition_threshold_matches_jax(count, regions):
    """A colour needs 10000 content pixels; the style side needs any."""
    c = np.zeros((150, 150, 3), np.uint8)
    c[...] = RED
    c.reshape(-1, 3)[:count] = GREEN
    s = np.zeros((40, 50, 3), np.uint8)
    s[...] = RED
    s[0, 0] = GREEN
    got = TM.partition_masks(c, s)
    _equal(got, JM.partition_masks(c, s))
    assert got[0].shape == (regions, 150, 150, 1)


def test_partition_quantizes_and_pairs_like_jax():
    """Values snap to {0, 255} per channel; a content colour missing from
    the style mask is no region."""
    rng = np.random.default_rng(3)
    c = rng.integers(0, 256, (120, 130, 3)).astype(np.uint8)
    c[:60] = (254, 255, 3)  # quantizes to GREEN
    c[60:] = (255, 10, 250)  # quantizes to RED
    s = np.zeros((64, 64, 3), np.uint8)
    s[:32] = GREEN
    s[32:] = BLUE
    got = TM.partition_masks(c, s, sample_threth=100)
    _equal(got, JM.partition_masks(c, s, sample_threth=100))
    assert got[0].shape[0] == 1  # RED has no style pixel


def test_no_mask_found(tmp_path):
    c = np.zeros((50, 50, 3), np.uint8)
    s = np.zeros((50, 50, 3), np.uint8)
    for fn in (TM.partition_masks, JM.partition_masks):
        with pytest.raises(Exception, match="No mask found"):
            fn(c, s)
    cp, sp = _save(tmp_path, "c.png", c), _save(tmp_path, "s.png", s)
    with pytest.raises(Exception, match="No mask found"):
        TM.load_mask(cp, sp)


@pytest.mark.parametrize("src,hw", [((96, 80), (64, 53)), ((88, 104), (54, 64)),
                                    ((40, 30), (80, 60)), ((200, 200), (7, 9))])
def test_prepare_mask_matches_jax(src, hw):
    rng = np.random.default_rng(sum(src))
    m = np.zeros((*src, 1), np.float32)
    m[: src[0] // 2] = 1.0
    m[rng.random(m.shape) < 0.1] = 1.0
    for mask in (m, m[None]):
        got = TS.prepare_mask(torch.tensor(mask), hw)
        want = np.asarray(JS.prepare_mask(jnp.asarray(mask), hw))
        assert got.shape == hw
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_prepare_mask_all_pass_escape_matches_jax():
    """One lit pixel in 200 x 200 resized to 8 x 8: max < 0.1, every pixel
    valid."""
    m = np.zeros((200, 200, 1), np.float32)
    m[100, 100] = 1.0
    got = TS.prepare_mask(torch.tensor(m), (8, 8))
    want = np.asarray(JS.prepare_mask(jnp.asarray(m), (8, 8)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert got.min() == 1.0


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("kind", ["full", "strided"])
def test_masked_coords_lie_in_the_mask(kind):
    hw = (54, 64)
    mask = torch.zeros(hw)
    mask[10:40, 5:30] = 1.0
    draw = TS.full_grid_coords if kind == "full" else TS.strided_grid_coords
    for seed in range(5):
        c = draw(_gen(seed), hw, 64, "cpu", mask=mask).long()
        assert c.shape == (64, 2)
        assert bool(mask[c[:, 0], c[:, 1]].eq(1).all())
        if kind == "full":  # without replacement while points suffice
            assert len({tuple(p) for p in c.tolist()}) == 64


@pytest.mark.parametrize("kind", ["full", "strided"])
def test_masked_coords_escape_an_empty_region(kind):
    """No valid point: the draw takes the whole (in-bounds) grid instead of
    failing in the replacement draw."""
    hw = (54, 64)
    draw = TS.full_grid_coords if kind == "full" else TS.strided_grid_coords
    c = draw(_gen(0), hw, 64, "cpu", mask=torch.zeros(hw)).long()
    assert c.shape == (64, 2)
    assert bool(((c >= 0) & (c < torch.tensor(hw))).all())
    assert len({tuple(p) for p in c.tolist()}) == 64
    jc = np.asarray(JS.full_grid_coords(jax.random.PRNGKey(0), hw, 64,
                                        jnp.zeros(hw)) if kind == "full"
                    else JS.strided_grid_coords(jax.random.PRNGKey(0), hw, 64,
                                                jnp.zeros(hw)))
    assert len({tuple(p) for p in jc.astype(int).tolist()}) == 64


def test_strided_escape_when_the_grid_misses_a_thin_region():
    """A one-pixel-wide column between the grid's points: every offset
    that misses it falls back to the in-bounds grid."""
    hw = (256, 256)  # steps 2 and 2
    mask = torch.zeros(hw)
    mask[:, 1] = 1.0
    hits = 0
    for seed in range(12):
        c = TS.strided_grid_coords(_gen(seed), hw, 32, "cpu",
                                   mask=mask).long()
        on = bool(mask[c[:, 0], c[:, 1]].eq(1).all())
        hits += on
        assert on or len({tuple(p) for p in c.tolist()}) == 32
    assert 0 < hits < 12


@pytest.mark.parametrize("kind", ["full", "strided"])
def test_masked_coords_replace_when_a_region_is_small(kind):
    """Fewer valid points than samples: the draw is topped up with
    replacement from the region, never outside it."""
    hw = (54, 64)
    mask = torch.zeros(hw)
    mask[8:16, 8:16] = 1.0
    draw = TS.full_grid_coords if kind == "full" else TS.strided_grid_coords
    c = draw(_gen(1), hw, 128, "cpu", mask=mask).long()
    assert bool(mask[c[:, 0], c[:, 1]].eq(1).all())
    assert len({tuple(p) for p in c.tolist()}) < 128


def test_masked_coords_check_the_grid_shape():
    with pytest.raises(ValueError, match="prepare_mask"):
        TS.full_grid_coords(_gen(0), (5, 6), 4, "cpu", mask=torch.ones(6, 5))


_BAD = {
    "content only": (np.ones((2, 8, 8, 1), np.float32), None),
    "style only": (None, np.ones((2, 8, 8, 1), np.float32)),
    "rank": (np.ones((8, 8, 1), np.float32), np.ones((8, 8, 1), np.float32)),
    "channels": (np.ones((2, 8, 8, 3), np.float32),
                 np.ones((2, 8, 8, 3), np.float32)),
    "dtype": (np.ones((2, 8, 8, 1), np.int64),
              np.ones((2, 8, 8, 1), np.int64)),
    "style dtype": (np.ones((2, 8, 8, 1), np.float32),
                    np.ones((2, 8, 8, 1), np.uint8)),
    "regions": (np.ones((2, 8, 8, 1), np.float32),
                np.ones((3, 9, 9, 1), np.float32)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_check_masks_messages_match_jax(case):
    cm, sm = _BAD[case]
    with pytest.raises(ValueError) as want:
        jax_check_masks(cm, sm)
    with pytest.raises(ValueError) as got:
        check_masks(cm, sm)
    assert str(got.value) == str(want.value)


def test_check_masks_accepts_tensors_and_none():
    check_masks(None, None)
    check_masks(torch.ones(2, 8, 8, 1), torch.ones(2, 5, 6, 1))
    with pytest.raises(ValueError, match="float 0/1"):
        check_masks(torch.ones(2, 8, 8, 1, dtype=torch.int32),
                    torch.ones(2, 8, 8, 1))


def _masks(ch, cw, sh, sw):
    cm = np.zeros((2, ch, cw, 1), np.float32)
    cm[0, : ch // 2] = 1.0
    cm[1, ch // 2:] = 1.0
    sm = np.zeros((2, sh, sw, 1), np.float32)
    sm[0, :, : sw // 2] = 1.0
    sm[1, :, sw // 2:] = 1.0
    return cm, sm


def _jax_masked_coords(seed, cm, sm):
    """The JAX package's masked coordinates, region by region: per scale
    ``split(k_style, K)`` (``programs.py:274``), per step ``split(k_step,
    K)`` (``programs.py:665``), ``k_step`` from the scan's split
    (``programs.py:529``), each under the region's prepared mask."""
    cache = {}

    def coords(i, kind, step, hw, n, region):
        k = (i, kind, step, region)
        if k not in cache:
            key = jax.random.PRNGKey(seed)
            _, k_style, k_run = jax.random.split(jax.random.fold_in(key, i), 3)
            raw = sm if kind == "style" else cm
            mask = JS.prepare_mask(jnp.asarray(raw[region]), hw)
            if kind == "style":
                kr = jax.random.split(k_style, len(raw))[region]
                c = JS.full_grid_coords(kr, hw, n, mask)
            else:
                for _ in range(step + 1):
                    k_run, k_step = jax.random.split(k_run)
                kr = jax.random.split(k_step, len(raw))[region]
                c = JS.strided_grid_coords(kr, hw, n, mask)
            cache[k] = torch.tensor(np.asarray(c))
        return cache[k]

    return coords


def test_ten_masked_steps_match_jax():
    """2 regions, 1 tap, 64 samples, float32, the JAX coordinates replayed
    region by region: per-step losses to rtol 1e-4."""
    rng = np.random.default_rng(5)
    content = rng.random((1, 48, 56, 3)).astype(np.float32)
    style = rng.random((1, 52, 44, 3)).astype(np.float32)
    cm, sm = _masks(48, 56, 52, 44)
    kw = dict(levels=1, max_iter=10, log_every=10, sample_size=64,
              compute_dtype="float32", use_pallas=False,
              taps=("block1_conv1",), seed=3)
    params = jax_random_params("16", 0)
    _, jinfo = jax_stylize_single(
        jnp.asarray(content), jnp.asarray(style), JaxConfig(**kw), params,
        content_masks=jnp.asarray(cm), style_masks=jnp.asarray(sm))
    img, tinfo = stylize_single(
        torch.tensor(content), torch.tensor(style),
        strotss_torch.StrotssConfig(**kw),
        params_from_jax(jax.tree.map(np.asarray, params)),
        coords_source=_jax_masked_coords(3, cm, sm),
        content_masks=torch.tensor(cm), style_masks=torch.tensor(sm))
    want = np.asarray(jinfo["scales"][0]["curve"])
    got = tinfo["scales"][0]["curve"]
    assert got.shape == want.shape == (10, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tinfo["n_regions"] == 2
    assert tuple(img.shape) == (54, 64, 3) and img.dtype == torch.uint8


def test_masked_run_through_stylize_on_cpu():
    """The API with numpy masks and the port's own generator: finite,
    falling losses, one region count."""
    rng = np.random.default_rng(6)
    cm, sm = _masks(48, 56, 52, 44)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=4, sample_size=64,
                                      taps=("block1_conv1",),
                                      compute_dtype="float32")
    img, info = strotss_torch.stylize(
        rng.random((1, 48, 56, 3)), rng.random((1, 52, 44, 3)), cfg,
        content_masks=cm, style_masks=sm,
        vgg_params=random_params("16", 0),
        device="cpu")
    curve = info["scales"][0]["curve"]
    assert np.all(np.isfinite(curve)) and curve[-1, 0] < curve[0, 0]
    assert info["n_regions"] == 2 and tuple(img.shape) == (54, 64, 3)


def test_masked_sinkhorn_takes_the_plain_route_above_the_gate(monkeypatch):
    """A masked run's Sinkhorn is materialized with the unrolled gradient
    at every N (the JAX package forces its masked path to 'xla'), through
    ``remd_impl``, which routes Sinkhorn on a Sinkhorn step; self-similarity
    keeps 'auto', and REMD too on a masked run without Sinkhorn: their
    kernels on a card."""
    cfg = strotss_torch.StrotssConfig(use_sinkhorn=True, sample_size=32769)
    masked = spec_from_config(cfg, "cuda", masked=True)
    plain = spec_from_config(cfg, "cuda")
    remd = spec_from_config(strotss_torch.StrotssConfig(), "cuda",
                            masked=True)
    assert (masked.remd_impl, masked.selfsim_impl) == ("plain", "auto")
    assert (plain.remd_impl, remd.remd_impl, remd.selfsim_impl) == (
        "auto", "auto", "auto")
    assert TL.sinkhorn_route(32769, 32769, masked.remd_impl) == "plain"
    assert TL.sinkhorn_route(32769, 32769, plain.remd_impl) == "kernel"

    seen = []
    real = TL.sinkhorn

    def spy(x, y, distance="cosine", lam=10.0, n_iter=30, impl="auto"):
        seen.append(TL.sinkhorn_route(32769, 32769, impl))
        return real(x, y, distance, lam, n_iter, impl)

    monkeypatch.setattr(TL, "sinkhorn", spy)
    cm, sm = _masks(48, 56, 52, 44)
    rng = np.random.default_rng(7)
    small = strotss_torch.StrotssConfig(
        use_sinkhorn=True, levels=1, max_iter=1, sample_size=64,
        sinkhorn_iters=3, taps=("block1_conv1",), compute_dtype="float32")
    strotss_torch.stylize(rng.random((1, 48, 56, 3)),
                          rng.random((1, 52, 44, 3)), small,
                          content_masks=cm, style_masks=sm,
                          vgg_params=random_params("16", 0), device="cpu")
    assert seen and set(seen) == {"plain"}


def test_masked_cli_runs_on_cpu(tmp_path):
    """``--content_mask``/``--style_mask`` on 192 x 160 images: each region
    holds >= 10000 px at the loaded resolution."""
    rng = np.random.default_rng(8)
    paths = {}
    for name, shape in (("c.png", (192, 160, 3)), ("s.png", (176, 208, 3))):
        paths[name] = _save(tmp_path, name,
                            (rng.random(shape) * 255).astype(np.uint8))
    paths["cm.png"] = _save(tmp_path, "cm.png", _two_colour(192, 160, 96, 0))
    paths["sm.png"] = _save(tmp_path, "sm.png", _two_colour(176, 208, 104, 1))
    out = tmp_path / "out.jpg"
    rc = tcli.main([paths["c.png"], paths["s.png"], "-o", str(out), "--cpu",
                    "--content_mask", paths["cm.png"], "--style_mask",
                    paths["sm.png"], "--level", "1", "--max_iter", "2",
                    "--taps", "block1_conv1", "--compute_dtype", "float32",
                    "--sample_size", "64"])
    assert rc == 0 and out.exists()
    assert Image.open(out).size == (53, 64)  # the 64 px scale of 192x160


def test_cli_needs_both_masks(tmp_path):
    rng = np.random.default_rng(9)
    c = _save(tmp_path, "c.png", (rng.random((40, 48, 3)) * 255)
              .astype(np.uint8))
    with pytest.raises(ValueError, match="Either both content and style"):
        tcli.main([c, c, "--cpu", "--content_mask", c])
