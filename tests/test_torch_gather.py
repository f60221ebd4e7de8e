"""Kernel pair K5 (the hypercolumn gathers) on the CPU: its plain mirror
against the plain route under autograd, and the routing around it.

K5 itself runs only on the card (``tests/test_torch_cuda.py`` holds it to
these mirrors there). Here: the backward's corner keys are the plain
route's corners and weights bit for bit; their order groups each pixel's
keys in key order; the fixed-order float32 sums lie within one unit in the
last place of the map's dtype (plus float32's own summation bound) of the
float64 gradient of ``bilinear_gather`` / ``nearest_gather``; and the
``impl`` switch, the step's ``sample_impl``, the map table and its cache.
"""

import numpy as np
import pytest
import torch

from strotss_torch import StrotssConfig, programs
from strotss_torch.ops import losses, sampling
from strotss_torch.ops.kernels import gather


def _coords(seed, n, hi_x, hi_y, frac=False):
    """(n, 2) float32 coords in [0, hi) (fractional ones may lie past the
    border on both sides, so that the corners clip)."""
    g = torch.Generator().manual_seed(seed)
    if frac:
        c = torch.rand(n, 2, generator=g) * torch.tensor(
            [hi_x + 3.0, hi_y + 3.0]) - 1.5
        return c.float()
    return torch.stack([torch.randint(0, hi_x, (n,), generator=g),
                        torch.randint(0, hi_y, (n,), generator=g)],
                       1).float()


# (map h, w), base grid, factor: a fine map, the coarse ones the default
# hypercolumn ends with (many keys a pixel) and a factor that is not a
# power of two (171 px over 85)
_MAPS = [((18, 26), (37, 53), 0.5), ((3, 4), (48, 64), 0.0625),
         ((24, 32), (384, 512), 0.0625), ((42, 64), (85, 128),
                                          0.4970760233918129)]


@pytest.mark.parametrize("hw,base,fac", _MAPS)
@pytest.mark.parametrize("frac", [False, True])
def test_corner_keys_are_the_plain_corners(hw, base, fac, frac):
    """Pixels and weights of the bilinear keys, in key order (sample,
    corner), bit for bit ``bilinear_corners``' at ``coords * fac``; the
    clipped borders included."""
    coords = _coords(1, 300, *base, frac=frac)
    h, w = hw
    pix, wt = gather.corner_keys(coords, h, w, fac, nearest=False)
    corners = sampling.bilinear_corners(coords * fac, h, w)
    assert torch.equal(pix.view(-1, 4), torch.stack(
        [x * w + y for x, y, _ in corners], 1))
    assert torch.equal(wt.view(-1, 4), torch.stack([t for *_, t in corners],
                                                   1))


def test_nearest_keys_are_the_nearest_lookup():
    """At factor 1 with integer coords (the image and block1's taps in
    the paired samples) a key a sample, at ``nearest_gather``'s pixel,
    weight 1; at another factor (the style targets) the scaled lookup."""
    coords = _coords(2, 500, 37, 53)
    for fac, hw in ((1.0, (37, 53)), (0.5, (18, 26))):
        # a map whose value is its pixel's index
        m = torch.arange(hw[0] * hw[1], dtype=torch.float32).view(*hw, 1)
        c = coords * fac if fac != 1.0 else coords
        pix, wt = gather.corner_keys(coords, *hw, fac, nearest=True)
        assert torch.equal(pix.float(), sampling.nearest_gather(m, c)[:, 0])
        assert bool((wt == 1).all())


@pytest.mark.parametrize("hw,n,clip", [((3, 4), 1024, False),
                                       ((7, 9), 33000, False),
                                       ((12, 16), 200, True)])
def test_key_order_groups_each_pixel_in_key_order(hw, n, clip):
    """The order the backward sums in: pixels ascending, a pixel's keys in
    key order. Coarse maps gather hundreds of keys a pixel; 33000 samples
    (132,000 keys, the --sinkhorn path's size) span many of the radix
    sort's 1024-key chunks; at the clipped border one sample's two corners
    fall on one pixel and keep their corner order."""
    h, w = hw
    base = (8 * h, 8 * w)
    coords = _coords(3, n, *base, frac=clip)
    if clip:  # samples on and past the last row and column
        coords[::3, 0] = base[0] + 2.0
        coords[1::3, 1] = -0.5
    fac = 0.125
    pix, _ = gather.corner_keys(coords, h, w, fac, nearest=False)
    order = gather.key_order(pix)
    sp = pix[order]
    assert bool((sp[1:] >= sp[:-1]).all())
    same = sp[1:] == sp[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    counts = torch.bincount(pix, minlength=h * w)
    assert int(counts.max()) > (50 if n >= 1024 else 1)
    if clip:
        # some sample sends two corners to one pixel
        k = pix.view(-1, 4)
        assert bool((k[:, 0] == k[:, 2]).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,base,fac", _MAPS[:3])
@pytest.mark.parametrize("n", [64, 1024])
def test_grad_mirror_within_one_ulp_of_float64(dtype, hw, base, fac, n):
    """The fixed-order float32 backward, rounded once to the map's dtype,
    against torch autograd of ``bilinear_gather`` in float64: within one
    unit in the last place of the dtype plus float32's bound for the
    pixel's sequential sum (``gather.sum_bound``)."""
    h, w = hw
    c = 24
    coords = _coords(4, n, *base)
    g = torch.randn(n, c, generator=torch.Generator().manual_seed(5))
    m64 = torch.randn(h, w, c, dtype=torch.float64, requires_grad=True)
    rows = sampling.bilinear_gather(m64, coords * fac)
    want, = torch.autograd.grad(rows, m64, g.double(), retain_graph=True)
    mags, = torch.autograd.grad(rows, m64, g.double().abs())
    got = gather.grad_mirror(g, coords, (h, w, c), fac, False, dtype)
    assert got.dtype == dtype
    bound = gather.sum_bound(want, mags,
                             gather.term_counts(coords, (h, w, c), fac,
                                                False), dtype)
    assert bool(((got.double() - want).abs() <= bound).all())
    # untouched pixels are zeros
    assert bool((got[gather.term_counts(coords, (h, w, c), fac,
                                        False)[..., 0] == 0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grad_mirror_nearest_with_repeats(dtype):
    """A nearest map at factor 1 where coords repeat (a masked draw's
    top-up): each pixel's cotangents summed in float32 in key order,
    within sum_bound of float64."""
    coords = _coords(6, 2000, 20, 30)
    g = torch.randn(2000, 5, generator=torch.Generator().manual_seed(7))
    m64 = torch.randn(20, 30, 5, dtype=torch.float64, requires_grad=True)
    rows = sampling.nearest_gather(m64, coords)
    want, = torch.autograd.grad(rows, m64, g.double(), retain_graph=True)
    mags, = torch.autograd.grad(rows, m64, g.double().abs())
    got = gather.grad_mirror(g, coords, (20, 30, 5), 1.0, True, dtype)
    counts = gather.term_counts(coords, (20, 30, 5), 1.0, True)
    assert int(counts.max()) > 1
    bound = gather.sum_bound(want, mags, counts, dtype)
    assert bool(((got.double() - want).abs() <= bound).all())


def test_grad_mirror_is_the_sequential_sum_in_key_order():
    """The mirror is, bit for bit, 0 + t1 + t2 + ... over each pixel's keys
    in key order in float32 (t = g[sample] * weight), rounded once."""
    coords = _coords(8, 300, 24, 32, frac=True)
    h, w, c, fac = 3, 4, 3, 0.125
    g = torch.randn(300, c, generator=torch.Generator().manual_seed(9))
    pix, wt = gather.corner_keys(coords, h, w, fac, False)
    acc = np.zeros((h * w, c), np.float32)
    gn, wn = g.numpy(), wt.numpy()
    for k in np.argsort(pix.numpy(), kind="stable"):
        acc[int(pix[k])] = acc[int(pix[k])] + gn[k // 4] * wn[k]
    got = gather.grad_mirror(g, coords, (h, w, c), fac, False,
                             torch.float32)
    np.testing.assert_array_equal(got.numpy().reshape(-1, c), acc)


def _maps(seed):
    r = np.random.default_rng(seed)
    return [torch.tensor(r.standard_normal((1,) + s), dtype=torch.float32)
            for s in ((37, 53, 3), (37, 53, 8), (18, 26, 16), (9, 13, 32))]


def test_kernel_impl_on_the_cpu_raises():
    """'kernel' on CPU coordinates raises (resolve_impl): no quiet
    fallback to the plain gathers."""
    coords = _coords(10, 64, 37, 53)
    xs, ys = _maps(1), _maps(2)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        sampling.sample_paired(coords, xs, ys, "kernel")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        sampling.sample_style(coords, xs, "kernel")
    with pytest.raises(ValueError, match="impl must be"):
        sampling.sample_paired(coords, xs, ys, "pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather.rows(coords, [sampling._side(xs, True, True)])


def test_auto_impl_on_the_cpu_is_the_plain_route():
    """'auto' on the CPU takes today's plain gathers: the same rows and
    gradients bit for bit."""
    coords = _coords(11, 64, 37, 53)
    xs = _maps(3)
    got, want = [], []
    for impl, out in (("auto", got), ("plain", want)):
        ys = [m.clone().requires_grad_() for m in _maps(4)]
        rows = sampling.sample_paired(coords, xs, ys, impl)
        out.extend(rows)
        out.extend(torch.autograd.grad(rows[1].sum(), ys))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_pallas,want", [(True, "auto"),
                                             (False, "plain")])
def test_spec_from_config_sets_sample_impl(use_pallas, want):
    """The step's gather route follows use_pallas, as selfsim_impl does;
    a StepSpec built without it takes the plain route."""
    spec = programs.spec_from_config(StrotssConfig(use_pallas=use_pallas),
                                     "cpu")
    assert spec.sample_impl == want == spec.selfsim_impl
    assert spec._replace(sample_impl="plain").sample_impl == "plain"
    bare = programs.StepSpec(*spec[:programs.StepSpec._fields.index(
        "remat")])
    assert bare.sample_impl == "plain"


def test_step_losses_sample_through_the_specs_route(monkeypatch):
    """step_losses hands its spec's sample_impl to sample_paired, once a
    region."""
    seen = []
    orig = programs.sample_paired

    def spy(coords, xs, ys, impl="plain"):
        seen.append(impl)
        return orig(coords, xs, ys, "plain")

    monkeypatch.setattr(programs, "sample_paired", spy)
    spec = programs.spec_from_config(
        StrotssConfig(sample_size=64, taps=("block1_conv1",)), "cpu")
    xs = _maps(5)
    ys = _maps(6)
    coords = torch.stack([_coords(12, 64, 37, 53)] * 2)
    targets = torch.randn(2, 64, 59, generator=torch.Generator().manual_seed(
        13))
    moments = [losses.moment_stats(t) for t in targets]
    programs.step_losses(spec, xs, ys, targets, moments, 16.0, coords)
    assert seen == ["auto", "auto"]


def test_dense_strides_keep_the_maps_layout():
    """A gradient takes its map's layout where that is dense: the VGG taps'
    NHWC views of NCHW tensors, a batch pair's unbind view; a strided
    slice's gradient is contiguous."""
    nchw = torch.zeros(1, 16, 6, 7).permute(0, 2, 3, 1)
    assert gather.dense_strides(nchw.shape, nchw.stride()) == nchw.stride()
    pair = torch.zeros(8, 16, 6, 7).permute(0, 2, 3, 1).unbind(0)[5]
    assert gather.dense_strides(pair.shape, pair.stride()) == (7, 1, 42)
    sliced = torch.zeros(6, 14, 16)[:, ::2]
    assert gather.dense_strides(sliced.shape, sliced.stride()) == (112, 16, 1)


def test_map_table_and_its_cache():
    """The table the kernels read: each map's last three strides, h, w, C,
    its factor's float32 bits, lookup, column, side and row width; one
    plan a signature, reused for new tensors of the same shapes."""
    xs = [torch.zeros(1, 37, 53, 3),
          torch.zeros(1, 8, 18, 26, dtype=torch.bfloat16).permute(0, 2, 3, 1)]
    ys = [torch.zeros(37, 53, 3), torch.zeros(18, 26, 8,
                                              dtype=torch.bfloat16)]
    sides = [sampling._side(xs, True, True), sampling._side(ys, True, True)]
    plan = gather._Plan(sides, -1)
    assert plan.widths == [11, 11]
    words = np.array(plan.fwd).reshape(4, gather.DESC_WORDS)
    np.testing.assert_array_equal(words[:, 1:4], [[159, 3, 1],
                                                  [26, 1, 468],
                                                  [159, 3, 1], [208, 8, 1]])
    np.testing.assert_array_equal(words[:, 4:7], [[37, 53, 3], [18, 26, 8]]
                                  * 2)
    half = int(np.float32(sides[0].factors[1]).view(np.uint32))
    np.testing.assert_array_equal(words[:, 7], [0x3F800000, half] * 2)
    np.testing.assert_array_equal(words[:, 8:14],
                                  [[0, 1, 0, 0, 0, 11], [1, 0, 1, 3, 0, 11],
                                   [0, 1, 0, 0, 1, 11],
                                   [1, 0, 1, 3, 1, 11]])
    again = gather._plan(sides, -1)
    assert gather._plan([sampling._side([x.contiguous() for x in xs], True,
                                        True), sides[1]], -1) is not again
    assert gather._plan(sides, -1) is again
    metas, strides, table = again.backward((1, 3))
    assert [m.side for m in metas] == [0, 1] and strides[0] == xs[1].stride()
