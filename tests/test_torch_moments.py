"""Kernel set K6 (the moment term of the style loss) and its routing.

On the CPU: the plain route is the formula the port has always run, bit
for bit in value and gradient; :func:`moments.mirror`, the kernels'
arithmetic tile by tile (upper-triangle tiles, the off-diagonal entries
counted for (a, b) and (b, a), H = sign(d1) + sign(d2), the backward's
product with its column-sum and mean terms), agrees with float64 autograd
of the plain formula; the tile order, the padded shapes and the step's
``moments_impl``.

Marked ``cuda``, on the card only (the kernels have no CPU mode; this file
imports no JAX, so it runs there with ``python -m pytest --noconftest
tests/test_torch_moments.py -q``). Tolerances: the loss within 2^-16 of
itself of the float64 mirror's (its float32 covariance is 3xTF32, as
accurate as float32; |d| is summed over C^2 terms in float32); H equal to
the mirror's but where a float64 difference lies within 2^-16 of max|P|
of 0; the gradient within 2^-16 of its terms' magnitudes, sum |cx| |H| /
(n C^2), of the float64 product with the kernel's own H (the tensor cores
sum 128 channels in truncating f32 before each period's sums reach f32
registers: 128 x 2^-23); against the plain route on the card, the
gradient's channels whose H rows agree to 1e-4 of max|g|, since one flipped
sign moves two channels of every row.
"""

import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch import StrotssConfig, programs
from strotss_torch.models.weights import random_params
from strotss_torch.ops import losses
from strotss_torch.ops.kernels import moments
from strotss_torch.utils import timing


def _rows(seed, n, c, dtype=torch.float32, device="cpu"):
    """Rows like hypercolumn samples: offset, scaled channels."""
    g = np.random.default_rng(seed)
    a = g.standard_normal((n, c)) * g.uniform(0.2, 2.0, c) + g.uniform(
        -1.0, 1.0, c)
    return torch.tensor(a, dtype=dtype, device=device)


def _old_stats(x):
    """``losses.moment_stats`` as the port computed it before K6."""
    x = losses.reshape_2d(losses._f32(x))
    xm = torch.mean(x, dim=0, keepdim=True)
    cx = x - xm
    return xm, (cx.T @ cx) / x.shape[0]


def _old_loss(stats, y):
    xm, xv = stats
    ym, yv = _old_stats(y)
    return losses.mae(xv, yv) + losses.mae(xm, ym)


@pytest.mark.parametrize("n,c", [(1024, 2179), (37, 3), (200, 130)])
def test_plain_route_is_the_old_formula_bit_for_bit(n, c):
    """On CPU tensors ('auto') the moments and their gradient are the
    formula the port ran before K6, bit for bit (one thread, so that the
    two sides' products run in one order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = _rows(1, n, c)
        y = _rows(2, n, c).requires_grad_()
        stats = losses.moment_stats(t)
        want_stats = _old_stats(t)
        assert all(torch.equal(a, b) for a, b in zip(stats, want_stats))
        got = losses.moment_matching_from_stats(stats, y)
        (dg,) = torch.autograd.grad(got, y)
        want = _old_loss(want_stats, y)
        (dw,) = torch.autograd.grad(want, y)
        assert torch.equal(got, want) and torch.equal(dg, dw)
        assert torch.equal(losses.moment_matching(t, y.detach()),
                           _old_loss(want_stats, y.detach()))
    finally:
        torch.set_num_threads(threads)


def _target(seed, c, dtype=torch.float64):
    """A style target's (mean (1, c), cov (c, c)), the covariance made a
    little asymmetric: the kernels compare both (a, b) and (b, a)."""
    z = _rows(seed, 50, c, dtype)
    tm, tv = moments.stats_plain(z)
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn(c, c, generator=g, dtype=dtype)
    return tm, tv + 1e-3 * noise * tv.abs().mean()


@pytest.mark.parametrize("c", [3, 67, 2179])
@pytest.mark.parametrize("n", [1, 37, 1000, 1024])
def test_mirror_agrees_with_float64_autograd(n, c):
    """K6's arithmetic (``moments.mirror``) gives the plain formula's value
    and autograd's gradient, in float64."""
    y = _rows(3, n, c, torch.float64).requires_grad_()
    tm, tv = _target(4, c)
    want = moments.loss_plain((tm, tv), y)
    (dw,) = torch.autograd.grad(want, y)
    loss, grad, h = moments.mirror(y.detach(), tm, tv)
    want = float(want.detach())
    assert abs(float(loss) - want) <= 1e-12 * abs(want)
    scale = float(dw.abs().max())
    assert float((grad - dw).abs().max()) <= 1e-12 * scale
    assert torch.equal(h, h.T)
    assert set(torch.unique(h).tolist()) <= {-2.0, 0.0, 2.0}


@pytest.mark.parametrize("c", [1, 3, 128, 129, 192, 300, 385, 2179])
def test_tiles_cover_the_upper_triangle_once(c):
    """The covariance's blocks, row tiles of 128 rows by column tiles of
    192 columns, each holding an entry on or above the diagonal, cover
    every (a, b), a <= b < c, once, row by row."""
    seen = torch.zeros(c, c, dtype=torch.int32)
    order = []
    for b in range(moments.shapes(1, c).tiles):
        i, j = moments.tile_of(b, c)
        order.append((i, j))
        blk = seen[i * moments.MO_T:(i + 1) * moments.MO_T,
                   j * moments.MO_TN:(j + 1) * moments.MO_TN]
        assert blk.numel() and bool(torch.triu(torch.ones(c, c))[
            i * moments.MO_T:(i + 1) * moments.MO_T,
            j * moments.MO_TN:(j + 1) * moments.MO_TN].any())
        blk += 1
    assert order == sorted(order)
    assert torch.equal(torch.triu(seen), torch.triu(torch.ones_like(seen)))


def test_padded_shapes():
    """The default hypercolumn (1024 x 2179): 18 row tiles by 12 column
    tiles, 120 computed, one wave on an H100's 132 SMs; 1 sample of 3
    channels pads to one tile. The channels' padding holds every row a
    tile or a 192-channel backward block reads."""
    assert moments.shapes(1024, 2179) == (1024, 2304, 2192, 72, 120)
    assert moments.shapes(1000, 2179).np == 1024
    assert moments.shapes(1, 3) == (128, 384, 16, 12, 1)
    for c in (3, 129, 300, 2179, 4000):
        cp = moments.shapes(1, c).cp
        for m in (moments.MO_T, moments.MO_TN, moments.MO_BM):
            assert cp >= -(-c // m) * m


def test_kernel_route_needs_a_card():
    x = _rows(5, 8, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        losses.moment_stats(x, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        losses.moment_matching_from_stats(_old_stats(x), x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        losses.moment_stats(x, impl="fast")


@pytest.fixture
def card_route(monkeypatch):
    """The kernel route as on a CUDA tensor, its launches replaced by
    recorders: the calls that reached K6's wrappers, by name."""
    called = []

    def resolve(impl, t):
        if impl not in ("auto", "plain", "kernel"):
            raise ValueError(impl)
        return "plain" if impl == "plain" else "kernel"

    def fake_stats(x):
        called.append("stats")
        return moments.stats_plain(x.detach())

    def fake_loss(y, tm, tv, want_grad=True):
        called.append("loss")
        return moments.loss_plain((tm, tv), y.detach()), None

    monkeypatch.setattr(moments, "resolve_impl", resolve)
    monkeypatch.setattr(moments, "stats", fake_stats)
    monkeypatch.setattr(moments, "loss_fwd", fake_loss)
    return called


@pytest.mark.parametrize("grad_enabled", [True, False])
def test_auto_statistics_take_the_plain_formula_for_a_gradient(
        card_route, grad_enabled):
    """'auto' on a CUDA tensor: K6's statistics where no gradient is
    wanted through them, else the plain formula, differentiable; 'kernel'
    raises there."""
    x = _rows(12, 40, 9).requires_grad_()
    with torch.set_grad_enabled(grad_enabled):
        mean, cov = losses.moment_stats(x, "auto")
    if grad_enabled:
        assert card_route == [] and cov.requires_grad
        (g,) = torch.autograd.grad(cov.sum() + mean.sum(), x)
        assert bool(torch.isfinite(g).all())
        with pytest.raises(RuntimeError, match="impl='plain'"):
            losses.moment_stats(x, "kernel")
    else:
        assert card_route == ["stats"]
    assert torch.equal(cov.detach(), _old_stats(x.detach())[1])
    assert torch.equal(losses.moment_stats(x.detach(), "auto")[1],
                       cov.detach())
    assert card_route[-1] == "stats"


@pytest.mark.parametrize("grad_enabled", [True, False])
def test_auto_loss_takes_the_plain_formula_for_a_targets_gradient(
        card_route, grad_enabled):
    """'auto' on CUDA tensors: K6's loss unless a gradient is wanted
    through the target's statistics, then the plain formula,
    differentiable in them; 'kernel' raises there."""
    tm, tv = (t.requires_grad_() for t in _old_stats(_rows(13, 50, 7)))
    y = _rows(14, 30, 7)
    with torch.set_grad_enabled(grad_enabled):
        v = losses.moment_matching_from_stats((tm, tv), y, "auto")
    assert torch.equal(v.detach(), _old_loss((tm.detach(), tv.detach()), y))
    if grad_enabled:
        assert card_route == []
        gm, gv = torch.autograd.grad(v, (tm, tv))
        assert float(gm.abs().sum()) > 0 and float(gv.abs().sum()) > 0
        with pytest.raises(RuntimeError, match="impl='plain'"):
            losses.moment_matching_from_stats((tm, tv), y, "kernel")
    else:
        assert card_route == ["loss"]
    losses.moment_matching_from_stats((tm.detach(), tv.detach()), y, "auto")
    assert card_route[-1] == "loss"


@pytest.mark.parametrize("use_pallas,want", [(True, "auto"),
                                             (False, "plain")])
def test_spec_from_config_sets_moments_impl(use_pallas, want):
    """The moments' route follows use_pallas, as the other kernels' do; a
    StepSpec built without it takes the plain route."""
    for kw in ({}, {"masked": True}, {"batched": True}):
        spec = programs.spec_from_config(
            StrotssConfig(use_pallas=use_pallas), "cpu", **kw)
        assert spec.moments_impl == want == spec.selfsim_impl
    bare = programs.StepSpec(*spec[:programs.StepSpec._fields.index(
        "remat")])
    assert bare.moments_impl == "plain"


def test_step_and_scale_take_the_specs_moments_route(monkeypatch):
    """step_losses hands its spec's moments_impl to the style loss once a
    region, and a stylization computes its style targets' statistics on
    the same route."""
    from strotss_torch import solve

    seen, stats_seen = [], []
    orig = programs.style_loss
    orig_stats = solve.moment_stats

    def spy(*a, moments_impl="auto", **k):
        seen.append(moments_impl)
        return orig(*a, moments_impl="plain", **k)

    def stats_spy(x, impl="auto"):
        stats_seen.append(impl)
        return orig_stats(x, "plain")

    monkeypatch.setattr(programs, "style_loss", spy)
    monkeypatch.setattr(solve, "moment_stats", stats_spy)
    cfg = StrotssConfig(levels=1, max_iter=1, sample_size=64,
                        taps=("block1_conv1",), compute_dtype="float32")
    rng = np.random.default_rng(6)
    strotss_torch.stylize(rng.random((1, 40, 48, 3)).astype(np.float32),
                          rng.random((1, 48, 40, 3)).astype(np.float32), cfg,
                          vgg_params=random_params("16", 0), device="cpu")
    assert seen == ["auto"] and stats_seen == ["auto"]


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(seed, n, c, device):
    y = _rows(seed, n, c, device=device)
    z = _rows(seed + 1, max(n, 64), c, device=device)
    tm, tv = moments.stats_plain(z)
    return y, tm.contiguous(), tv.contiguous()


def _h_plain(cov, tv):
    """H = sign(P - T) + its transpose, from a covariance P."""
    s = torch.sign(cov - tv)
    return s + s.T


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1024, 2179), (1000, 2179), (300, 130),
                                 (129, 257), (37, 67), (1, 3)])
def test_k6_loss_and_gradient_on_card(cuda_device, n, c):
    y, tm, tv = _card_case(7, n, c, cuda_device)
    loss, saved = moments.loss_fwd(y, tm, tv)
    dx = moments.loss_bwd(saved, torch.ones((), device=cuda_device), n, c)
    torch.cuda.synchronize()
    y64, tm64, tv64 = y.double().cpu(), tm.double().cpu(), tv.double().cpu()
    loss64, _, h64 = moments.mirror(y64, tm64, tv64)
    assert abs(float(loss) - float(loss64)) <= 2.0 ** -16 * float(loss64)
    # signs differ from float64's only where a difference is tiny
    hk = saved.h[:c, :c].double().cpu()
    cx = y64 - y64.mean(0)
    cov = cx.T @ cx / n
    tiny = 2.0 ** -16 * float(cov.abs().max())
    small = torch.minimum((cov - tv64).abs(), (cov - tv64.T).abs())
    assert bool((small[hk != h64] <= tiny).all())
    # the gradient against the float64 product with the kernel's own signs
    ms = saved.msign.double().cpu()
    colsum = cx.sum(0)
    want = (cx @ hk - (colsum @ hk) / n) / (n * c * c) + ms / (n * c)
    bound = 2.0 ** -16 * (cx.abs() @ hk.abs()) / (n * c * c) \
        + 2.0 ** -20 * want.abs()
    assert bool(((dx.double().cpu() - want).abs() <= bound).all())
    # against the plain route on the card, in the channels whose signs agree
    yg = y.clone().requires_grad_()
    plain = moments.loss_plain((tm, tv), yg)
    (dp,) = torch.autograd.grad(plain, yg)
    plain = plain.detach()
    assert abs(float(loss) - float(plain)) <= 2.0 ** -16 * float(plain)
    _, pcov = moments.stats_plain(y)
    same = (_h_plain(pcov, tv).cpu().double() == hk).all(1)
    assert float(same.float().mean()) >= 0.99
    err = (dx - dp).abs().max(0).values.cpu()
    assert bool((err[same] <= 1e-4 * float(dp.abs().max())).all())


@pytest.mark.cuda
def test_k6_repeats_bit_for_bit_on_card(cuda_device):
    y, tm, tv = _card_case(8, 1024, 2179, cuda_device)
    g = torch.full((), 0.75, device=cuda_device)
    runs = []
    for _ in range(2):
        loss, saved = moments.loss_fwd(y, tm, tv)
        runs.append((loss, moments.loss_bwd(saved, g, 1024, 2179),
                     *moments.stats(y)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1024, 2179), (37, 67), (1, 3)])
def test_k6_stats_symmetric_on_card(cuda_device, n, c):
    """The statistics' covariance is symmetric bit for bit and within
    float32's accuracy of float64."""
    x = _rows(9, n, c, device=cuda_device)
    mean, cov = moments.stats(x)
    assert torch.equal(cov, cov.T)
    x64 = x.double().cpu()
    m64 = x64.mean(0, keepdim=True)
    c64 = (x64 - m64).T @ (x64 - m64) / n
    assert float((mean.double().cpu() - m64).abs().max()) <= \
        1e-6 * float(x64.abs().max())
    assert float((cov.double().cpu() - c64).abs().max()) <= \
        1e-5 * max(float(c64.abs().max()), 1e-30)


@pytest.mark.cuda
def test_k6_launches_in_a_stylize_step(cuda_device):
    """A default-route stylization takes K6: two launches a scale for the
    style targets' statistics, three forward and one backward launch a
    step its wrappers issue (a replayed graph step issues none)."""
    counts = timing.counters
    names = ("launch.moments_stats", "launch.moments_fwd",
             "launch.moments_bwd", "graph.replay", "graph.capture")
    before = {k: counts().get(k, 0) for k in names}
    rng = np.random.default_rng(10)
    cfg = StrotssConfig(levels=2, max_iter=3)
    strotss_torch.stylize(rng.random((1, 48, 64, 3)).astype(np.float32),
                          rng.random((1, 64, 56, 3)).astype(np.float32), cfg,
                          vgg_params=random_params("16", 0), device="cuda")
    d = {k: counts().get(k, 0) - before[k] for k in names}
    issued = 2 * 3 - d["graph.replay"] + d["graph.capture"]
    assert d["launch.moments_stats"] == 2 * 2
    assert d["launch.moments_fwd"] == 3 * issued
    assert d["launch.moments_bwd"] == issued
    assert issued > 0


@pytest.mark.cuda
def test_k6_replays_from_a_graph_bit_for_bit(cuda_device):
    """The loss and its gradient captured in a CUDA graph and replayed on
    new rows equal the eager calls on those rows, bit for bit, under
    PyTorch's deterministic algorithms."""
    y, tm, tv = _card_case(11, 1024, 2179, cuda_device)
    y.requires_grad_()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def step():
            loss = losses.moment_matching_from_stats((tm, tv), y)
            return loss, torch.autograd.grad(loss, y)[0]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        for seed in (12, 13):
            with torch.no_grad():
                y.copy_(_rows(seed, 1024, 2179, device=cuda_device))
            graph.replay()
            want = step()
            torch.cuda.synchronize()
            assert torch.equal(out[0], want[0])
            assert torch.equal(out[1], want[1])
    finally:
        torch.use_deterministic_algorithms(was)
