"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card they skip (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs
on a machine with only PyTorch; there the repository's conftest files,
which configure JAX, are left out::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: minima and the forward loss to rtol 1e-5 (float32 products
summed in another order; K1's tensor-core route sums three TF32 products
per product, as accurate); REMD 'both' at C = 3, which cancels in float32,
no further from float64 than twice the plain version. The backward product, after the pull-back's
projection, to 1e-4 of its largest entry in all but 1% of the rows (K2b
takes the forward's signs, and its product is three TF32 products
summed a stage at a time, as accurate as float32; the plain version on the
card rounds G once more, dividing by N as a product with 1/N); the
forward's signs differ from the plain version's only where A - B lies
within 1e-5 of its largest value of 0. VGG block1:
tap1 to 1e-5 of its largest value (exact bf16 products summed in another
order), tap2 and dx to 1e-3 (where that order moves y1 or dy1 across a
bf16 rounding boundary, one operand moves by 2^-8). Sinkhorn LSE passes
to 1e-5 of max|out| and the streamed loss to rtol 1e-4 of the
materialized one, the JAX package's own tolerance for its compiled
streamed kernel (30 iterations of float32 sums in another order). The
hypercolumn gathers (K5): the rows bit for bit the plain route's (the same
float32 operations, none fused); each map's gradient bit for bit its
mirror's (``gather.grad_mirror``: the same sums in the same order) and
within ``gather.sum_bound`` of the float64 gradient: one unit in the last
place of the map's dtype, plus float32's own bound for the pixel's
sequential sum.
"""

import numpy as np
import pytest
import torch

from strotss_torch.models.weights import random_params
from strotss_torch.ops import losses
from strotss_torch.ops import sampling
from strotss_torch.ops.kernels import (block1, build, gather, remd, selfsim,
                                     sinkhorn)
from strotss_torch.utils import timing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, device):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(a, dtype=torch.float32, device=device)


def _count(kernel):
    """The kernel's launches so far (its wrapper's counter)."""
    return timing.counters().get("launch." + kernel, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c,dist", [(1024, 1024, 2179, "cosine"),
                                        (1000, 777, 2179, "both"),
                                        (130, 70, 2179, "l2"),
                                        (1000, 777, 64, "both"),
                                        (300, 200, 35, "l2")])
def test_remd_mins_on_card(cuda_device, n, m, c, dist):
    """Both routes (by C) and ragged edges (N not a multiple of 64 or 128,
    M not a multiple of 64)."""
    x, y = _rand(n, (n, c), cuda_device), _rand(m + 7, (m, c), cuda_device)
    before = _count("remd_mins")
    got = remd.mins(x, y, dist)
    assert _count("remd_mins") == before + 1
    want = remd.mins_plain(x, y, dist)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    for a, b in zip(got, remd.mins(x, y, dist)):
        assert torch.equal(a, b)  # no atomics: bitwise reproducible


@pytest.mark.cuda
def test_remd_mins_misaligned_rows_on_card(cuda_device):
    """Row slices whose first element is not 16-byte aligned (C = 2179 is
    odd) take the tensor-core route through an aligned copy."""
    xf = _rand(5, (301, 2179), cuda_device)
    yf = _rand(6, (203, 2179), cuda_device)
    x, y = xf[1:], yf[3:]
    assert x.data_ptr() % 16 and y.data_ptr() % 16
    got = remd.mins(x, y, "cosine")
    want = remd.mins_plain(x, y, "cosine")
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)


def _dist64(x, y, dist):
    x, y = x.double(), y.double()
    xn = x / x.norm(dim=1, keepdim=True).clamp_min(1e-6)
    yn = y / y.norm(dim=1, keepdim=True).clamp_min(1e-6)
    msq = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
           - 2.0 * (x @ y.T))
    l2 = torch.sqrt(msq.clamp(min=1e-6) / x.shape[1])
    return {"cosine": 1.0 - xn @ yn.T, "l2": l2,
            "both": 1.0 - xn @ yn.T + l2}[dist]


@pytest.mark.cuda
def test_remd_mins_yuv_on_card(cuda_device):
    """The YUV term's call, 1024 x 1024 x 3 'both' on positive values, on
    the CUDA-core route. 'both' at C = 3 cancels in float32 (1 - cos and
    the L2 expansion of near neighbours), so the minima are held to float64:
    no further from it than twice the plain float32 version (at least
    1e-5), as chip_smoke.py holds them."""
    gen = np.random.default_rng(3)
    x = torch.tensor(gen.random((1024, 3)), dtype=torch.float32,
                     device=cuda_device)
    y = torch.tensor(gen.random((1024, 3)), dtype=torch.float32,
                     device=cuda_device)
    assert remd.route(3) == "cuda_cores"
    got = remd.mins(x, y, "both")
    want = remd.mins_plain(x, y, "both")
    full = _dist64(x, y, "both")
    ref = (full.min(dim=1).values, full.min(dim=0).values)

    def rel(a, b):
        return float(((a.double() - b) / b).abs().max())

    tol = max(1e-5, 2.0 * max(rel(want[0], ref[0]), rel(want[1], ref[1])))
    assert max(rel(got[0], ref[0]), rel(got[1], ref[1])) <= tol
    for a, b in zip(got, remd.mins(x, y, "both")):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["below", "at"])
def test_remd_routes_meet_at_threshold(cuda_device, side):
    """One C on each side of the tensor-core threshold, at a ragged shape:
    the C entry takes the route the threshold says, and both routes, forced,
    give the plain version's minima to rtol 1e-5."""
    c = remd.tc_min_c() - (1 if side == "below" else 0)
    assert remd.route(c) == ("cuda_cores" if side == "below"
                             else "tensor_cores")
    x, y = _rand(c, (257, c), cuda_device), _rand(c + 1, (129, c),
                                                  cuda_device)
    want = remd.mins_plain(x, y, "cosine")
    for route in (None,) + remd.ROUTES:
        got = remd.mins(x, y, "cosine", route)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_remd_mins_repeat_call_allocates_outputs_only(cuda_device,
                                                      monkeypatch):
    """At a repeated shape on the same stream the wrapper makes one device
    allocation (the four outputs share it; the tile partials' scratch is
    kept), enters no device context while the tensors' device is current,
    and the C entry sets no kernel attribute again."""
    x, y = _rand(1, (1024, 2179), cuda_device), _rand(2, (1024, 2179),
                                                      cuda_device)
    first = remd.mins(x, y, "cosine")
    setups = remd.tc_setups()
    contexts = []

    class RecordingDevice(torch.cuda.device):
        def __init__(self, *args):
            contexts.append(args)
            super().__init__(*args)

    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "device", RecordingDevice)
        again = remd.mins(x, y, "cosine")
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after == before + 1, f"{after - before} allocations"
    assert contexts == [] and remd.tc_setups() == setups
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1024, 2179), (1000, 2179), (200, 35),
                                 (130, 35)])
def test_selfsim_on_card(cuda_device, n, c):
    """K2a's loss and signs, and K2b on those signs, against the plain
    versions; K2b is bitwise repeatable."""
    x, y = _rand(n, (n, c), cuda_device), _rand(n + 1, (n, c), cuda_device)
    xh, yh, _, _, cx, cy = selfsim._prep(x, y)
    before = (_count("selfsim_fwd"), _count("selfsim_bwd"))
    loss, tx, ty, signs = selfsim.selfsim_fwd(xh, yh, cx, cy)
    p_loss, _, _, p_signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    torch.testing.assert_close(loss, p_loss, rtol=1e-5, atol=0)
    # the kernel's signs differ from the plain version's only where A - B
    # lies within rounding of 0
    diff = ((1.0 - xh @ xh.T) / cx[None, :]
            - (1.0 - yh @ yh.T) / cy[None, :]).abs()
    flips = signs != p_signs
    assert bool((diff[flips] <= 1e-5 * diff.max()).all())
    # t on the kernel's own signs: |t_j| <= sum_i |D_ij| = c_j
    s = signs.to(torch.float32)
    for t, h, cv in ((tx, xh, cx), (ty, yh, cy)):
        want_t = torch.sum(s * (1.0 - h @ h.T), dim=0)
        assert bool(((t - want_t).abs() <= 1e-5 * cv).all())
    got = selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    assert (_count("selfsim_fwd"),
            _count("selfsim_bwd")) == (before[0] + 1, before[1] + 1)
    want = selfsim.selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)

    def project(u, h):
        return u - torch.sum(u * h, dim=1, keepdim=True) * h

    for u, pu, h in zip(got, want, (xh, yh)):
        row_err = (project(u, h) - project(pu, h)).abs().amax(dim=1)
        bad = row_err > 1e-4 * project(pu, h).abs().max()
        assert int(bad.sum()) <= n // 100
    again = selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # signs whose rows are not SIGN_PITCH-aligned are refused
    if n % selfsim.SIGN_PITCH:
        with pytest.raises(ValueError, match="laid out"):
            selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1024, 2179), (1000, 2179), (200, 35)])
@pytest.mark.parametrize("split", selfsim.FWD_SPLITS)
def test_selfsim_fwd_splits_on_card(cuda_device, n, c, split):
    """K2a with each of 1, 2 and 4 blocks a tile pair (a cluster adding
    its partial Gram tiles in rank order): loss to rtol 1e-5, signs off
    the plain version's only within rounding of A - B = 0, t on its own
    signs to 1e-5 of c_j, and the same bits on a second call."""
    x, y = _rand(n + 5, (n, c), cuda_device), _rand(n + 6, (n, c),
                                                    cuda_device)
    xh, yh, _, _, cx, cy = selfsim._prep(x, y)
    got = selfsim.selfsim_fwd(xh, yh, cx, cy, split)
    again = selfsim.selfsim_fwd(xh, yh, cx, cy, split)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    loss, tx, ty, signs = got
    p_loss, _, _, p_signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    torch.testing.assert_close(loss, p_loss, rtol=1e-5, atol=0)
    diff = ((1.0 - xh @ xh.T) / cx[None, :]
            - (1.0 - yh @ yh.T) / cy[None, :]).abs()
    assert bool((diff[signs != p_signs] <= 1e-5 * diff.max()).all())
    s = signs.to(torch.float32)
    for t, h, cv in ((tx, xh, cx), (ty, yh, cy)):
        want_t = torch.sum(s * (1.0 - h @ h.T), dim=0)
        assert bool(((t - want_t).abs() <= 1e-5 * cv).all())


@pytest.mark.cuda
def test_selfsim_bwd_repeat_call_allocates_outputs_only(cuda_device,
                                                        monkeypatch):
    """A repeat K2a call makes two device allocations (loss and t share
    one, the signs the other; its scratch is kept), a repeat K2b call one
    (both outputs share it; there is no scratch); neither enters a device
    context while the tensors' device is current, and neither C entry sets
    a kernel attribute again."""
    n, c = 1024, 2179
    x, y = _rand(1, (n, c), cuda_device), _rand(2, (n, c), cuda_device)
    xh, yh, _, _, cx, cy = selfsim._prep(x, y)
    loss, tx, ty, signs = selfsim.selfsim_fwd(xh, yh, cx, cy)
    first = selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    setups = (selfsim.fwd_setups(), selfsim.bwd_setups())
    contexts = []

    class RecordingDevice(torch.cuda.device):
        def __init__(self, *args):
            contexts.append(args)
            super().__init__(*args)

    def allocations():  # outside the patch: synchronize enters a context
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()["allocation.all.allocated"]

    before = allocations()
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "device", RecordingDevice)
        fwd_again = selfsim.selfsim_fwd(xh, yh, cx, cy)
    mid = allocations()
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "device", RecordingDevice)
        again = selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    after = allocations()
    assert mid == before + 2, f"K2a: {mid - before} allocations"
    assert after == mid + 1, f"K2b: {after - mid} allocations"
    assert contexts == []
    assert (selfsim.fwd_setups(), selfsim.bwd_setups()) == setups
    for a, b in zip((loss, tx, ty, signs), fwd_again):
        assert torch.equal(a, b)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])


def _err(got, want) -> float:
    scale = want.double().abs().max().clamp_min(1e-30)
    return float((got.double() - want.double()).abs().max() / scale)


def _block1_weights(device):
    p = random_params("16", 0)
    k1 = p["block1_conv1"]["kernel"].to(device)
    k2 = p["block1_conv2"]["kernel"].to(device)
    return k1, 0.1 * _rand(1, (64,), device), k2, 0.1 * _rand(2, (64,),
                                                               device)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 53), (48, 64), (1, 1), (5, 7),
                                 (17, 33), (512, 398)])
def test_block1_on_card(cuda_device, h, w):
    torch.backends.cudnn.allow_tf32 = False
    k1, b1, k2, b2 = _block1_weights(cuda_device)
    x = _rand(h, (h, w, 3), cuda_device)
    g1, g2 = _rand(3, (h, w, 64), cuda_device), _rand(4, (h, w, 64),
                                                       cuda_device)
    before = (_count("block1_fwd"), _count("block1_bwd"))
    t1, t2 = block1.block1_fwd(x, k1, b1, k2, b2)
    dx = block1.block1_bwd(t1, t2, g1, g2, k1, k2)
    assert (_count("block1_fwd"),
            _count("block1_bwd")) == (before[0] + 1, before[1] + 1)
    p1, p2 = block1.block1_plain(x, k1, b1, k2, b2)
    assert _err(t1, p1) <= 1e-5
    assert _err(t2, p2) <= 1e-3
    assert _err(dx, block1.block1_bwd_plain(t1, t2, g1, g2, k1, k2)) <= 1e-3
    again = block1.block1_fwd(x, k1, b1, k2, b2)
    assert torch.equal(t1, again[0]) and torch.equal(t2, again[1])
    assert torch.equal(dx, block1.block1_bwd(t1, t2, g1, g2, k1, k2))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(3, 5, 7), (8, 48, 64), (2, 37, 53)])
def test_block1_pair_axis_on_card(cuda_device, b, h, w):
    """K3a and K3b on B images: one launch a direction, each image bit for
    bit its one-image launch (the walk crosses images mid-block, and the
    next tile's prefetch reads the next image), and the batch held to the
    plain version at the limits above."""
    torch.backends.cudnn.allow_tf32 = False
    k1, b1, k2, b2 = _block1_weights(cuda_device)
    x = _rand(h + b, (b, h, w, 3), cuda_device)
    g1, g2 = (_rand(5 + b, (b, h, w, 64), cuda_device),
              _rand(6 + b, (b, h, w, 64), cuda_device))
    before = (_count("block1_fwd"), _count("block1_bwd"))
    t1, t2 = block1.block1_fwd(x, k1, b1, k2, b2)
    dx = block1.block1_bwd(t1, t2, g1, g2, k1, k2)
    assert (_count("block1_fwd"),
            _count("block1_bwd")) == (before[0] + 1, before[1] + 1)
    assert t1.shape == (b, h, w, 64) and dx.shape == (b, h, w, 3)
    for i in range(b):
        o1, o2 = block1.block1_fwd(x[i], k1, b1, k2, b2)
        assert torch.equal(t1[i], o1) and torch.equal(t2[i], o2)
        assert torch.equal(dx[i], block1.block1_bwd(t1[i], t2[i], g1[i],
                                                    g2[i], k1, k2))
    p1, p2 = block1.block1_plain(x, k1, b1, k2, b2)
    assert _err(t1, p1) <= 1e-5
    assert _err(t2, p2) <= 1e-3
    assert _err(dx, block1.block1_bwd_plain(t1, t2, g1, g2, k1, k2)) <= 1e-3


@pytest.mark.cuda
def test_block1_fwd_repeat_call_does_no_setup(cuda_device, monkeypatch):
    """A repeat call with the same weights builds no layout and sets no
    kernel attribute; an in-place edit of k2 is followed."""
    k1, b1, k2, b2 = _block1_weights(cuda_device)
    k2 = k2.clone()
    x = _rand(5, (40, 24, 3), cuda_device)
    block1.block1_fwd(x, k1, b1, k2, b2)
    setups = block1.fwd_setups()
    builds = []
    real = block1.fwd_layouts
    monkeypatch.setattr(block1, "fwd_layouts",
                        lambda *a: builds.append(1) or real(*a))
    first = block1.block1_fwd(x, k1, b1, k2, b2)
    assert builds == [] and block1.fwd_setups() == setups
    k2.mul_(2)
    t1, t2 = block1.block1_fwd(x, k1, b1, k2, b2)
    assert builds == [1] and block1.fwd_setups() == setups
    assert torch.equal(t1, first[0]) and not torch.equal(t2, first[1])
    p1, p2 = block1.block1_plain(x, k1, b1, k2, b2)
    assert _err(t1, p1) <= 1e-5
    assert _err(t2, p2) <= 1e-3


@pytest.mark.cuda
def test_block1_bwd_repeat_call_does_no_setup(cuda_device, monkeypatch):
    """A repeat backward call with the same weights builds no layout and
    sets no kernel attribute; an in-place edit of k2 is followed."""
    torch.backends.cudnn.allow_tf32 = False
    k1, b1, k2, b2 = _block1_weights(cuda_device)
    k2 = k2.clone()
    x = _rand(6, (40, 24, 3), cuda_device)
    g1, g2 = _rand(7, (40, 24, 64), cuda_device), _rand(8, (40, 24, 64),
                                                         cuda_device)
    t1, t2 = block1.block1_fwd(x, k1, b1, k2, b2)
    block1.block1_bwd(t1, t2, g1, g2, k1, k2)
    setups = block1.bwd_setups()
    builds = []
    real = block1.bwd_layouts
    monkeypatch.setattr(block1, "bwd_layouts",
                        lambda *a: builds.append(1) or real(*a))
    first = block1.block1_bwd(t1, t2, g1, g2, k1, k2)
    assert builds == [] and block1.bwd_setups() == setups
    k2.mul_(2)
    dx = block1.block1_bwd(t1, t2, g1, g2, k1, k2)
    assert builds == [1] and block1.bwd_setups() == setups
    assert not torch.equal(dx, first)
    assert _err(dx, block1.block1_bwd_plain(t1, t2, g1, g2, k1, k2)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c,dist", [(300, 200, 35, "cosine"),
                                        (1000, 777, 64, "both"),
                                        (129, 65, 3, "l2")])
def test_sinkhorn_lse_on_card(cuda_device, n, m, c, dist):
    x, y = _rand(n, (n, c), cuda_device), _rand(m + 7, (m, c), cuda_device)
    logv = 5.0 * _rand(m + 9, (m,), cuda_device)
    before = _count("sinkhorn_lse")
    got = sinkhorn.lse_pass(x, y, logv, 10.0, dist)
    assert _count("sinkhorn_lse") == before + 1
    want = sinkhorn.lse_pass_plain(x, y, logv, 10.0, dist)
    assert _err(got, want) <= 1e-5
    assert torch.equal(got, sinkhorn.lse_pass(x, y, logv, 10.0, dist))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c,dist", [
    (129, 300, 40, "cosine"), (129, 300, 40, "both"), (257, 513, 64, "l2"),
    (1000, 777, 2179, "both"), (130, 70, 35, "cosine")])
def test_sinkhorn_lse_tensor_cores_ragged_on_card(cuda_device, n, m, c,
                                                  dist):
    """K4's tensor-core route at ragged shapes (a last strip of one row, a
    partial last column tile), each split from 1 to the tiles, against
    the plain version; the C entry's constants are the Python ones."""
    lib = build.library("sinkhorn")
    assert lib.sinkhorn_tc_min_c() == sinkhorn.TC_MIN_C
    assert lib.sinkhorn_prep_channels(c) == sinkhorn.prep_channels(c)
    x, y = _rand(n, (n, c), cuda_device), _rand(m + 7, (m, c), cuda_device)
    logv = 5.0 * _rand(m + 9, (m,), cuda_device)
    prep = sinkhorn.prepare(x, y)
    want = sinkhorn.lse_pass_plain(x, y, logv, 10.0, dist)
    tiles = -(-m // sinkhorn.tile_shape(c)[1])
    for split in range(1, min(tiles, 4) + 1):
        got = sinkhorn.lse_pass(x, y, logv, 10.0, dist, prep, split)
        assert _err(got, want) <= 1e-5, split


@pytest.mark.cuda
@pytest.mark.parametrize("c", [35, 3])
def test_sinkhorn_prepared_form_on_card(cuda_device, c):
    """The prepared operands are prepare_plain's layout (parts bit for bit,
    norms to float32 rounding), and passes that reuse them give the bits
    of calls that prepare their own, in both orientations."""
    x, y = _rand(3, (300, c), cuda_device), _rand(4, (200, c), cuda_device)
    lu, lv = _rand(5, (300,), cuda_device), _rand(6, (200,), cuda_device)
    before = _count("sinkhorn_prep")
    px, py = sinkhorn.prepare(x, y)
    assert _count("sinkhorn_prep") == before + 1
    for got, want in ((px, sinkhorn.prepare_plain(x)),
                      (py, sinkhorn.prepare_plain(y))):
        assert torch.equal(got.parts, want.parts)
        assert _err(got.norms, want.norms) <= 1e-6
    for _ in range(2):
        assert torch.equal(
            sinkhorn.lse_pass(x, y, lv, 10.0, "both", (px, py)),
            sinkhorn.lse_pass(x, y, lv, 10.0, "both"))
        assert torch.equal(
            sinkhorn.lse_pass(y, x, lu, 10.0, "both", (py, px)),
            sinkhorn.lse_pass(y, x, lu, 10.0, "both"))


@pytest.mark.cuda
def test_sinkhorn_lse_repeat_call_allocates_output_only(cuda_device,
                                                        monkeypatch):
    """With the operands prepared, a repeated call on the same stream makes
    one device allocation (its output; the chunks' partials are kept),
    enters no device context, and the C entry sets no kernel attribute
    again."""
    x, y = _rand(1, (1024, 2179), cuda_device), _rand(2, (1000, 2179),
                                                      cuda_device)
    logv = _rand(3, (1000,), cuda_device)
    prep = sinkhorn.prepare(x, y)
    first = sinkhorn.lse_pass(x, y, logv, 10.0, "cosine", prep)
    setups = sinkhorn.tc_setups()
    contexts = []

    class RecordingDevice(torch.cuda.device):
        def __init__(self, *args):
            contexts.append(args)
            super().__init__(*args)

    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "device", RecordingDevice)
        again = sinkhorn.lse_pass(x, y, logv, 10.0, "cosine", prep)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after == before + 1, f"{after - before} allocations"
    assert contexts == [] and sinkhorn.tc_setups() == setups
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["cosine", "both"])
def test_sinkhorn_streamed_on_card(cuda_device, dist):
    x, y = _rand(1, (1000, 64), cuda_device), _rand(2, (1000, 64),
                                                    cuda_device)
    before = (_count("sinkhorn_lse"), _count("sinkhorn_prep"))
    got = losses.sinkhorn(x, y, dist, 10.0, 30, impl="kernel")
    assert _count("sinkhorn_lse") == before[0] + 60
    assert _count("sinkhorn_prep") == before[1] + 1
    want = losses.sinkhorn(x, y, dist, 10.0, 30, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_masked_step_on_card(cuda_device):
    """One masked step at full width (VGG16, the 9 taps, 1024 samples, the
    bf16 policy) with 2 regions at 48 x 64: the kernels' losses against
    the plain versions' on the same features, targets and coordinates to
    rtol 1e-3 (float32 sums in another order, as chip_smoke's slice
    phase), with K1 launched twice and K2a, K2b once a region."""
    from strotss_torch import StrotssConfig, programs
    from strotss_torch.models.vgg import VGG
    from strotss_torch.ops import sampling
    from strotss_torch.ops.image import (fold_laplacian_pyramid,
                                         make_laplacian_pyramid)

    cfg = StrotssConfig(levels=1, max_iter=1)
    spec = programs.spec_from_config(cfg, cuda_device, masked=True)
    plain = spec._replace(remd_impl="plain", selfsim_impl="plain",
                          moments_impl="plain")
    programs.set_precision(spec)
    params = {k: {n: t.to(cuda_device) for n, t in p.items()}
              for k, p in random_params("16", 0).items()}
    vgg = VGG(params, taps=spec.taps, compute_dtype=spec.compute_dtype,
              block1_impl=spec.block1_impl)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    content = torch.rand(1, 48, 64, 3, generator=gen, device=cuda_device)
    style = torch.rand(1, 64, 56, 3, generator=gen, device=cuda_device)
    cm = torch.zeros(2, 48, 64, device=cuda_device)
    cm[0, :24], cm[1, 24:] = 1.0, 1.0
    sm = torch.zeros(2, 64, 56, device=cuda_device)
    sm[0, :, :28], sm[1, :, 28:] = 1.0, 1.0
    with torch.no_grad():
        cf = programs.extract_hypercolumn(vgg, content)
        sf = programs.extract_hypercolumn(vgg, style)
        targets = torch.stack([sampling.sample_style(
            sampling.full_grid_coords(gen, (64, 56), 1024, cuda_device,
                                      mask=m), sf) for m in sm])
        moments = [losses.moment_stats(t, spec.moments_impl)
                   for t in targets]
        moments_p = [losses.moment_stats(t, "plain") for t in targets]
    coords = torch.stack([sampling.strided_grid_coords(
        gen, (48, 64), 1024, cuda_device, mask=m) for m in cm])
    leaves = [p.requires_grad_(True)
              for p in make_laplacian_pyramid(content * 0.5 + 0.25, 5)]
    pred = programs.extract_hypercolumn(vgg, fold_laplacian_pyramid(leaves))
    counted = ("remd_mins", "selfsim_fwd", "selfsim_bwd")
    before = [_count(k) for k in counted]
    got = programs.step_losses(spec, cf, pred, targets, moments, 16.0,
                               coords)
    grads = torch.autograd.grad(got[0], leaves)
    assert [_count(k) - b for k, b in zip(counted, before)] == [4, 2, 2]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        want = programs.step_losses(plain, cf, pred, targets, moments_p,
                                    16.0, coords)
    np.testing.assert_allclose([float(v.detach()) for v in got],
                               [float(v) for v in want], rtol=1e-3)


def _launches():
    return {k: _count(k) for k in ("remd_mins", "selfsim_fwd", "selfsim_bwd",
                                   "block1_fwd", "block1_bwd")}


def _graph_steps():
    """The steps replayed from a CUDA graph and the graphs captured so
    far."""
    now = timing.counters()
    return now.get("graph.replay", 0), now.get("graph.capture", 0)


def _issued(steps, since):
    """Of ``steps`` steps run since the reading ``since`` of
    :func:`_graph_steps`, those whose launches the wrappers count: a
    replayed step launches nothing through them, a captured one once."""
    replays, captures = _graph_steps()
    return steps - (replays - since[0]) + (captures - since[1])


def _counted_run(content, style, cfg, **kw):
    import strotss_torch

    before = _launches()
    img, info = strotss_torch.stylize(content, style, cfg,
                                      vgg_params=random_params("16", 0),
                                      device="cuda", **kw)
    torch.cuda.synchronize()
    return img, info, {k: v - before[k] for k, v in _launches().items()}


def _small_images():
    rng = np.random.default_rng(0)
    return (rng.random((1, 48, 64, 3)).astype(np.float32),
            rng.random((1, 64, 56, 3)).astype(np.float32),
            rng.random((1, 40, 72, 3)).astype(np.float32))


@pytest.mark.cuda
def test_blended_run_on_card(cuda_device):
    """Two styles at 0.7/0.3, 2 scales x 3 steps at full width: K1 twice,
    K2a, K2b and K3b once a step, K3a once a step and once an image a
    scale (3 images); a step replayed from a CUDA graph launches nothing
    through the wrappers, a captured one once."""
    from strotss_torch import StrotssConfig

    content, style, style2 = _small_images()
    cfg = StrotssConfig(levels=2, max_iter=3)
    since = _graph_steps()
    img, info, got = _counted_run(content, [style, style2], cfg,
                                  style_weights=[0.7, 0.3])
    n = _issued(6, since)
    assert got == {"remd_mins": 2 * n, "selfsim_fwd": n, "selfsim_bwd": n,
                   "block1_fwd": n + 3 * 2, "block1_bwd": n}
    assert all(np.all(np.isfinite(s["curve"])) for s in info["scales"])
    assert img.dtype == torch.uint8 and img.is_cuda


@pytest.mark.cuda
def test_resume_on_card(cuda_device, tmp_path):
    """A run copies its checkpoint aside after scale 64's first chunk; a
    resume from the copy takes up at step 3 (its first loss, a forward
    from the restored state, is the run's step 3) and launches only what
    is left."""
    import dataclasses
    import shutil

    from strotss_torch import StrotssConfig

    content, style, _ = _small_images()
    ck, aside = str(tmp_path / "ck"), str(tmp_path / "aside")
    cfg = StrotssConfig(levels=2, max_iter=4, log_every=2, checkpoint_dir=ck)
    seen = {}

    def progress(scl, done, total, m):
        seen[(scl, done)] = m["loss"]
        if (scl, done) == (64, 2):
            shutil.copytree(ck, aside)

    _counted_run(content, style, cfg, progress_cb=progress)
    _, info, got = _counted_run(
        content, style, dataclasses.replace(cfg, checkpoint_dir=aside))
    assert got == {"remd_mins": 12, "selfsim_fwd": 6, "selfsim_bwd": 6,
                   "block1_fwd": 6 + 2 * 2, "block1_bwd": 6}
    first = float(info["scales"][0]["curve"][0, 0])
    assert first == pytest.approx(seen[(64, 3)], rel=1e-5)


@pytest.mark.cuda
def test_remat_launches_on_card(cuda_device):
    """Under remat K3a runs twice a step (the backward recomputes it), and
    every step runs eagerly."""
    import dataclasses

    from strotss_torch import StrotssConfig

    content, style, _ = _small_images()
    cfg = StrotssConfig(levels=1, max_iter=3)
    counts = []
    for remat in (False, True):
        since = _graph_steps()
        _, info, got = _counted_run(content, style,
                                    dataclasses.replace(cfg, remat=remat))
        # a step replayed from a CUDA graph launches nothing through the
        # wrappers; a run under remat runs every step eagerly
        n = _issued(3, since)
        counts.append((got["block1_fwd"], n))
        assert got["block1_bwd"] == n
        assert np.all(np.isfinite(info["scales"][0]["curve"]))
    assert counts == [(counts[0][1] + 2, counts[0][1]), (2 * 3 + 2, 3)]


@pytest.mark.cuda
def test_batch_launches_on_card(cuda_device):
    """3 pairs, 2 scales x 3 steps at full width: K1 twice, K2a and K2b
    once a pair a step; K3a once a step for all pairs and once a scale for
    the contents and once for the styles; K3b once a step. Each pair's
    first step is its single run's."""
    import dataclasses

    from strotss_torch import StrotssConfig
    from strotss_torch.parallel import stylize_batch
    from strotss_torch.solve import stylize_single

    rng = np.random.default_rng(1)
    contents = rng.random((3, 48, 64, 3)).astype(np.float32)
    styles = rng.random((3, 64, 56, 3)).astype(np.float32)
    cfg = StrotssConfig(levels=2, max_iter=3)
    before, since = _launches(), _graph_steps()
    img, info = stylize_batch(contents, styles, cfg,
                              vgg_params=random_params("16", 0),
                              alphas=[0.5, 1.0, 4.0], pair_seeds=[1, 2, 3],
                              device="cuda")
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launches().items()}
    n = _issued(6, since)
    assert got == {"remd_mins": 2 * 3 * n, "selfsim_fwd": 3 * n,
                   "selfsim_bwd": 3 * n, "block1_fwd": n + 2 * 2,
                   "block1_bwd": n}
    assert img.shape == (3, 96, 128, 3) and img.dtype == torch.uint8
    for b, (alpha, seed) in enumerate(zip([0.5, 1.0, 4.0], [1, 2, 3])):
        _, one = stylize_single(
            torch.tensor(contents[b:b + 1], device="cuda"),
            torch.tensor(styles[b:b + 1], device="cuda"),
            dataclasses.replace(cfg, alpha=alpha, seed=seed, levels=1,
                                max_iter=1),
            random_params("16", 0))
        np.testing.assert_allclose(info["scales"][0]["curve"][0, b],
                                   one["scales"][0]["curve"][0], rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 3])
def test_sharded_remd_on_card(cuda_device, p):
    """The sample-sharded REMD (``strotss_torch.parallel.transport``) over
    p ranks sharing the card over gloo, each running K1 on its shard of
    y's rows (at p = 3, 1000 rows: 334/333/333): the value to rtol 1e-5
    and both gradients to 1e-4 of max|g| of the unsharded K1 REMD on this
    process, one K1 launch a rank. Ranks come from the launcher; their
    function is in ``tests/torch_ranks.py``."""
    import torch_ranks as R
    from strotss_torch.parallel.launch import launch

    m = 1000 if p == 3 else 512
    rng = np.random.default_rng(p)
    cases = [(rng.standard_normal((n, c)).astype(np.float32),
              rng.standard_normal((mm, c)).astype(np.float32), dist)
             for dist, c in (("cosine", 2179), ("l2", 64), ("both", 3))
             for n, mm in ((3 * m // 2, m), (m // 2, 2 * m))]
    ranks = launch(R.sharded_remd, ["cuda:0"] * p, args=(cases, "cuda:0"),
                   timeout=120)
    for k, (x, y, dist) in enumerate(cases):
        xt = torch.tensor(x, device=cuda_device, requires_grad=True)
        yt = torch.tensor(y, device=cuda_device, requires_grad=True)
        ref = losses.relaxed_emd(xt, yt, dist, impl="kernel")
        gx, gy = torch.autograd.grad(ref, [xt, yt])
        for value, dx, dy, launches in (r[k] for r in ranks):
            assert launches == 1
            np.testing.assert_allclose(value, ref.item(), rtol=1e-5)
            for g, want in ((dx, gx), (dy, gy)):
                want = want.cpu().numpy()
                np.testing.assert_allclose(
                    g, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_block1_on_spatial_slabs_on_card(cuda_device):
    """K3a and K3b on the 'spatial' slabs of a 384x512 image (192/192 rows
    on 2 ranks sharing the card over gloo, 4 extra rows a side;
    ``Slab.fused_block1``): the taps on each rank's rows against the
    whole image's K3a launch (tap1 to 1e-5 of max, tap2 1e-3), and the
    image gradient, each rank's K3b dx on its own rows from the whole
    image's cotangents summed by the slice's all-reduce, against the
    whole image's K3b (1e-3 of max)."""
    import torch_ranks as R
    from strotss_torch.parallel.launch import launch

    rng = np.random.default_rng(5)

    def f(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    case = (f(1, 384, 512, 3), f(64, 3, 3, 3, s=0.3), f(64, s=0.1),
            f(64, 64, 3, 3, s=0.05), f(64, s=0.1), f(1, 384, 512, 64),
            f(1, 384, 512, 64))
    ranks = launch(R.spatial_block1, ["cuda:0"] * 2,
                   args=([case], "cuda:0", "auto", 4), timeout=120)
    x, k1, b1, k2, b2, g1, g2 = (torch.tensor(a, device=cuda_device)
                                 for a in case)
    t1, t2 = block1.block1_fwd(x, k1, b1, k2, b2)
    dx = block1.block1_bwd(t1, t2, g1, g2, k1, k2).cpu().numpy()
    for got, want, frac in ((1, t1, 1e-5), (2, t2, 1e-3)):
        want = want.cpu().numpy()
        have = np.concatenate([r[0][got - 1] for r in ranks], axis=1)
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=frac * np.abs(want).max())
    for r in ranks:
        np.testing.assert_allclose(r[0][2], dx, rtol=0,
                                   atol=1e-3 * np.abs(dx).max())


#: the 512 px scale's hypercolumn as the default run samples it: the image
#: and block1's taps NHWC float32, blocks 2-5 NHWC views of NCHW bf16 maps
#: (h, w, C, dtype, NCHW-backed)
_K5_MAPS = ((384, 512, 3, torch.float32, False),
            (384, 512, 64, torch.float32, False),
            (384, 512, 64, torch.float32, False),
            (192, 256, 128, torch.bfloat16, True),
            (192, 256, 128, torch.bfloat16, True),
            (96, 128, 256, torch.bfloat16, True),
            (96, 128, 256, torch.bfloat16, True),
            (96, 128, 256, torch.bfloat16, True),
            (48, 64, 512, torch.bfloat16, True),
            (24, 32, 512, torch.bfloat16, True))


def _k5_maps(seed, device, batch=1):
    """(batch, h, w, C) maps of ``_K5_MAPS``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    maps = []
    for h, w, c, dtype, nchw in _K5_MAPS:
        if nchw:
            m = torch.randn(batch, c, h, w, generator=gen, device=device)
            maps.append(m.to(dtype).permute(0, 2, 3, 1))
        else:
            maps.append(torch.randn(batch, h, w, c, generator=gen,
                                    device=device).to(dtype))
    return maps


def _k5_check_grads(coords, ys, g, grads):
    """Each map's gradient: its mirror's bit for bit, within sum_bound of
    the float64 gradient of the plain route."""
    side = sampling._side(ys, True, True)
    y64 = [y.detach().double().requires_grad_() for y in ys]
    rows64 = sampling.sample_hypercolumn(y64, coords, True, True)
    want = torch.autograd.grad(rows64, y64, g.double(), retain_graph=True)
    # the weights are >= 0: this is sum |t| over each pixel's terms
    mags = torch.autograd.grad(rows64, y64, g.double().abs())
    col = 0
    for y, got, w64, a64, fac, near in zip(ys, grads, want, mags,
                                           side.factors, side.nearest):
        h, w, c = y.shape[-3:]
        gm = gather.grad_mirror(g[:, col:col + c].contiguous(), coords,
                                (h, w, c), fac, near, y.dtype)
        assert torch.equal(got.reshape(h, w, c), gm)
        bound = gather.sum_bound(w64.reshape(h, w, c), a64.reshape(h, w, c),
                                 gather.term_counts(coords, (h, w, c), fac,
                                                    near), y.dtype)
        err = (got.reshape(h, w, c).double() - w64.reshape(h, w, c)).abs()
        assert bool((err <= bound).all())
        col += c


@pytest.mark.cuda
def test_gather_rows_bit_for_bit_on_card(cuda_device):
    """K5's forward at the 512 px scale's 10 maps, n = 1024: both sides'
    rows in one launch, bit for bit the plain route's; the style targets
    (nearest at every factor) likewise."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    xs, ys = _k5_maps(1, cuda_device), _k5_maps(2, cuda_device)
    coords = sampling.strided_grid_coords(gen, (384, 512), 1024, cuda_device)
    before = _count("gather_fwd")
    got = sampling.sample_paired(coords, xs, ys, "kernel")
    assert _count("gather_fwd") == before + 1
    want = sampling.sample_paired(coords, xs, ys, "plain")
    assert got[0].shape == (1024, 2179)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = sampling.full_grid_coords(gen, (384, 512), 1024, cuda_device)
    assert torch.equal(sampling.sample_style(full, ys, "kernel"),
                       sampling.sample_style(full, ys, "plain"))


@pytest.mark.cuda
def test_gather_rows_on_unbind_views_on_card(cuda_device):
    """An 8-pair batch's maps as the batched step takes them (``unbind``
    views at an offset, no copies): pair 5's rows bit for bit."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    xs = [m.unbind(0)[5] for m in _k5_maps(5, cuda_device, batch=8)]
    ys = [m.unbind(0)[5] for m in _k5_maps(6, cuda_device, batch=8)]
    coords = sampling.strided_grid_coords(gen, (384, 512), 1024, cuda_device)
    got = sampling.sample_paired(coords, xs, ys, "kernel")
    want = sampling.sample_paired(coords, xs, ys, "plain")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_gather_backward_on_card(cuda_device):
    """K5's backward at the 512 px scale, n = 1024: two launches a call,
    each map's gradient dense in its own dtype and layout, bit for bit its
    mirror and within one unit in the last place (plus float32's summation
    bound) of the float64 gradient; bitwise the same in a second call; the
    scratch's keys in the mirror's order."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    xs = _k5_maps(1, cuda_device)
    ys = [m.requires_grad_() for m in _k5_maps(2, cuda_device)]
    coords = sampling.strided_grid_coords(gen, (384, 512), 1024, cuda_device)
    g = torch.randn(1024, 2179, generator=gen, device=cuda_device)
    before = _count("gather_bwd")
    rows = sampling.sample_paired(coords, xs, ys, "kernel")[1]
    grads = torch.autograd.grad(rows, ys, g)
    assert _count("gather_bwd") == before + 2
    for y, got in zip(ys, grads):
        assert got.dtype == y.dtype and got.stride() == y.stride()
    again = torch.autograd.grad(
        sampling.sample_paired(coords, xs, ys, "kernel")[1], ys, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _k5_check_grads(coords, ys, g, grads)
    side = sampling._side(ys, True, True)
    plan = gather._plan([side], coords.get_device())
    _, scratch = gather.backward(coords, plan, tuple(range(len(ys))), [g])
    keys = scratch.view(-1, 2)
    off = 0
    for y, fac, near in zip(ys, side.factors, side.nearest):
        h, w = y.shape[-3:-1]
        pix, _ = gather.corner_keys(coords, h, w, fac, near)
        order = gather.key_order(pix)
        k = keys[off:off + pix.shape[0]].long()
        assert torch.equal(k[:, 1], order) and torch.equal(k[:, 0], pix[order])
        off += pix.shape[0]


@pytest.mark.cuda
def test_gather_large_n_on_card(cuda_device):
    """n = 32769 (the --sinkhorn path above the gate), more samples than
    the 384 x 512 grid's points, so coordinates repeat: rows bit for bit,
    gradients bit for bit their mirror."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(9)
    xs = _k5_maps(3, cuda_device)
    ys = [m.requires_grad_() for m in _k5_maps(4, cuda_device)]
    coords = sampling.strided_grid_coords(gen, (384, 512), 32769,
                                          cuda_device)
    got = sampling.sample_paired(coords, xs, ys, "kernel")
    want = sampling.sample_paired(coords, xs, ys, "plain")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g = torch.randn(32769, 2179, generator=gen, device=cuda_device)
    grads = torch.autograd.grad(got[1], ys, g)
    side = sampling._side(ys, True, True)
    col = 0
    for y, got_g, fac, near in zip(ys, grads, side.factors, side.nearest):
        h, w, c = y.shape[-3:]
        want_g = gather.grad_mirror(g[:, col:col + c].contiguous(), coords,
                                    (h, w, c), fac, near, y.dtype)
        assert torch.equal(got_g.reshape(h, w, c), want_g)
        col += c


@pytest.mark.cuda
def test_gather_launches_in_runs_on_card(cuda_device):
    """Every paired and style sample of a run goes through K5: a forward a
    region a pair a step plus one a region a pair a scale for the style
    targets, two backward launches a region a pair a step (a single run
    with 2 regions and a 3-pair batch, 2 scales x 3 steps; the batch's
    steps replayed from a CUDA graph launch nothing through the
    wrappers)."""
    import strotss_torch
    from strotss_torch import StrotssConfig
    from strotss_torch.parallel import stylize_batch

    content, style, _ = _small_images()
    cfg = StrotssConfig(levels=2, max_iter=3)
    cm = np.zeros((2, 48, 64, 1), np.float32)
    cm[0, :24], cm[1, 24:] = 1.0, 1.0
    sm = np.zeros((2, 64, 56, 1), np.float32)
    sm[0, :, :28], sm[1, :, 28:] = 1.0, 1.0
    before = (_count("gather_fwd"), _count("gather_bwd"))
    strotss_torch.stylize(content, style, cfg,
                          vgg_params=random_params("16", 0), device="cuda",
                          content_masks=cm, style_masks=sm)
    assert (_count("gather_fwd") - before[0],
            _count("gather_bwd") - before[1]) == (2 * 6 + 2 * 2, 2 * 2 * 6)
    rng = np.random.default_rng(1)
    before = (_count("gather_fwd"), _count("gather_bwd"))
    since = _graph_steps()
    stylize_batch(rng.random((3, 48, 64, 3)).astype(np.float32),
                  rng.random((3, 64, 56, 3)).astype(np.float32), cfg,
                  vgg_params=random_params("16", 0), alphas=[0.5, 1.0, 4.0],
                  pair_seeds=[1, 2, 3], device="cuda")
    n = _issued(6, since)
    assert (_count("gather_fwd") - before[0],
            _count("gather_bwd") - before[1]) == (3 * n + 3 * 2, 2 * 3 * n)
