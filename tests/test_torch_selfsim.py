"""The self-similarity kernels' sign interface, K2b's arithmetic and its
layouts, checked on the CPU.

K2a (``csrc/selfsim.cu``) hands the signs s = sign(A - B) it summed t over
to K2b, which builds H = G + G^T from them, G_ij taking one of three
values of column j by s_ij (the "tables", formed with the plain version's
float32 operations), and forms H x^ as K1 does its products: each value
split into TF32 parts, big.big + big.small + small.big summed exactly a
32-sample stage at a time, each stage's sums added in float32. These tests
hold the plain versions to the new interface, H as the kernel builds it to
the plain version's H bit for bit, the three-product sum (emulated in
float64) to the plain version, float64 and the JAX kernel, and the maps
K2b's loops are written from. The kernel itself runs only on a card
(``test_torch_cuda.py``).

Tolerances: the emulated product to 1e-5 of max|u| from the plain float32
version, and no further from float64 (of the same float32 H) than twice
the plain version; against the JAX kernel, after the pull-back's
projection, to 1e-4 of max|g| (the JAX backward computes its signs again,
and the diagonal's A_ii - B_ii is rounding noise that the projection
removes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strotss_torch.ops.kernels import remd, selfsim
from strotss_tpu.ops.kernels import selfsim as jselfsim


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _prepped(n, c, seed):
    x, y = _rand(seed, (n, c)), _rand(seed + 1, (n, c))
    xh, yh, _, _, cx, cy = selfsim._prep(torch.tensor(x), torch.tensor(y))
    return x, y, xh, yh, cx, cy


def _h_as_built(signs, cv, tv, n, neg):
    """H as K2b builds it: G's three values per column j (csrc/selfsim.cu
    `g_table`), G[i, j] = W[j, s_ij + 1], then G + G^T."""
    p = 1.0 / cv
    q = tv / (cv * cv)
    w = torch.stack([((k - 1.0) * p - q) / n for k in range(3)], dim=1)
    if neg:
        w = -w
    idx = signs.long() + 1
    g = w[torch.arange(n)[None, :], idx]
    return g + g.T


def _three_products(h, v):
    """K2b's product emulated: H and v split into TF32 parts, big.big +
    big.small + small.big summed in float64 over one 32-sample stage and
    rounded to float32, the stages' sums added in float32 in order."""
    hb, hs = (a.double() for a in remd.tf32_split(h))
    vb, vs = (a.double() for a in remd.tf32_split(v))
    acc = torch.zeros(v.shape, dtype=torch.float32)
    for r0 in range(0, h.shape[0], selfsim.SB_KC):
        st = slice(r0, r0 + selfsim.SB_KC)
        part = hb[:, st] @ (vb[st] + vs[st]) + hs[:, st] @ vb[st]
        acc = acc + part.float()
    return acc


@pytest.mark.parametrize("n,c", [(96, 20), (130, 35)])
def test_fwd_plain_signs_are_the_sign_of_a_minus_b(n, c):
    _, _, xh, yh, cx, cy = _prepped(n, c, n)
    _, tx, ty, signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    diff = (1.0 - xh @ xh.T) / cx[None, :] - (1.0 - yh @ yh.T) / cy[None, :]
    assert signs.dtype == torch.int8
    assert torch.equal(signs, torch.sign(diff).to(torch.int8))
    assert int((signs == 0).sum()) < n  # zeros only where A - B is 0


@pytest.mark.parametrize("n,c", [(96, 20), (130, 35)])
def test_bwd_plain_on_the_signs_equals_the_recompute(n, c):
    """Given the forward's signs, the plain backward is the old formula,
    which took the signs again from D, bit for bit."""
    _, _, xh, yh, cx, cy = _prepped(n, c, n + 2)
    _, tx, ty, signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    s = torch.sign((1.0 - xh @ xh.T) / cx[None, :]
                   - (1.0 - yh @ yh.T) / cy[None, :])
    gx = (s / cx[None, :] - (tx / (cx * cx))[None, :]) / n
    gy = (-s / cy[None, :] + (ty / (cy * cy))[None, :]) / n
    ux, uy = selfsim.selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)
    assert torch.equal(ux, (gx + gx.T) @ xh)
    assert torch.equal(uy, (gy + gy.T) @ yh)


@pytest.mark.parametrize("n,c", [(130, 35), (1000, 2179), (333, 2179)])
def test_h_as_built_is_the_plain_h(n, c):
    """K2b's tables and selects give the plain version's G + G^T bit for
    bit, for x and for y (whose G is the negated formula on c_y, t_y)."""
    _, _, xh, yh, cx, cy = _prepped(n, c, 3 * n)
    _, tx, ty, signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    ux, uy = selfsim.selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)
    assert torch.equal(ux, _h_as_built(signs, cx, tx, n, False) @ xh)
    assert torch.equal(uy, _h_as_built(signs, cy, ty, n, True) @ yh)


def _rel_max(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n,c", [(130, 35), (1000, 2179), (333, 2179)])
def test_three_products_give_the_backward(n, c):
    """The emulated kernel against the plain version and float64; at
    130 x 35 also against the JAX kernel's two sweeps (interpret mode)."""
    x, y, xh, yh, cx, cy = _prepped(n, c, 5 * n)
    _, tx, ty, signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    plain = selfsim.selfsim_bwd_plain(xh, yh, cx, cy, tx, ty, signs)
    got = []
    for v, cv, tv, neg, p in ((xh, cx, tx, False, plain[0]),
                              (yh, cy, ty, True, plain[1])):
        h = _h_as_built(signs, cv, tv, n, neg)
        u = _three_products(h, v)
        ref = h.double() @ v.double()
        assert _rel_max(u, p.double()) <= 1e-5
        assert _rel_max(u, ref) <= 2.0 * _rel_max(p, ref)
        got.append(u)
    if n == 130:
        jloss, res, _ = jselfsim._fwd_impl(jnp.asarray(x), jnp.asarray(y),
                                           True)
        _, _, _, _, xp, yp, cxp, cyp, jtx, jty, n_, np_, cp, tn = res
        ju = jselfsim._bwd_call(xp, yp, cxp, cyp, jtx, jty, n_, np_, cp, tn,
                                False, True)
        jv = jselfsim._bwd_call(xp, yp, cxp, cyp, jtx, jty, n_, np_, cp, tn,
                                True, True)
        for u, i, hh in ((got[0], 0, xh), (got[1], 1, yh)):
            want = torch.tensor(np.asarray(ju[i] + jv[i])[:n, :c])

            def project(a):
                return a - torch.sum(a * hh, dim=1, keepdim=True) * hh

            err = (project(u) - project(want)).abs().max()
            assert float(err) <= 1e-4 * float(project(want).abs().max())


def test_bwd_tile_map_covers_the_block_tile_once():
    """The 8 warps' accumulators cover the 64 x 128 tile once; each
    accumulator's A registers hold its row of H and its B registers its
    channel of x^."""
    seen = [selfsim.bwd_tile_rc(w, lane, mb, nb, i) for w in range(8)
            for lane in range(32) for mb in range(2) for nb in range(4)
            for i in range(4)]
    assert len(set(seen)) == len(seen) == selfsim.SB_BM * selfsim.SB_BN
    for w in range(8):
        for lane in range(32):
            for mb in range(2):
                for nb in range(4):
                    for i in range(4):
                        o, ch = selfsim.bwd_tile_rc(w, lane, mb, nb, i)
                        r, n = remd.frag_c(lane, i)
                        # C row r is A row r (lane 4 (r % 8) + t, register
                        # r // 8), C column n is B column n (lane 4 n + t)
                        for t in range(4):
                            a = selfsim.bwd_smem_a(w, 4 * (r % 8) + t, mb,
                                                   r // 8, 0)
                            assert a // selfsim.SB_LDH == o
                            b = selfsim.bwd_smem_b(w, 4 * n + t, nb, 0, 0)
                            assert divmod(b, selfsim.SB_LDX) == (t, ch)


def _conflicts_32(words):
    """Most distinct 32-bit words one bank serves in a warp-wide read."""
    banks = {}
    for wd in set(words):
        banks.setdefault(wd % 32, set()).add(wd)
    return max(len(v) for v in banks.values())


def _conflicts_64(pairs):
    """The same for a 64-bit read: each half-warp is served apart."""
    worst = 0
    for half in (pairs[:16], pairs[16:]):
        worst = max(worst, _conflicts_32([2 * p for p in half]
                                         + [2 * p + 1 for p in half]))
    return worst


@pytest.mark.parametrize("c", [2179, 2178, 2177, 2048])
def test_bwd_fragment_reads_are_free_of_bank_conflicts(c):
    """A fragments (one 64-bit (big, small) read each) and B fragments (x^
    at its channel column: the 4-byte copies put channel k at column k for
    every C) touch each bank once a read, and stay inside the tiles."""
    for w in range(8):
        for kk in range(0, selfsim.SB_KC, 8):
            for mb in range(2):
                for i in range(4):
                    pairs = [selfsim.bwd_smem_a(w, lane, mb, i, kk)
                             for lane in range(32)]
                    assert _conflicts_64(pairs) == 1
                    assert all(p % selfsim.SB_LDH < selfsim.SB_KC
                               and p < selfsim.SB_BM * selfsim.SB_LDH
                               for p in pairs)
            for nb in range(4):
                for i in range(2):
                    offs = [selfsim.bwd_smem_b(w, lane, nb, i, kk)
                            for lane in range(32)]
                    assert _conflicts_32(offs) == 1
                    assert all(o % selfsim.SB_LDX < selfsim.SB_BN
                               and o < selfsim.SB_KC * selfsim.SB_LDX
                               for o in offs)
    # the copies: thread tid's q-th copy reads channel c0 + ch of row r0 + k
    # (consecutive threads, consecutive addresses) and lands at k, ch
    at = {}
    for tid in range(selfsim.SB_THREADS):
        for q in range(selfsim.SB_KC // 2):
            k, ch, off = selfsim.bwd_x_copy(tid, q)
            at[(k, ch)] = off
            assert off == k * selfsim.SB_LDX + ch
    assert len(at) == selfsim.SB_KC * selfsim.SB_BN
    assert len(set(at.values())) == len(at)


def test_bwd_h_build_and_sign_tiles():
    """The threads build each of a stage's 64 x 32 H elements once, write
    them on distinct banks (64-bit), read s[o, r] bytes without conflict
    and s[r, o .. o + 7] at most 2-way (one 8-byte read a stage; rows of
    16-byte aligned tiles cannot spread 16 of them further); the 16-byte
    sign copies fill each tile once, at 16-byte aligned offsets."""
    built = set()
    for w in range(8):
        for j in range(8):
            rows = [selfsim.bwd_h_build(w, lane, j) for lane in range(32)]
            for o, r, pair, _, _ in rows:
                assert pair == o * selfsim.SB_LDH + r
                built.add((o, r))
            assert _conflicts_64([row[2] for row in rows]) == 1
            assert _conflicts_32([row[3] // 4 for row in rows]) == 1
        s2 = [selfsim.bwd_h_build(w, lane, 0)[4] for lane in range(32)]
        assert all(b % 8 == 0 for b in s2)
        assert _conflicts_64([b // 8 for b in s2]) <= 2
    assert built == {(o, r) for o in range(selfsim.SB_BM)
                     for r in range(selfsim.SB_KC)}
    chunks = {1: set(), 2: set()}
    for tid in range(selfsim.SB_THREADS):
        tile, row, col, off = selfsim.bwd_sign_copy(tid)
        assert off % 16 == 0
        pitch = selfsim.SB_S1 if tile == 1 else selfsim.SB_S2
        assert off == row * pitch + col
        chunks[tile].add((row, col))
    assert chunks[1] == {(i, 16 * h) for i in range(selfsim.SB_BM)
                         for h in range(2)}
    assert chunks[2] == {(k, 16 * h) for k in range(selfsim.SB_KC)
                         for h in range(4)}
