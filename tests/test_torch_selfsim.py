"""The self-similarity kernels' sign interface, the arithmetic of K2a and
K2b and their layouts, checked on the CPU.

K2a (``csrc/selfsim.cu``) forms the Gram tiles of x^ and y^ on and above
the diagonal only, each as K1 forms its products (TF32 parts, big.big +
big.small + small.big summed exactly a 32-channel stage at a time, each
stage's sums added in float32), takes both orientations of a tile pair
from one tile with the plain version's float32 epilogue, and hands the
signs s = sign(A - B) it summed t over to K2b, which builds H = G + G^T from them, G_ij taking one of three
values of column j by s_ij (the "tables", formed with the plain version's
float32 operations), and forms H x^ as K1 does its products: each value
split into TF32 parts, big.big + big.small + small.big summed exactly a
32-sample stage at a time, each stage's sums added in float32. These tests
hold the plain versions to the new interface, H as the kernel builds it to
the plain version's H bit for bit, the three-product sum (emulated in
float64) to the plain version, float64 and the JAX kernel, and the maps
K2b's loops are written from. The kernel itself runs only on a card
(``test_torch_cuda.py``).

Tolerances: K2a emulated, the loss to rtol 1e-5 of the plain version and
of the JAX kernel; its signs differ from the plain version's only where
|A - B| is within 1e-5 of its largest value; t_j to 1e-5 of c_j (|t_j| <=
sum_i |D_ij| = c_j) from the plain sum on the same signs, and from the
JAX kernel's t by no more than that plus 2 |D_ij| for each entry whose
|A - B| is within 1e-5 of its largest value (its sign may go either way).
K2b: the emulated product to 1e-5 of max|u| from the plain float32
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


# ---- K2a ------------------------------------------------------------------


def _gram_3xtf32(a, b, ks=1):
    """K2a's Gram tile product emulated: a and b split into TF32 parts,
    big.big + big.small + small.big summed in float64 over one 32-channel
    stage and rounded to float32, the stages' sums added in float32 in
    order by each of the ``ks`` blocks of a pair over its share of the
    stages, and the blocks' sums added in float32 in rank order."""
    ab, as_ = (v.double() for v in remd.tf32_split(a))
    bb, bs = (v.double() for v in remd.tf32_split(b))
    nst = -(-a.shape[1] // remd.TC_KC)
    total = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    for q in range(ks):
        acc = torch.zeros_like(total)
        for s in range(q * nst // ks, (q + 1) * nst // ks):
            st = slice(s * remd.TC_KC, (s + 1) * remd.TC_KC)
            part = (ab[:, st] @ bs[:, st].T + as_[:, st] @ bb[:, st].T
                    + ab[:, st] @ bb[:, st].T)
            acc = acc + part.float()
        total = total + acc
    return total


def _fwd_emulated(xh, yh, cx, cy, ks=1):
    """K2a emulated (``ks`` blocks a tile pair): the Gram tiles (I, J),
    I <= J, of the schedule, the
    (j, i) orientation of an off-diagonal pair read from tile (I, J), the
    epilogue's float32 operations, the loss partials of each block summed
    in float64 in block order."""
    n = xh.shape[0]
    nt = -(-n // selfsim.SF_TILE)
    pad = nt * selfsim.SF_TILE - n
    xp = torch.nn.functional.pad(xh, (0, 0, 0, pad))
    yp = torch.nn.functional.pad(yh, (0, 0, 0, pad))
    cxp = torch.nn.functional.pad(cx, (0, pad), value=1.0)
    cyp = torch.nn.functional.pad(cy, (0, pad), value=1.0)
    p, q = _gram_3xtf32(xp, xp, ks), _gram_3xtf32(yp, yp, ks)
    tile = selfsim.SF_TILE
    total = 0.0
    for b in range(selfsim.fwd_blocks(nt)):
        ti, tj = selfsim.fwd_tile(b, nt)
        si, sj = slice(ti * tile, ti * tile + tile), slice(tj * tile,
                                                           tj * tile + tile)
        if ti != tj:  # the (j, i) entries come from tile (I, J)
            p[sj, si], q[sj, si] = p[si, sj].T, q[si, sj].T
    dx, dy = 1.0 - p, 1.0 - q
    diff = dx / cxp[None, :] - dy / cyp[None, :]
    diff[n:, :] = 0.0
    diff[:, n:] = 0.0
    for b in range(selfsim.fwd_blocks(nt)):
        ti, tj = selfsim.fwd_tile(b, nt)
        si, sj = slice(ti * tile, ti * tile + tile), slice(tj * tile,
                                                           tj * tile + tile)
        part = diff[si, sj].abs().sum()
        if ti != tj:
            part = part + diff[sj, si].abs().sum()
        total += float(part)
    s = torch.sign(diff)
    tx, ty = torch.sum(s * dx, dim=0)[:n], torch.sum(s * dy, dim=0)[:n]
    return (torch.tensor(total / n, dtype=torch.float32), tx, ty,
            s[:n, :n].to(torch.int8), (dx[:n, :n], dy[:n, :n]))


@pytest.mark.parametrize("n,c,ks", [(130, 35, 1), (130, 35, 4),
                                    (200, 67, 2), (333, 2179, 1),
                                    (333, 2179, 4)])
def test_fwd_emulated_matches_plain_and_jax(n, c, ks):
    """The emulated K2a, whole or split over 2 or 4 blocks a pair, against
    the plain version (loss, signs, t on the same signs) and, at 130 x 35
    and 200 x 67, the JAX kernel in interpret mode (loss and t)."""
    x, y, xh, yh, cx, cy = _prepped(n, c, 7 * n)
    loss, tx, ty, signs, (dx, dy) = _fwd_emulated(xh, yh, cx, cy, ks)
    p_loss, _, _, p_signs = selfsim.selfsim_fwd_plain(xh, yh, cx, cy)
    assert abs(float(loss) - float(p_loss)) <= 1e-5 * abs(float(p_loss))
    pdx, pdy = 1.0 - xh @ xh.T, 1.0 - yh @ yh.T
    amb = (pdx / cx[None, :] - pdy / cy[None, :]).abs()
    amb = amb <= 1e-5 * amb.max()
    assert not bool(((signs != p_signs) & ~amb).any())
    s = signs.to(torch.float32)
    for t, d, pd, cv in ((tx, dx, pdx, cx), (ty, dy, pdy, cy)):
        assert bool(((t - torch.sum(s * pd, dim=0)).abs() <= 1e-5 * cv).all())
    if c > 100:
        return
    jloss, res, _ = jselfsim._fwd_impl(jnp.asarray(x), jnp.asarray(y), True)
    jtx, jty = res[8], res[9]
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for t, jt, pd, cv in ((tx, jtx, pdx, cx), (ty, jty, pdy, cy)):
        slack = 2.0 * torch.sum(amb * pd.abs(), dim=0)
        jt = torch.tensor(np.asarray(jt)[0, :n])
        assert bool(((t - jt).abs() <= 1e-5 * cv + slack).all())


@pytest.mark.parametrize("n", [130, 1000, 1024, 2100, 4100])
def test_fwd_schedule_visits_each_tile_pair_once(n):
    """The band-walked triangle: every unordered tile pair once (bands of
    16 tile columns: one at N <= 1024, three at 2100, five at 4100 with a
    last band one tile wide)."""
    nt = -(-n // selfsim.SF_TILE)
    pairs = [selfsim.fwd_tile(b, nt) for b in range(selfsim.fwd_blocks(nt))]
    assert all(0 <= i <= j < nt for i, j in pairs)
    assert len(set(pairs)) == len(pairs) == nt * (nt + 1) // 2


@pytest.mark.parametrize("n,ks", [(130, 1), (1000, 1), (1024, 1),
                                  (130, 4), (1000, 4), (1024, 4), (200, 2)])
def test_fwd_partial_slots_have_one_writer(n, ks):
    """Every t partial slot (x and y, row group of 64 / ks rows, column
    < N) is written by exactly one thread of one block, and the
    reduction's loss partials are the blocks' own, each read once."""
    nt = -(-n // selfsim.SF_TILE)
    blocks = selfsim.fwd_blocks(nt)
    written, totals = [], []
    for b in range(blocks):
        ti, tj = selfsim.fwd_tile(b, nt)
        for q in range(ks):
            totals.append(selfsim.fwd_total_slot(b, ks, q))
            written += [w for tid in range(selfsim.SF_THREADS)
                        if (w := selfsim.fwd_t_slot(tid, ti, tj, n, ks, q))
                        is not None]
    assert len(written) == len(set(written)) == 2 * ks * nt * n
    assert set(written) == {(v, r, col) for v in ("tx", "ty")
                            for r in range(ks * nt) for col in range(n)}
    assert sorted(totals) == list(range(ks * blocks))


@pytest.mark.parametrize("n,ks", [(130, 1), (200, 1), (130, 4), (200, 2)])
def test_fwd_epilogue_and_sign_stores_cover_the_matrix_once(n, ks):
    """Over all blocks, both orientations give each element of the N x N
    matrix once, from the P element of its pair in the block's rows; P
    reads touch at most 2 words a bank (1 unsplit) in both orientations;
    the 16-byte sign stores of the staged tiles s[rows of I, J] and
    s[J, rows of I] cover each stored sign once, at 16-byte aligned
    offsets of the signs and of the staged tile."""
    nt = -(-n // selfsim.SF_TILE)
    tile = selfsim.SF_TILE
    rows = tile // ks
    sp = -(-n // selfsim.SIGN_PITCH) * selfsim.SIGN_PITCH
    elems, stored = [], []
    for b in range(selfsim.fwd_blocks(nt)):
        ti, tj = selfsim.fwd_tile(b, nt)
        for q in range(ks):
            ri0, j0 = ti * tile + q * rows, tj * tile
            for tr in ((False,) if ti == tj else (False, True)):
                r0, c0 = (j0, ri0) if tr else (ri0, j0)
                for tid in range(selfsim.SF_THREADS):
                    for k in range(rows // 4):
                        i, j, e, sgb, (r, col) = selfsim.fwd_epilogue(
                            tid, k, tr, ks)
                        assert 0 <= i < rows and 0 <= j < tile
                        assert e == i * selfsim.SF_LDE + j
                        assert sgb == r * (rows if tr else tile) + col
                        assert (r0 + r, c0 + col) == ((j0 + j, ri0 + i)
                                                      if tr else
                                                      (ri0 + i, j0 + j))
                        if r0 + r < n and c0 + col < n:
                            elems.append((r0 + r, c0 + col))
            for u in range(4 * rows):
                for tr, (r, col, off) in zip(
                        (False, True), selfsim.fwd_sign_stores(u, ks)):
                    if tr and ti == tj:
                        continue
                    r0, c0 = (j0, ri0) if tr else (ri0, j0)
                    assert off % 16 == 0
                    assert off == r * (rows if tr else tile) + col
                    if r0 + r < n:
                        at = (r0 + r) * sp + c0 + col
                        assert at % 16 == 0 and c0 + col + 16 <= sp
                        stored += [(r0 + r, c0 + col + m) for m in range(16)]
    assert len(elems) == len(set(elems)) == n * n
    assert len(stored) == len(set(stored))
    assert {(r, col) for r, col in stored if col < n} == set(elems)
    for tr in (False, True):
        for w in range(8):
            for k in range(rows // 4):
                offs = [selfsim.fwd_epilogue(32 * w + lane, k, tr, ks)[2]
                        for lane in range(32)]
                assert _conflicts_32(offs) <= (1 if ks == 1 else 2)


def test_fwd_tile_map_covers_both_grams_once():
    """Warps 0..3 cover P's 64 x 64 tile once and warps 4..7 Q's; each
    accumulator's A and B registers hold its I row and J row."""
    seen = [selfsim.fwd_tile_rc(w, lane, mb, nb, i) for w in range(8)
            for lane in range(32) for mb in range(2) for nb in range(4)
            for i in range(4)]
    tile = selfsim.SF_TILE
    assert len(set(seen)) == len(seen) == 2 * tile * tile
    for w in range(8):
        for lane in range(32):
            for mb in range(2):
                for nb in range(4):
                    for i in range(4):
                        gram, row, col = selfsim.fwd_tile_rc(w, lane, mb, nb,
                                                             i)
                        r, n = remd.frag_c(lane, i)
                        a = selfsim.fwd_smem_a(w, 4 * (r % 8), mb, r // 8, 0,
                                               0)
                        b = selfsim.fwd_smem_b(w, 4 * n, nb, 0, 0, 0)
                        srow = [k for k in range(256)
                                if remd.tc_smem_row(k) == a // remd.TC_LD]
                        assert srow == [128 * gram + row]
                        srow = [k for k in range(256)
                                if remd.tc_smem_row(k) == b // remd.TC_LD]
                        assert srow == [128 * gram + tile + col]


@pytest.mark.parametrize("c", [2179, 2178, 2177, 2048, 67, 35])
def test_fwd_stage_loads_and_fragment_reads(c):
    """The shared loader on K2a's four-row-set stage: each of the 256 rows
    comes as the 16-byte windows that put channel k at column shift + k,
    every copy once; every fragment read of the 8 warps (off-diagonal and
    diagonal tiles) touches 32 distinct banks inside its row's window."""
    cols = {}
    dsts = []
    for tid in range(selfsim.SF_THREADS):
        for row, col, dst in selfsim.fwd_copies(tid, c):
            cols.setdefault(row, []).append(col)
            dsts.append(dst)
            assert dst == remd.tc_smem_row(row) * remd.TC_LD + col
    assert len(dsts) == len(set(dsts))
    for row in range(256):
        want = [col for col, _ in remd.tc_chunks(remd.tc_shift(row, c))]
        assert sorted(cols[row]) == want
    for diag in (False, True):
        for w in range(8):
            for kk in range(0, remd.TC_KC, 8):
                reads = [[selfsim.fwd_smem_a(w, lane, mb, i, kk, c)
                          for lane in range(32)]
                         for mb in range(2) for i in range(4)]
                reads += [[selfsim.fwd_smem_b(w, lane, nb, i, kk, c, diag)
                           for lane in range(32)]
                          for nb in range(4) for i in range(2)]
                for offs in reads:
                    assert _conflicts_32(offs) == 1
                    assert all(o % remd.TC_LD < remd.TC_KC + 3
                               and o < 256 * remd.TC_LD for o in offs)


def test_fwd_split_takes_the_measured_best_on_132_sms():
    """The split rule against the fastest split measured on an H100
    (132 SMs; tools/k2a_ablation.py's split sweep, PERF.md): 4 blocks a
    pair at N = 768 and 1024 (and 1000, the same 136 pairs as 1024), 2 at
    1500 and 1800, 1 at 2048, 3000, 4096 and 8192 (and 32769). At N = 960
    and 2500 it keeps one block, 5% and 4% slower than two."""
    want = {768: 4, 960: 1, 1000: 4, 1024: 4, 1500: 2, 1800: 2, 2048: 1,
            2500: 1, 3000: 1, 4096: 1, 8192: 1, 32769: 1}
    assert {n: selfsim.fwd_split(n, 132) for n in want} == want
