"""The arithmetic and layouts of K1's tensor-core route, checked on the CPU.

``csrc/remd.cu`` splits each float32 value into TF32 parts (big =
cvt.rna.tf32(v), small = cvt.rna.tf32(v - big)) and sums big.big +
big.small + small.big on the tensor cores. These tests hold the Python
statement of that arithmetic (``remd.tf32_round``, ``remd.tf32_split``)
to the rounding the PTX instruction defines, emulate the three-product sum
in float64 at the feature term's width (C = 2179) against the plain
version, float64 and the JAX kernel, and check the fragment and tile maps
the kernel's loops and epilogue are written from. The kernel itself runs
only on a card (``test_torch_cuda.py``).

Tolerances: emulated minima to rtol 1e-5 of the plain float32 version, and
no further from float64 than twice the plain version (the dropped
small.small term is ~2^-22 of a product; the plain version's own float32
rounding sets the scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strotss_torch.ops.kernels import remd
from strotss_tpu.ops.kernels.remd import _mins_pallas_call


def _bits(v):
    return torch.tensor(np.array(v, dtype=np.uint32).view(np.int32)).view(
        torch.float32)


def _as_bits(t):
    return t.contiguous().view(torch.int32).numpy().view(np.uint32).tolist()


# (input bits, cvt.rna.tf32.f32 result bits): the 13 low bits are dropped,
# rounding to nearest with ties away from zero
_ROUNDINGS = [
    (0x3F800000, 0x3F800000),  # 1.0, exact
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero (even: 1)
    (0xBF801000, 0xBF802000),  # its negative, away from zero
    (0x3F800FFF, 0x3F800000),  # just below the tie
    (0x3F801001, 0x3F802000),  # just above it
    (0x3F803000, 0x3F804000),  # a tie above an odd last bit
    (0x3FFFF000, 0x40000000),  # the carry reaches the exponent: 2.0
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
    (0x00001000, 0x00002000),  # subnormal tie, away from zero
    (0x80001000, 0x80002000),  # its negative
    (0x00000FFF, 0x00000000),  # subnormal below the tie: +0
    (0x007FF000, 0x00800000),  # largest subnormals round to the least normal
    (0x7F800000, 0x7F800000),  # inf passes
]


def test_tf32_round_bits():
    src, want = zip(*_ROUNDINGS)
    got = remd.tf32_round(_bits(list(src)))
    assert _as_bits(got) == list(want)


def test_tf32_split_parts():
    """big + (v - big) == v exactly, both parts are TF32 (low 13 bits 0),
    and big + small is v to 2^-21 of |v|, at scales from subnormal to 1e30."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.standard_normal(4000) * s for s in (1e-41, 1e-30, 1.0, 1e30)
    ] + [np.array([0.0, -0.0, 3.0, -1e-45])]).astype(np.float32)
    v = torch.tensor(vals)
    big, small = remd.tf32_split(v)
    assert torch.equal(big + (v - big), v)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    normal = v.abs() >= 2.0 ** -100
    err = ((big.double() + small.double()) - v.double()).abs()
    assert bool((err[normal] <= 2.0 ** -21 * v.double().abs()[normal]).all())


def _three_product_mins(x, y, distance):
    """K1's tensor-core route emulated: dot products from big.big +
    big.small + small.big summed exactly (float64) and rounded to float32,
    squared norms summed in float32 from the float32 values, then the
    epilogue's float32 arithmetic (csrc/remd.cu `pair_dist`)."""
    xb, xs = remd.tf32_split(x)
    yb, ys = remd.tf32_split(y)

    def mm(a, b):
        return a.double() @ b.double().T

    dot = (mm(xb, ys) + mm(xs, yb) + mm(xb, yb)).float()
    xsq = torch.sum(x * x, dim=1)[:, None]
    ysq = torch.sum(y * y, dim=1)[None, :]
    d = torch.zeros_like(dot)
    if distance != "l2":
        rx = 1.0 / torch.sqrt(torch.clamp(xsq, min=1e-12))
        ry = 1.0 / torch.sqrt(torch.clamp(ysq, min=1e-12))
        d = 1.0 - (dot * rx) * ry
    if distance != "cosine":
        inv_c = torch.tensor(1.0, dtype=torch.float32) / x.shape[1]
        d = d + torch.sqrt(torch.clamp(xsq + ysq - 2.0 * dot, min=1e-6)
                           * inv_c)
    rmin, rarg = d.min(dim=1)
    cmin, carg = d.min(dim=0)
    return rmin, cmin, rarg, carg


def _dist64(x, y, distance):
    x, y = x.double(), y.double()
    out = 0.0
    if distance != "l2":
        xn = x / torch.sqrt(torch.clamp((x * x).sum(1, keepdim=True), 1e-12))
        yn = y / torch.sqrt(torch.clamp((y * y).sum(1, keepdim=True), 1e-12))
        out = 1.0 - xn @ yn.T
    if distance != "cosine":
        msq = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
               - 2.0 * (x @ y.T))
        out = out + torch.sqrt(torch.clamp(msq, min=1e-6) / x.shape[1])
    return out


def _rel(a, ref):
    return float(((a.double() - ref) / ref).abs().max())


@pytest.mark.parametrize("n,m,distance,relu", [
    (256, 256, "cosine", False), (256, 256, "cosine", True),
    (1000, 777, "both", False), (1000, 777, "l2", True),
])
def test_three_products_give_the_minima(n, m, distance, relu):
    """At C = 2179, normal values and ReLU'd ones (the hypercolumn's taps
    are post-ReLU): the emulated route's minima against the plain version,
    float64, and at its argmins; at 256 x 256 also the JAX kernel."""
    c = 2179
    rng = np.random.default_rng(n + m)
    xa, ya = rng.standard_normal((n, c)), rng.standard_normal((m, c))
    if relu:
        xa, ya = np.maximum(xa, 0.0), np.maximum(ya, 0.0)
    x = torch.tensor(xa, dtype=torch.float32)
    y = torch.tensor(ya, dtype=torch.float32)
    rmin, cmin, rarg, carg = _three_product_mins(x, y, distance)
    p_rmin, p_cmin, _, _ = remd.mins_plain(x, y, distance)
    torch.testing.assert_close(rmin, p_rmin, rtol=1e-5, atol=0)
    torch.testing.assert_close(cmin, p_cmin, rtol=1e-5, atol=0)
    full = _dist64(x, y, distance)
    r64, c64 = full.min(dim=1).values, full.min(dim=0).values
    tol = max(1e-5, 2.0 * max(_rel(p_rmin, r64), _rel(p_cmin, c64)))
    assert max(_rel(rmin, r64), _rel(cmin, c64)) <= tol
    at_arg = (full[torch.arange(n), rarg], full[carg, torch.arange(m)])
    assert max(_rel(at_arg[0], r64), _rel(at_arg[1], c64)) <= tol
    if n == 256:
        jr, jc, _, _ = _mins_pallas_call(jnp.asarray(xa, jnp.float32),
                                         jnp.asarray(ya, jnp.float32),
                                         distance, True)
        np.testing.assert_allclose(rmin.numpy(), np.asarray(jr), rtol=1e-5)
        np.testing.assert_allclose(cmin.numpy(), np.asarray(jc), rtol=1e-5)


def test_fragment_maps_cover_each_element_once():
    """The m16n8k8 TF32 fragments: A covers 16 x 8 (row, k), B 8 x 8
    (k, col) and C 16 x 8 (row, col), each element exactly once."""
    for frag, regs, shape in ((remd.frag_a, 4, (16, 8)),
                              (remd.frag_b, 2, (8, 8)),
                              (remd.frag_c, 4, (16, 8))):
        seen = [frag(lane, i) for lane in range(32) for i in range(regs)]
        assert len(set(seen)) == len(seen) == shape[0] * shape[1]
        assert all(0 <= r < shape[0] and 0 <= k < shape[1] for r, k in seen)
    # the product the kernel forms: C[r, c] takes A's row r and B's column
    # c at the same k, for every k of the step
    a = {remd.frag_a(lane, i) for lane in range(32) for i in range(4)}
    b = {remd.frag_b(lane, i) for lane in range(32) for i in range(2)}
    assert {k for r, k in a} == {k for k, c in b} == set(range(8))


def test_tile_map_covers_the_block_tile_once():
    """The 8 warps' accumulators cover the 128 x 64 block tile once, and
    each A and B register holds the tile row and column its accumulators
    are charged to."""
    seen = [remd.tc_tile_rc(w, lane, mb, nb, i) for w in range(8)
            for lane in range(32) for mb in range(2) for nb in range(4)
            for i in range(4)]
    assert len(set(seen)) == len(seen) == remd.TC_BM * remd.TC_BN
    assert {r for r, _ in seen} == set(range(remd.TC_BM))
    assert {c for _, c in seen} == set(range(remd.TC_BN))
    assert sorted(remd.tc_smem_row(r) for r in range(192)) == list(range(192))
    for w in range(8):
        for lane in range(32):
            for mb in range(2):
                for nb in range(4):
                    for i in range(4):
                        row, col = remd.tc_tile_rc(w, lane, mb, nb, i)
                        # C row r is A row r; C column n is B column n
                        r, n = remd.frag_c(lane, i)
                        a_lane = 4 * (r % 8) + lane % 4
                        a_off = remd.tc_smem_a(w, a_lane, mb, (r // 8), 0, 0)
                        assert a_off // remd.TC_LD == remd.tc_smem_row(row)
                        b_off = remd.tc_smem_b(w, 4 * n, nb, 0, 0, 0)
                        assert (b_off // remd.TC_LD
                                == remd.tc_smem_row(remd.TC_BM + col))


def test_chunks_put_each_channel_at_its_column():
    """A row misaligned by s floats comes as 9 aligned 16-byte chunks whose
    columns hold channel k at column s + k, for k in the stage's 32."""
    for shift in range(4):
        at = {}
        for col, ch in remd.tc_chunks(shift):
            for e in range(4):
                at[col + e] = ch + e
        assert all(at[shift + k] == k for k in range(remd.TC_KC))
        assert max(at) < remd.TC_LD


@pytest.mark.parametrize("c", [2179, 2178, 2177, 2048])
def test_fragment_reads_are_free_of_bank_conflicts(c):
    """With rows TC_LD = 36 floats apart, grouped by r % 4 and shifted by
    their misalignment, each fragment read of a warp (one register of all 32
    lanes) touches 32 distinct banks and stays inside its row's window."""
    for row0 in (0, 128, 896):
        for w in range(8):
            for kk in range(0, remd.TC_KC, 8):
                reads = [[remd.tc_smem_a(w, lane, mb, i, kk, c, row0)
                          for lane in range(32)]
                         for mb in range(2) for i in range(4)]
                reads += [[remd.tc_smem_b(w, lane, nb, i, kk, c, row0 // 2)
                           for lane in range(32)]
                          for nb in range(4) for i in range(2)]
                for offs in reads:
                    assert len({o % 32 for o in offs}) == 32
                    # columns shift + k, shift < 4, k < TC_KC
                    assert all(o % remd.TC_LD < remd.TC_KC + 3
                               and o < 192 * remd.TC_LD for o in offs)
