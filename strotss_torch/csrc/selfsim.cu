// Self-similarity content loss, forward (K2a) and backward (K2b).
//
// Replaces the Pallas kernels strotss_tpu/ops/kernels/selfsim.py
// (`_fwd_kernel` through `_fwd_call`, `_bwd_kernel` through `_bwd_call`).
// With x^, y^ the row-normalised (N, C) samples, D = 1 - x^ x^T,
// A = D / c_x (column-wise) and B likewise for y, s = sign(A - B):
//   K2a returns sum|A - B| / N, t_j = sum_i s_ij D_ij for x and y, and the
//     signs s themselves, int8 in {-1, 0, +1}, row-major with a row pitch
//     `sp` (a multiple of 64 bytes, at least N): 1 MiB at N = 1024, 1.07 GB
//     at N = 32769. The diagonal's A_ii - B_ii is rounding noise and may be
//     exactly 0, so 0 is kept.
//   K2b returns u = H x^ and the same for y, H = G + G^T, where
//     G_ij = (s_ij / c_j - t_j / c_j^2) / N is the derivative of the loss by
//     D (for y: -s, c_y, t_y). It takes the forward's signs, so the backward
//     uses exactly the signs t was summed over, and recomputes no Gram
//     matrix.
// The normalisation and its pull-back stay in PyTorch, as the JAX code
// keeps them outside its kernels.
//
// Bounds on an H100 SXM (67 TFLOP/s fp32 on CUDA cores, 495 TFLOP/s TF32
// dense on the tensor cores, 3.35 TB/s), main path N = 1024, C = 2179:
//   K2a: two Gram matrices x^ x^T and y^ y^T, symmetric, so N(N+1)/2 dot
//     products of length C each: 2 N(N+1) C = 4.6 GFLOP, 0.068 ms on the
//     CUDA cores, or, as three TF32 products each, 13.7 GFLOP, 0.0277 ms;
//     it reads 17.8 MB and writes N^2 bytes of signs. Bound by operations.
//     At N = 32769: 70.0 and 28.4 ms.
//   K2b: with the signs as an input, only the two products H x^:
//     2 * 2 N^2 C = 9.14 GFLOP, 0.136 ms on the CUDA cores, or, as three
//     TF32 products each, 27.4 GFLOP, 0.0554 ms; it moves 36.7 MB
//     (0.011 ms). Bound by operations. At N = 32769: 139.7 and 56.7 ms.
//   K2a + K2b together (the content loss and its gradient): the Gram pair
//     once plus the products, 0.205 ms on the CUDA cores, 0.0831 ms with
//     3xTF32 products.
//
// K2a (`selfsim_fwd_kernel<KS>` and `selfsim_fwd_reduce_kernel`).
// - Symmetry. The Gram tiles are formed for the tile pairs (I, J), I <= J,
//   of 64-row tiles only: nt (nt + 1) / 2 pairs, nt = ceil(N / 64) (136 at
//   N = 1024, 131,841 at N = 32769), walked in bands of 16 tile columns so
//   that a band's rows stay in L2 (`fwd_tile`). One Gram tile P = x^_I
//   x^_J^T (and Q for y^) serves both orientations of the pair: (i, j),
//   normalised by c_j, and (j, i), normalised by c_i, whose signs differ.
//   A diagonal tile takes the direct orientation only, and loads its rows
//   once.
// - Precision. The JAX kernel's products are Precision.HIGHEST, and the
//   loss is held to rtol 1e-5 and the signs to the plain version's, so the
//   Gram tiles are K1's 3xTF32 (tc.cuh): x^ split into TF32 big and small
//   parts where it is read into registers, big.big + big.small + small.big
//   on `mma.sync.m16n8k8` TF32, each 32-channel stage's sums added into f32
//   registers.
// - Tiles and loads. A block of 256 threads, 8 warps: warps 0..3 form P as
//   2 x 2 warp tiles of 32 x 32, warps 4..7 form Q. 32-channel stages of
//   the four row sets x^_I, x^_J, y^_I, y^_J (36.9 KB) stream through a
//   3-deep ring by K1's loader (tc.cuh): each row as its 16-byte aligned
//   window, rows grouped by r % 4 so that every fragment read lands on 32
//   banks. Two blocks an SM (ptxas: 128 registers, no spills).
// - Grid fill. 136 pairs on 132 SMs would leave 4 SMs with two pairs: a
//   pair may be split over a cluster of KS = 2 or 4 blocks, each taking
//   a share of the stages; after one cluster barrier each block adds the
//   KS partial tiles of its 64 / KS rows of I in rank order from the
//   others' shared memory (distributed shared memory: no device-memory
//   scratch) and takes the epilogue of those rows. The wrapper picks KS
//   by N and the card's SMs (ops/kernels/selfsim.py `fwd_split`; 4 at
//   N = 1024, 1 from 2048 up).
// - Epilogue. P and Q meet once in the ring's memory (every warp done with
//   the last stage: one barrier after cp.async.wait_all). Each thread then
//   takes its elements of each orientation in a column-owner layout: the
//   plain version's float32 operations with IEEE divisions, D = 1 - P,
//   A - B = D_x / c_x - D_y / c_y, the sign, |A - B| and s D. Both sign
//   tiles are staged in shared memory and stored as 16-byte row chunks.
// - No atomics. Each slot tx_part[G n + col] (row group G of 64 / KS rows,
//   column col) has one writer: the block whose rows of I are G, directly,
//   or the pair whose J holds G > I, transposed. The reduction folds them
//   over G in order, and the blocks' loss partials in double in a fixed
//   order: the loss, t and the signs are the same bit for bit on every run.
// - Measured (H100 80GB HBM3, 700 W; PERF.md, chip_smoke.py,
//   tools/k2a_ablation.py): 0.157 ms device at N = 1024, C = 2179 (4
//   blocks a pair; 0.232 with one), 5.7x the 3xTF32 bound above and 2.8x
//   faster than the whole-plane CUDA-core kernel it replaces (0.441);
//   107 ms at N = 32769 (was 396; the plain version 200). What holds it:
//   one TF32 product instead of three saves a third; with no products at
//   all the loads, fragment reads and split still take ~80% of the time.
//
// K2b (`selfsim_bwd_kernel`), one kernel; blockIdx.z picks x or y.
// - Precision. The JAX kernel's product is Precision.HIGHEST and the
//   gradient is held row by row to 1e-4 of max|g|, so the product is K1's
//   3xTF32 (tc.cuh): H and x^ are split into TF32 big and small parts,
//   big.big + big.small + small.big on `mma.sync.m16n8k8` TF32, and each
//   32-sample stage's sums are added into f32 registers.
// - H is built, not stored. G_ij takes one of three values for column j,
//   by s_ij; a block computes those values (the "tables") with the plain
//   version's float32 operations, ((s/c_j) - t_j/(c_j c_j)) / N with IEEE
//   divisions, for its 64 output rows once and for each stage's 32 samples
//   a stage ahead. H[o, r] = W_r[s_or] + W_o[s_ro] is then the plain
//   version's G[o, r] + G[r, o] bit for bit, and each element costs two
//   sign reads, two selects, one add and the split: no division and no
//   N x N scratch in device memory.
// - Tiles. A block of 256 threads (8 warps as 2 x 4, each 32 x 32 of the
//   output, K1's fragment shapes) owns 64 output rows o by 128 channels:
//   wide in channels, so each H element built serves 128 channels. Stages
//   of 32 samples r stream through a ring in shared memory: x^ rows by
//   4-byte `cp.async` (a row of 2179 floats is 4-byte aligned only; channel
//   k lands at column k, rows SB_LDX = 136 floats apart, so every B
//   fragment read is on 32 banks), and the sign tiles s[o, r] and s[r, o]
//   by 16-byte `cp.async` (the pitch keeps rows 16-byte aligned). The
//   block's threads split the next stage's H into a double buffer of
//   (big, small) pairs (rows SB_LDH = 36 pairs apart: A fragments are one
//   64-bit read on 32 banks) while the warps run this stage's products; one
//   barrier a stage. Zero-filled past N (x^ rows) and past C; H past N is
//   finite (the tables are 0 there) and multiplies zeros.
// - No atomics: each output element is summed over all N by one warp in a
//   fixed order, so u is the same bit for bit on every run.
// - Measured (H100 80GB HBM3, 700 W; PERF.md, chip_smoke.py,
//   tools/k2b_ablation.py): about 0.33 ms at N = 1024, C = 2179, 6.0x the
//   3xTF32 bound above and 3.1x faster than the old Gram recompute plus
//   G scratch (1.01 ms); 270 ms at N = 32769 (was 948). ptxas: 128
//   registers (the cap for two blocks an SM; 4 bytes spilled), 108 KB of
//   dynamic shared memory. What holds it: one TF32 product instead of
//   three saves 0.12 ms, so `mma.sync` TF32 runs well under the dense
//   rate; with no products at all the loads, H build and fragment work
//   still take 0.24 ms (x^'s 4-byte copies 0.05, the H build 0.05), and
//   the two overlap little. A 4-deep ring with one block an SM (more
//   registers, half the warps) is slower, 0.43 ms: the kernel needs the
//   second block's warps to hide its latencies.
#include <stdint.h>

#include "tc.cuh"

// ---- K2a ------------------------------------------------------------------

#define SF_TILE 64       // rows of a tile, I and J
#define SF_BAND 16       // tile columns J of a band of the schedule
#define SF_STAGES 3
#define SF_MIN_BLOCKS 2  // blocks an SM, for the register budget
#define SF_THREADS 256
#define SF_STAGE_FLOATS (4 * SF_TILE * TC_LD)  // x^_I, x^_J, y^_I, y^_J
#define SF_RING_BYTES (SF_STAGES * SF_STAGE_FLOATS * 4)
// the ring, then c_x and c_y of the I rows and of the J rows
#define SF_SMEM_BYTES (SF_RING_BYTES + 4 * SF_TILE * 4)
#define SF_LDE 65        // floats between rows of the P and Q tiles

static_assert(SF_THREADS == 4 * SF_TILE, "one c value a thread");

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// Tile pair (I, J), I <= J, of block b: the triangle of nt x nt tiles is
// walked in bands of SF_BAND tile columns; in a band, rows I from 0 up, in
// each row the band's columns J >= I in order. One band's J rows and the I
// rows of the blocks in flight stay in L2 at N = 32769
// (ops/kernels/selfsim.py `fwd_tile`).
__device__ __forceinline__ void fwd_tile(int b, int nt, int& ti, int& tj) {
  int k0 = 0, w = min(SF_BAND, nt);
  while (b >= k0 * w + w * (w + 1) / 2) {
    b -= k0 * w + w * (w + 1) / 2;
    k0 += w;
    w = min(SF_BAND, nt - k0);
  }
  if (b < k0 * w) {
    ti = b / w;
    tj = k0 + b % w;
    return;
  }
  b -= k0 * w;
  int i = 0;
  while (b >= w - i) {
    b -= w - i;
    ++i;
  }
  ti = k0 + i;
  tj = ti + b;
}

// Channels [k0, k0 + TC_KC) of the tile's four row sets into stage `st`:
// one loader for x^ and y^ (the same rows); threads 0..127 copy the ninth
// chunks of the x^ rows, threads 128..255 those of the y^ rows.
__device__ __forceinline__ void sf_load_stage(
    float* st, const TcLoader<SF_TILE, SF_TILE>& L, const float* xh,
    const float* yh, int k0, int c) {
  const bool lo = threadIdx.x < 2 * SF_TILE;
  tc_load_stage(st, L, xh, xh, k0, c, lo);
  tc_load_stage(st + 2 * SF_TILE * TC_LD, L, yh, yh, k0, c, !lo);
}

// Cluster barrier halves and a load from another block's shared memory
// (distributed shared memory, sm_90): the blocks of one tile pair add up
// their partial Gram tiles without a round trip through device memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(a) : "memory");
  return v;
}

// NK elements of one orientation for one thread: rows r = r0 + k of a tile
// whose element (r, col) has the dot products P[e], Q[e], e = r * rs +
// col * cst, and the normalisers c_x, c_y of its column. The plain
// version's float32 operations with IEEE divisions: D = 1 - P, A - B =
// D_x / c_x - D_y / c_y; D and A - B are 0 outside the matrix (rows from
// `rows_left` on, or the column past N). The sign goes to the staged tile
// `sg` (row r, column col, rows `sgp` bytes apart), |A - B| into `lsum`,
// s D into `tsx`, `tsy`.
template <int NK>
__device__ __forceinline__ void sf_orient(const float* P, const float* Q,
                                          int rs, int cst, int col, int r0,
                                          bool col_ok, int rows_left,
                                          float cxv, float cyv,
                                          signed char* sg, int sgp,
                                          float& lsum, float& tsx,
                                          float& tsy) {
#pragma unroll 4
  for (int k = 0; k < NK; ++k) {
    const int r = r0 + k;
    const int e = r * rs + col * cst;
    // a row past N may hold anything (its ninth chunk is never copied)
    const bool ok = col_ok && r < rows_left;
    const float dx = ok ? 1.0f - P[e] : 0.f;
    const float dy = ok ? 1.0f - Q[e] : 0.f;
    const float diff = ok ? dx / cxv - dy / cyv : 0.f;
    const float s = sign_f(diff);
    sg[r * sgp + col] = (signed char)s;
    lsum += fabsf(diff);
    tsx += s * dx;
    tsy += s * dy;
  }
}

// One tile pair (I, J), I <= J, per cluster of KS blocks: block q of the
// cluster forms the Gram tiles over its share of the 32-channel stages, P =
// x^_I x^_J^T (warps 0..3, 2 x 2 of 32 x 32) and Q = y^_I y^_J^T (warps
// 4..7), 3xTF32; the KS partial tiles are added in rank order, each block
// taking its R = 64 / KS rows of I; then both orientations of those rows.
template <int KS>
__global__ void __launch_bounds__(SF_THREADS, SF_MIN_BLOCKS)
selfsim_fwd_kernel(const float* __restrict__ xh, const float* __restrict__ yh,
                   const float* __restrict__ cx, const float* __restrict__ cy,
                   int n, int c, int nt, float* __restrict__ total_part,
                   float* __restrict__ tx_part, float* __restrict__ ty_part,
                   signed char* __restrict__ signs, int sp) {
  constexpr int R = SF_TILE / KS;  // rows of I a block's epilogue takes
  constexpr int NK = R / 4;        // elements a thread, each orientation
  extern __shared__ __align__(16) unsigned char sf_smem[];
  float* smem = reinterpret_cast<float*>(sf_smem);
  float* cs = smem + SF_RING_BYTES / 4;  // c_x I, c_y I, c_x J, c_y J

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gram = warp >> 2;  // 0: P (x^), 1: Q (y^)
  const int wm = (warp >> 1) & 1;
  const int wn = warp & 1;
  const int q = KS > 1 ? cluster_rank() : 0;
  int ti, tj;
  fwd_tile(blockIdx.x / KS, nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * SF_TILE, j0 = tj * SF_TILE;
  {
    const int r = (tid & 128 ? j0 : i0) + (tid & 63);
    cs[tid] = r < n ? (tid & 64 ? cy : cx)[r] : 1.f;
  }

  // stage rows: x^_I 0..63, x^_J 64..127, y^_I 128..191, y^_J 192..255; a
  // diagonal tile loads no J rows and reads its B fragments from the I rows
  int a_off[4], b_off[4];
  tc_frag_offsets(128 * gram + 32 * wm,
                  128 * gram + (diag ? 0 : SF_TILE) + 32 * wn, c, a_off,
                  b_off);
  const TcLoader<SF_TILE, SF_TILE> ld = tc_loader<SF_TILE, SF_TILE>(
      i0, n, j0, diag ? j0 : n, c, tid & (2 * SF_TILE - 1));

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0.f;

  // this block's stages: [s0, s0 + nst) of the ceil(C / 32)
  const int nst_all = (c + TC_KC - 1) / TC_KC;
  const int s0 = q * nst_all / KS;
  const int nst = (q + 1) * nst_all / KS - s0;
#pragma unroll
  for (int s = 0; s < SF_STAGES - 1; ++s) {
    if (s < nst)
      sf_load_stage(smem + s * SF_STAGE_FLOATS, ld, xh, yh, (s0 + s) * TC_KC,
                    c);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    // stage s has landed for every thread, and every warp is done with
    // stage s - 1, whose slot the load of stage s + SF_STAGES - 1 takes
    cp_async_wait_group<SF_STAGES - 2>();
    __syncthreads();
    if (s + SF_STAGES - 1 < nst)
      sf_load_stage(smem + ((s + SF_STAGES - 1) % SF_STAGES) * SF_STAGE_FLOATS,
                    ld, xh, yh, (s0 + s + SF_STAGES - 1) * TC_KC, c);
    cp_async_commit();

    const float* st = smem + (s % SF_STAGES) * SF_STAGE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < TC_KC; kk += 8) {
      TcFrag f;
      tc_read_split<false>(st, kk, a_off, b_off, f, nullptr, nullptr);
      tc_mma(part, f, kk == 0);
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mb][nb][i] += part[mb][nb][i];
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring: it takes P and Q

  // acc[mb][nb][i]: tile row 32 wm + 4 g + 2 mb + (i >> 1), tile column
  // 32 wn + 4 (2 t + (i & 1)) + nb
  {
    const int g = lane >> 2, t = lane & 3;
    float* pq = smem + gram * SF_TILE * SF_LDE;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pq[(32 * wm + 4 * g + 2 * mb + (i >> 1)) * SF_LDE + 32 * wn +
             4 * (2 * t + (i & 1)) + nb] = acc[mb][nb][i];
  }

  // P and Q rows q R .. q R + R - 1, summed over the cluster in rank order
  // (with KS = 1 the block's own tiles)
  const float* P = smem;
  const float* Q = smem + SF_TILE * SF_LDE;
  constexpr int EPI_S = 2 * SF_TILE * SF_LDE;
  constexpr int EPI_SG = EPI_S + (KS > 1 ? 2 * R * SF_LDE : 0);
  if constexpr (KS > 1) {
    cluster_arrive();  // every block's partial tiles are in place
    cluster_wait();
    float* sum = smem + EPI_S;
    for (int e = tid; e < 2 * R * SF_TILE; e += SF_THREADS) {
      const int gq = e / (R * SF_TILE);
      const int r = e / SF_TILE % R;
      const int col = e % SF_TILE;
      const float* at = smem + gq * SF_TILE * SF_LDE + (q * R + r) * SF_LDE + col;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) v += ld_cluster(at, k);
      sum[gq * R * SF_LDE + r * SF_LDE + col] = v;
    }
    cluster_arrive();  // done with the other blocks' tiles
    P = sum;
    Q = sum + R * SF_LDE;
  }
  __syncthreads();

  signed char* sg = reinterpret_cast<signed char*>(smem + EPI_SG);
  signed char* sgt = sg + R * SF_TILE;  // the transposed tile, rows R apart
  // the epilogue's tables in the ring: P and Q, the summed rows, the two
  // staged sign tiles, the t partials of 4 orientation x {x, y} by thread,
  // the warps' loss sums
  float* rt = smem + EPI_SG + 2 * R * SF_TILE / 4;
  float* rl = rt + 4 * SF_THREADS;
  static_assert(EPI_SG % 4 == 0, "the sign tiles stay 16-byte aligned");
  static_assert((EPI_SG + 2 * R * SF_TILE / 4 + 4 * SF_THREADS +
                 SF_THREADS / 32) * 4 <= SF_RING_BYTES,
                "the epilogue's tables fit in the ring");
  const int ri0 = i0 + q * R;  // this block's first row of I
  float lsum = 0.f, tsx = 0.f, tsy = 0.f;
  {
    // (i, j), normalised by c_j: rows i of the block's R, columns j of J;
    // thread (col, rg) rows rg NK + k
    const int col = tid & (SF_TILE - 1), rg = tid / SF_TILE;
    sf_orient<NK>(P, Q, SF_LDE, 1, col, rg * NK, j0 + col < n, n - ri0,
                  cs[2 * SF_TILE + col], cs[3 * SF_TILE + col], sg, SF_TILE,
                  lsum, tsx, tsy);
    rt[rg * SF_TILE + col] = tsx;
    rt[SF_THREADS + rg * SF_TILE + col] = tsy;
  }
  if (!diag) {
    // (j, i) of the pair, normalised by c_i: rows j of J, columns i of the
    // block's R; thread (ci, rj) rows rj NK + k; its D is D_ij
    const int ci = tid % R, rj = tid / R;
    tsx = tsy = 0.f;
    sf_orient<NK>(P, Q, 1, SF_LDE, ci, rj * NK, ri0 + ci < n, n - j0,
                  cs[q * R + ci], cs[SF_TILE + q * R + ci], sgt, R, lsum, tsx,
                  tsy);
    rt[2 * SF_THREADS + tid] = tsx;
    rt[3 * SF_THREADS + tid] = tsy;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  if (lane == 0) rl[warp] = lsum;
  __syncthreads();

  // t partials, one a thread, the 4 thread rows of a row group added in
  // order. Slots are rows groups of R rows: slot (group G, column) is this
  // block's where {G's tile, the column's tile} is {I, J}: direct where G
  // is the block's rows of I (threads 0..127: t_x, t_y of the 64 columns
  // of J), transposed where G lies in J > I (threads 128..255: t_x, t_y of
  // the R columns of I, for each of J's KS row groups).
  if (tid < 2 * SF_TILE) {
    const int col = tid & (SF_TILE - 1);
    const float* v = rt + (tid >> 6) * SF_THREADS + col;
    const float sum = ((v[0] + v[SF_TILE]) + v[2 * SF_TILE]) + v[3 * SF_TILE];
    if (j0 + col < n)
      (tid >> 6 ? ty_part : tx_part)[(size_t)(KS * ti + q) * n + j0 + col] =
          sum;
  } else if (!diag) {
    const int u = tid - 2 * SF_TILE;
    const int grp = (u & (SF_TILE - 1)) / R, ci = u % R;
    const float* v = rt + (2 + (u >> 6)) * SF_THREADS + 4 * grp * R + ci;
    const float sum = ((v[0] + v[R]) + v[2 * R]) + v[3 * R];
    if (ri0 + ci < n)
      (u >> 6 ? ty_part : tx_part)[(size_t)(KS * tj + grp) * n + ri0 + ci] =
          sum;
  }
  if (tid == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < SF_THREADS / 32; ++w) v += rl[w];
    total_part[blockIdx.x] = v;
  }
  // the sign tiles, 16 bytes a thread: s[rows of I, J] (R rows of 4
  // chunks) and s[J, rows of I] (64 rows of R / 16 chunks); columns past n
  // hold 0 (sp >= j0 + 64)
  for (int u = tid; u < 4 * R; u += SF_THREADS) {
    const int r = u >> 2, h = u & 3;
    if (ri0 + r < n)
      *reinterpret_cast<int4*>(signs + (size_t)(ri0 + r) * sp + j0 + 16 * h) =
          *reinterpret_cast<const int4*>(sg + r * SF_TILE + 16 * h);
    const int j = u / (R / 16), hj = u % (R / 16);
    if (!diag && j0 + j < n)
      *reinterpret_cast<int4*>(signs + (size_t)(j0 + j) * sp + ri0 + 16 * hj) =
          *reinterpret_cast<const int4*>(sgt + j * R + 16 * hj);
  }
  if constexpr (KS > 1) cluster_wait();  // no block leaves while read
}

// Blocks but the last: thread g < n folds t_x[g] and t_y[g] over the
// n_groups row groups in order, 8 loads in flight. The last block adds the
// n_blocks loss partials in double (131,841 at n = 32769, too many for a
// float sum): thread k takes partials k, k + 256, ... in order, then a
// fixed tree over the 256 sums.
#define SF_REDUCE_THREADS 256
__global__ void __launch_bounds__(SF_REDUCE_THREADS)
selfsim_fwd_reduce_kernel(const float* __restrict__ total_part,
                          const float* __restrict__ tx_part,
                          const float* __restrict__ ty_part, int n,
                          int n_groups, int n_blocks,
                          float* __restrict__ loss, float* __restrict__ tx,
                          float* __restrict__ ty) {
  __shared__ double red[SF_REDUCE_THREADS];
  const int tid = threadIdx.x;
  if (blockIdx.x + 1 < gridDim.x) {
    const int g = blockIdx.x * SF_REDUCE_THREADS + tid;
    if (g >= n) return;
    float a = 0.f, b = 0.f;
#pragma unroll 8
    for (int t = 0; t < n_groups; ++t) {
      a += tx_part[(size_t)t * n + g];
      b += ty_part[(size_t)t * n + g];
    }
    tx[g] = a;
    ty[g] = b;
    return;
  }
  double s = 0.0;
  for (int i = tid; i < n_blocks; i += SF_REDUCE_THREADS) s += total_part[i];
  red[tid] = s;
  __syncthreads();
  for (int w = SF_REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) loss[0] = (float)(red[0] / n);
}


// ---- K2b ------------------------------------------------------------------

#define SB_BM 64       // output rows o of a block
#define SB_BN 128      // channels of a block
#define SB_KC 32       // samples r a stage
#define SB_LDX 136     // floats between x^ rows of a stage
#define SB_LDH 36      // (big, small) pairs between H rows
#define SB_S1 48       // bytes between rows of the s[o, r] tile (32 used)
#define SB_S2 80       // bytes between rows of the s[r, o] tile (64 used)
#define SB_STAGES 3
#define SB_MIN_BLOCKS 2  // blocks an SM, for the register budget
#define SB_THREADS 256
#define SB_X_BYTES (SB_KC * SB_LDX * 4)
#define SB_S1_BYTES (SB_BM * SB_S1)
#define SB_S2_BYTES (SB_KC * SB_S2)
#define SB_STAGE_BYTES (SB_X_BYTES + SB_S1_BYTES + SB_S2_BYTES)
#define SB_H_BYTES (SB_BM * SB_LDH * 8)
#define SB_SMEM_BYTES \
  (SB_STAGES * SB_STAGE_BYTES + 2 * SB_H_BYTES + (2 * SB_KC + SB_BM) * 16)
#define SB_PITCH 64    // the signs' row pitch is a multiple of this

static_assert(SB_STAGE_BYTES % 16 == 0 && SB_H_BYTES % 16 == 0,
              "stages and H buffers stay 16-byte aligned");
static_assert(SB_BN * SB_KC == 16 * SB_THREADS, "16 x^ copies a thread");
static_assert(SB_BM * SB_KC == 8 * SB_THREADS, "8 H elements a thread");

// G's value in column j for sign k - 1 (k = 0, 1, 2), for x: ((s / c_j) -
// t_j / (c_j c_j)) / n in float32 with IEEE divisions, the plain version's
// operations (s / c_j is exactly +-1/c_j or 0). For y, G = (-s / c_j +
// t_j / (c_j c_j)) / n is the same with the sign flipped. 0 past n.
__device__ __forceinline__ float g_value(float cj, float tj, bool in_range,
                                         int n, int k, bool neg) {
  if (!in_range) return 0.f;
  const float p = 1.0f / cj;
  const float q = tj / (cj * cj);
  const float v = ((float)(k - 1) * p - q) / (float)n;
  return neg ? -v : v;
}

__device__ __forceinline__ float pick(int s, float wm, float w0, float wp) {
  return s > 0 ? wp : (s < 0 ? wm : w0);
}

// Stage `st`: x^ rows r0..r0+31, channels c0..c0+127 (4-byte copies,
// thread: channel tid % 128, rows tid / 128 + 2 q), and the sign tiles
// s[o0.., r0..] (64 rows of 2 chunks; threads 0..127) and s[r0.., o0..]
// (32 rows of 4 chunks; threads 128..255).
__device__ __forceinline__ void sb_load_stage(
    unsigned char* st, const float* __restrict__ v, const signed char* signs,
    int sp, int n, int c, int o0, int c0, int r0) {
  const int tid = threadIdx.x;
  float* xs = reinterpret_cast<float*>(st);
  const int ch = tid % SB_BN;
  const int k0 = tid / SB_BN;
  const bool ch_ok = c0 + ch < c;
#pragma unroll
  for (int q = 0; q < SB_KC / 2; ++q) {
    const int r = r0 + k0 + 2 * q;
    const bool ok = ch_ok && r < n;
    cp_async4z(xs + (k0 + 2 * q) * SB_LDX + ch,
               ok ? v + (size_t)r * c + c0 + ch : v, ok ? 4 : 0);
  }
  unsigned char* s1 = st + SB_X_BYTES;
  unsigned char* s2 = s1 + SB_S1_BYTES;
  if (tid < 2 * SB_BM) {
    const int i = tid / 2, h = tid % 2;
    const bool ok = o0 + i < n;
    cp_async16z(s1 + i * SB_S1 + 16 * h,
                ok ? signs + (size_t)(o0 + i) * sp + r0 + 16 * h : signs,
                ok ? 16 : 0);
  } else {
    const int k = (tid - 2 * SB_BM) / 4, h = tid % 4;
    const bool ok = r0 + k < n;
    cp_async16z(s2 + k * SB_S2 + 16 * h,
                ok ? signs + (size_t)(r0 + k) * sp + o0 + 16 * h : signs,
                ok ? 16 : 0);
  }
}

// H[o, r] = W_r[s_or] + W_o[s_ro] for the stage in `st`, split, into `hb`:
// warp w builds rows o = 8 w .. 8 w + 7, lane l sample r = l.
__device__ __forceinline__ void sb_build_h(const unsigned char* st,
                                           const float* wr, const float* wo,
                                           uint2* hb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const signed char* s1 =
      reinterpret_cast<const signed char*>(st + SB_X_BYTES);
  const unsigned char* s2 = st + SB_X_BYTES + SB_S1_BYTES;
  const float4 w = *reinterpret_cast<const float4*>(wr + 4 * lane);
  const uint2 sro = *reinterpret_cast<const uint2*>(
      s2 + lane * SB_S2 + 8 * warp);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = 8 * warp + j;
    const int so = s1[o * SB_S1 + lane];
    const int sr = (int)(signed char)(((j < 4 ? sro.x : sro.y) >> (8 * (j & 3)))
                                      & 0xffu);
    const float g2 = wo[4 * o + (sr > 0) - (sr < 0) + 1];
    uint2 h;
    tf32_split(pick(so, w.x, w.y, w.z) + g2, h.x, h.y);
    hb[o * SB_LDH + lane] = h;
  }
}

// u[o, :] = sum_r H[o, r] v[r, :] for one 64-row x 128-channel tile;
// blockIdx.z 0: v = x^, the tables from (c_x, t_x); 1: y^, (c_y, t_y), -G.
__global__ void __launch_bounds__(SB_THREADS, SB_MIN_BLOCKS)
selfsim_bwd_kernel(const float* __restrict__ xh, const float* __restrict__ yh,
                   const float* __restrict__ cx, const float* __restrict__ cy,
                   const float* __restrict__ tx, const float* __restrict__ ty,
                   const signed char* __restrict__ signs, int sp, int n,
                   int c, float* __restrict__ ux, float* __restrict__ uy) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint2* hbuf = reinterpret_cast<uint2*>(smem + SB_STAGES * SB_STAGE_BYTES);
  float* wr = reinterpret_cast<float*>(hbuf + 2 * SB_BM * SB_LDH);  // [2][32][4]
  float* wo = wr + 2 * SB_KC * 4;                                  // [64][4]

  const bool side_y = blockIdx.z != 0;
  const float* __restrict__ v = side_y ? yh : xh;
  const float* __restrict__ cv = side_y ? cy : cx;
  const float* __restrict__ tv = side_y ? ty : tx;
  float* __restrict__ u = side_y ? uy : ux;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 32 output rows
  const int wn = warp & 3;   // 32 channels
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = blockIdx.x * SB_BN;
  const int o0 = blockIdx.y * SB_BM;
  const int nst = (n + SB_KC - 1) / SB_KC;
  // a warp whose 32 channels all lie past C (the last channel tile) skips
  // its products
  const bool live = c0 + wn * 32 < c;

  // tables: this block's rows (all threads: row tid / 4, sign tid % 4 - 1;
  // [3] unused), the first two stages' samples (threads 0..127); each
  // later stage's c and t are loaded into registers a stage before its
  // tables are made, so no thread waits for them
  const int tk = tid % 4;
  const bool tab = tid < 4 * SB_KC && tk < 3;
  if (tk < 3) {
    const int o = o0 + tid / 4;
    wo[tid] = o < n ? g_value(cv[o], tv[o], true, n, tk, side_y) : 0.f;
  }
  float pc = 1.f, pt = 0.f;  // c, t of sample (s + 2) * SB_KC + tid / 4
  if (tab) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int j = b * SB_KC + tid / 4;
      wr[b * 4 * SB_KC + tid] =
          j < n ? g_value(cv[j], tv[j], true, n, tk, side_y) : 0.f;
    }
    const int j = 2 * SB_KC + tid / 4;
    if (j < n) {
      pc = cv[j];
      pt = tv[j];
    }
  }
#pragma unroll
  for (int s = 0; s < SB_STAGES - 1; ++s) {
    if (s < nst)
      sb_load_stage(ring + s * SB_STAGE_BYTES, v, signs, sp, n, c, o0, c0,
                    s * SB_KC);
    cp_async_commit();
  }
  cp_async_wait_group<SB_STAGES - 2>();
  __syncthreads();
  sb_build_h(ring, wr, wo, hbuf);

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0.f;

  // a warp's A rows wm*32 + 16 mb + g (+8), B columns wn*32 + 8 nb + g
  const int a_off = (wm * 32 + g) * SB_LDH + t;
  const int b_off = t * SB_LDX + wn * 32 + g;

  for (int s = 0; s < nst; ++s) {
    // stage s + 1 has landed for every thread; H(s) and the tables of
    // stage s + 1 are built; every warp is done with stage s - 1, whose
    // ring slot, H buffer and tables are taken below
    cp_async_wait_group<SB_STAGES - 3>();
    __syncthreads();
    if (s + SB_STAGES - 1 < nst)
      sb_load_stage(ring + ((s + SB_STAGES - 1) % SB_STAGES) * SB_STAGE_BYTES,
                    v, signs, sp, n, c, o0, c0, (s + SB_STAGES - 1) * SB_KC);
    cp_async_commit();
    if (s + 1 < nst)
      sb_build_h(ring + ((s + 1) % SB_STAGES) * SB_STAGE_BYTES,
                 wr + ((s + 1) & 1) * 4 * SB_KC, wo,
                 hbuf + ((s + 1) & 1) * SB_BM * SB_LDH);
    if (tab) {
      const int j = (s + 2) * SB_KC + tid / 4;
      wr[(s & 1) * 4 * SB_KC + tid] = g_value(pc, pt, j < n, n, tk, side_y);
      if (j + SB_KC < n) {
        pc = cv[j + SB_KC];
        pt = tv[j + SB_KC];
      }
    }

    if (live) {
      const uint2* hs = hbuf + (s & 1) * SB_BM * SB_LDH;
      const float* xs = reinterpret_cast<const float*>(
          ring + (s % SB_STAGES) * SB_STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < SB_KC; kk += 8) {
        TcFrag f;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint2 h = hs[a_off + (16 * mb + 8 * (i & 1)) * SB_LDH + kk +
                               4 * (i >> 1)];
            f.a_big[mb][i] = h.x;
            f.a_small[mb][i] = h.y;
          }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tf32_split(xs[b_off + (kk + 4 * i) * SB_LDX + 8 * nb],
                       f.b_big[nb][i], f.b_small[nb][i]);
        tc_mma(part, f, kk == 0);
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mb][nb][i] += part[mb][nb][i];
    }
  }
  cp_async_wait_all();

  // acc[mb][nb][i]: row wm*32 + 16 mb + g + 8 (i >> 1), channel
  // wn*32 + 8 nb + 2 t + (i & 1)
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int o = o0 + wm * 32 + 16 * mb + g + 8 * i2;
      if (o >= n) continue;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ch = c0 + wn * 32 + 8 * nb + 2 * t + j;
          if (ch < c) u[(size_t)o * c + ch] = acc[mb][nb][2 * i2 + j];
        }
    }
}

static bool sf_ready[MAX_DEVICES];
static int sf_setups = 0;
static bool sb_ready[MAX_DEVICES];
static int sb_setups = 0;

extern "C" int selfsim_fwd_setups(void) { return sf_setups; }
extern "C" int selfsim_bwd_setups(void) { return sb_setups; }

// The three kernels' shared-memory limits.
static cudaError_t sf_set_limits(void) {
  cudaError_t err = cudaSuccess;
  const void* kernels[] = {(const void*)selfsim_fwd_kernel<1>,
                           (const void*)selfsim_fwd_kernel<2>,
                           (const void*)selfsim_fwd_kernel<4>};
  for (const void* k : kernels)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SF_SMEM_BYTES);
  return err;
}

template <int KS>
static cudaError_t sf_launch(const float* xh, const float* yh,
                             const float* cx, const float* cy, int n, int c,
                             int nt, float* total_part, float* tx_part,
                             float* ty_part, signed char* signs, int sp,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KS * (nt * (nt + 1) / 2));
  cfg.blockDim = dim3(SF_THREADS);
  cfg.dynamicSmemBytes = SF_SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = KS > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, selfsim_fwd_kernel<KS>, xh, yh, cx, cy, n,
                            c, nt, total_part, tx_part, ty_part, signs, sp);
}

// `split`: the blocks a tile pair, 1, 2 or 4 (ops/kernels/selfsim.py
// `fwd_split` chooses it by n). Scratch, for ks = split and nt =
// ceil(n/64):
// total_part holds ks nt (nt + 1) / 2 floats, tx_part and ty_part
// ks nt n each. xh, yh 16-byte aligned. signs: n rows of `sp` bytes (sp a
// multiple of SB_PITCH, at least n), 16-byte aligned; K2a writes columns
// 0..n-1 (and 0 past them up to the tile's end). Returns
// cudaGetLastError() after both launches.
extern "C" int selfsim_fwd(const float* xh, const float* yh, const float* cx,
                           const float* cy, int n, int c, float* total_part,
                           float* tx_part, float* ty_part, float* loss,
                           float* tx, float* ty, signed char* signs, int sp,
                           int split, cudaStream_t stream) {
  if (sp % SB_PITCH != 0 || sp < n ||
      reinterpret_cast<uintptr_t>(signs) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(yh) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int ks = split;
  cudaError_t err = smem_limit_once(sf_set_limits, sf_ready, &sf_setups);
  if (err != cudaSuccess) return (int)err;
  const int nt = (n + SF_TILE - 1) / SF_TILE;
  if (ks == 1)
    err = sf_launch<1>(xh, yh, cx, cy, n, c, nt, total_part, tx_part,
                       ty_part, signs, sp, stream);
  else if (ks == 2)
    err = sf_launch<2>(xh, yh, cx, cy, n, c, nt, total_part, tx_part,
                       ty_part, signs, sp, stream);
  else if (ks == 4)
    err = sf_launch<4>(xh, yh, cx, cy, n, c, nt, total_part, tx_part,
                       ty_part, signs, sp, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  selfsim_fwd_reduce_kernel<<<(n + SF_REDUCE_THREADS - 1) /
                                      SF_REDUCE_THREADS + 1,
                              SF_REDUCE_THREADS, 0, stream>>>(
      total_part, tx_part, ty_part, n, ks * nt, ks * (nt * (nt + 1) / 2),
      loss, tx, ty);
  return (int)cudaGetLastError();
}

// signs as K2a writes them (pitch sp, 16-byte aligned); outputs ux, uy are
// (n, c). No scratch.
extern "C" int selfsim_bwd(const float* xh, const float* yh, const float* cx,
                           const float* cy, const float* tx, const float* ty,
                           const signed char* signs, int sp, int n, int c,
                           float* ux, float* uy, cudaStream_t stream) {
  if (sp % SB_PITCH != 0 || sp < n ||
      reinterpret_cast<uintptr_t>(signs) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_limit_once(selfsim_bwd_kernel, SB_SMEM_BYTES,
                                    sb_ready, &sb_setups);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + SB_BN - 1) / SB_BN, (n + SB_BM - 1) / SB_BM, 2);
  selfsim_bwd_kernel<<<grid, SB_THREADS, SB_SMEM_BYTES, stream>>>(
      xh, yh, cx, cy, tx, ty, signs, sp, n, c, ux, uy);
  return (int)cudaGetLastError();
}
