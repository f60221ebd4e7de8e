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
//     CUDA cores; it reads 17.8 MB and writes N^2 bytes of signs. Bound by
//     operations. It computes both halves of each Gram matrix (2x the
//     needed operations) with fp32 FMAs; using the symmetry and the tensor
//     cores is left to a later change.
//   K2b: with the signs as an input, only the two products H x^:
//     2 * 2 N^2 C = 9.14 GFLOP, 0.136 ms on the CUDA cores, or, as three
//     TF32 products each, 27.4 GFLOP, 0.0554 ms; it moves 36.7 MB
//     (0.011 ms). Bound by operations. At N = 32769: 139.7 and 56.7 ms.
//   K2a + K2b together (the content loss and its gradient): the Gram pair
//     once plus the products, 0.205 ms on the CUDA cores, 0.0831 ms with
//     3xTF32 products.
//
// K2a. One block per 64 x 64 tile of the N x N plane (256 blocks at
// N = 1024), fp32 FMAs from 64 x 32 slices in shared memory (`tile_dot`).
// A block writes its tile's signs, its share of sum|A - B| and its 64
// column sums of t to partial buffers; a small kernel adds them up in a
// fixed order. No float atomics, so the loss, t and the signs are the same
// bit for bit on every run.
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
#include "tile.cuh"

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__global__ void __launch_bounds__(NTHREADS)
selfsim_fwd_kernel(const float* __restrict__ xh, const float* __restrict__ yh,
                   const float* __restrict__ cx, const float* __restrict__ cy,
                   int n, int c, float* __restrict__ total_part,
                   float* __restrict__ tx_part, float* __restrict__ ty_part,
                   signed char* __restrict__ signs, int sp) {
  __shared__ float as[KC][TILE + 1];
  __shared__ float bs[KC][TILE + 1];
  __shared__ float stx[16][TILE];
  __shared__ float sty[16][TILE];
  __shared__ float red[NTHREADS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int col0 = blockIdx.x * TILE;
  const int row0 = blockIdx.y * TILE;

  float gx[4][4], gy[4][4];
  tile_dot<false>(xh, row0, n, xh, col0, n, c, as, bs, gx, nullptr, nullptr);
  tile_dot<false>(yh, row0, n, yh, col0, n, c, as, bs, gy, nullptr, nullptr);

  float abs_sum = 0.f;
  float ctx[4] = {0.f, 0.f, 0.f, 0.f};
  float cty[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int col = col0 + tx + 16 * b;
    if (col >= n) continue;
    const float cxj = cx[col];
    const float cyj = cy[col];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + ty + 16 * a;
      if (row >= n) continue;
      const float dx = 1.0f - gx[a][b];
      const float dy = 1.0f - gy[a][b];
      const float diff = dx / cxj - dy / cyj;
      const float s = sign_f(diff);
      signs[(size_t)row * sp + col] = (signed char)s;
      abs_sum += fabsf(diff);
      ctx[b] += s * dx;
      cty[b] += s * dy;
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    stx[ty][tx + 16 * b] = ctx[b];
    sty[ty][tx + 16 * b] = cty[b];
  }
  red[tid] = abs_sum;
  __syncthreads();
  for (int s = NTHREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) total_part[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  if (tid < TILE) {
    const int col = col0 + tid;
    float t = 0.f;
    for (int g = 0; g < 16; ++g) t += stx[g][tid];
    if (col < n) tx_part[(size_t)blockIdx.y * n + col] = t;
  } else if (tid < 2 * TILE) {
    const int col = col0 + tid - TILE;
    float t = 0.f;
    for (int g = 0; g < 16; ++g) t += sty[g][tid - TILE];
    if (col < n) ty_part[(size_t)blockIdx.y * n + col] = t;
  }
}

// Threads g < n fold t_x[g] and t_y[g] over the row tiles in order; thread
// g == n adds the per-block loss partials in order, in double: there are
// (n/64)^2 of them (263,169 at n = 32769), too many for a float sum.
__global__ void selfsim_fwd_reduce_kernel(
    const float* __restrict__ total_part, const float* __restrict__ tx_part,
    const float* __restrict__ ty_part, int n, int n_tiles, int n_blocks,
    float* __restrict__ loss, float* __restrict__ tx, float* __restrict__ ty) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      a += tx_part[(size_t)t * n + g];
      b += ty_part[(size_t)t * n + g];
    }
    tx[g] = a;
    ty[g] = b;
  } else if (g == n) {
    double s = 0.0;
    for (int i = 0; i < n_blocks; ++i) s += total_part[i];
    loss[0] = (float)(s / n);
  }
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

static bool sb_ready[MAX_DEVICES];
static int sb_setups = 0;

extern "C" int selfsim_bwd_setups(void) { return sb_setups; }

// Scratch: total_part holds ceil(n/64)^2 floats, tx_part and ty_part
// ceil(n/64)*n each. signs: n rows of `sp` bytes (sp a multiple of
// SB_PITCH, at least n), 16-byte aligned; K2a writes columns 0..n-1.
// Returns cudaGetLastError() after both launches.
extern "C" int selfsim_fwd(const float* xh, const float* yh, const float* cx,
                           const float* cy, int n, int c, float* total_part,
                           float* tx_part, float* ty_part, float* loss,
                           float* tx, float* ty, signed char* signs, int sp,
                           cudaStream_t stream) {
  if (sp % SB_PITCH != 0 || sp < n) return (int)cudaErrorInvalidValue;
  const int nt = (n + TILE - 1) / TILE;
  selfsim_fwd_kernel<<<dim3(nt, nt), NTHREADS, 0, stream>>>(
      xh, yh, cx, cy, n, c, total_part, tx_part, ty_part, signs, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  selfsim_fwd_reduce_kernel<<<(n + 1 + threads - 1) / threads, threads, 0,
                              stream>>>(total_part, tx_part, ty_part, n, nt,
                                        nt * nt, loss, tx, ty);
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
