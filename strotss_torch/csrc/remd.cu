// REMD row and column minima, fused: the N x M distance matrix is never
// written to device memory.
//
// Replaces the Pallas kernel strotss_tpu/ops/kernels/remd.py
// (`_mins_kernel` with `_dist_tile`, called from `_mins_pallas_call`).
// For x (N, C) and y (M, C) it returns the row minima and column minima of
// the cosine, L2 or 'both' distance, each with its first argmin. Two routes,
// chosen by the C entry from C alone (REMD_TC_MIN_C below); both write
// per-tile partial minima that `remd_reduce_kernel` folds in a fixed order.
// There are no atomics, so every result is the same bit for bit on every
// run, and ties keep the smaller index (the first argmin).
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 dense on the tensor
// cores; 67 TFLOP/s fp32 on the CUDA cores): the main path's cosine call
// (N = M = 1024, C = 2179) must read (N + M) * C * 4 B = 17.8 MB, 0.0053 ms,
// and does 2 * N * M * C = 4.57 GFLOP of products. On the tensor-core route
// each product is three TF32 products, 13.7 GFLOP, 0.0277 ms; on the CUDA
// cores it would be 0.0683 ms. It is bound by operations. The 'both' call on
// YUV (C = 3) does 6.3 MFLOP of products plus about 20 operations per pair
// for the two distances and the minima; it is bound by neither and costs
// what a launch costs.
//
// Tensor-core route (`remd_tc_kernel`, C >= REMD_TC_MIN_C; the feature term).
// - Precision. The JAX kernel's products are Precision.HIGHEST, and the
//   minima are held to rtol 1e-5 against float32, so plain TF32 (10
//   mantissa bits) cannot serve. Each f32 value v is split where it is read
//   into registers: big = v rounded to TF32, small = v - big (exact) rounded
//   to TF32, both to nearest with ties away from zero, the bits of
//   cvt.rna.tf32.f32 computed on the integer pipe (`tf32_rna`). x.y is the
//   sum of big.big + big.small + small.big ("3xTF32"; the dropped
//   small.small term is ~2^-22 of a product), three
//   `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32` a fragment pair. TF32 was
//   chosen over the bf16 three-way split because it needs three products,
//   not six, for the same accuracy. Per k8 step a thread splits 8 A and 8 B
//   values (2 integer operations and 1 fsub each, twice) against its warp's
//   24 mma. The tensor cores' own f32 sums run over one 32-channel stage
//   only: the stage's sums are then added into f32 registers on the CUDA
//   cores. Summed over all of C on the tensor cores, the minima were 14x
//   further from the plain version (1.8e-6 against 1.3e-7 at 1024 x 1024 x
//   2179), for no gain in time.
// - Tiles. A block of 256 threads (8 warps as 4 x 2, each 32 x 32) owns a
//   128 x 64 output tile; at N = M = 1024 that is 128 blocks, one wave on
//   132 SMs. Each block reads its 192 rows of x and y once from L2,
//   1.67 MB at C = 2179, 214 MB for the whole call (64 x 64 tiles would read
//   290 MB).
// - Loads (tc.cuh, shared with K2a). 32-channel slices of the 192 rows
//   stream through a ring of four stages in shared memory (110.6 KB of
//   dynamic shared memory, its limit set once per device) by 16-byte
//   `cp.async`, zero-filled past C and past
//   the last row or column. At C = 2179 a row starts 4-byte aligned only,
//   so each row's slice comes as the 16-byte aligned window that holds it,
//   channel k at column s + k, s = (row * C) % 4 (a ninth chunk where
//   s > 0). Rows 36 floats apart, grouped in shared memory by row % 4 (the
//   rows of one misalignment; the fragment-to-row map follows), keep every
//   fragment read on 32 distinct banks.
// - Row norms. |x|^2 and |y|^2 are summed in f32 from the f32 values in the
//   same fragment reads, then across the lane quad.
// - Epilogue in registers. The distances (the floors of tile_dist in
//   tile.cuh) are formed in the accumulator fragments; row minima with
//   their argmins go through the lane quad by shuffles, column minima
//   through the 8 lane groups, then across the warps through shared memory.
// - Measured (H100 80GB HBM3, 700 W; PERF.md, tools/k1_ablation.py): about
//   0.117 ms at 1024 x 1024 x 2179, 4.2x the bound above, 2.0x faster than
//   the CUDA-core route at the same shape. What holds it: `mma.sync` on TF32
//   reaches under half of the dense TF32 rate (the two extra products cost
//   0.043 ms), and the loads, fragment reads and split (0.073 ms with no
//   mma at all) overlap the mma little; splitting with cvt instead of the
//   integer pipe costs 0.014 ms more, the misaligned rows' ninth chunk
//   0.006 ms.
//
// CUDA-core route (`remd_tile_kernel`, C < REMD_TC_MIN_C; the YUV term,
// C = 3): each block takes one 64 x 64 tile, forms its dot products with
// fp32 FMAs from 64 x 32 slices of x and y in shared memory (`tile_dot`,
// tile.cuh), turns them into distances (`tile_dist`, whose floors
// sinkhorn.cu's `sk_dist` repeats), and writes the tile's row and column
// minima with their argmins. At C = 3 the tensor cores save nothing, and
// 'both' there is ill-conditioned in f32, so it keeps plain f32 products.
#include <stdint.h>

#include "tc.cuh"
#include "tile.cuh"

// C from which the entry point takes the tensor-core route. From the two
// routes' device times at 1024 x 1024 (tools/k1_routes.py on an H100 80GB
// HBM3 at 700 W; PERF.md) the tensor cores are faster from C = 8 up, by
// about 1 us below C = 48; below 32 their minima moved up to 6.8e-6 from
// the plain float32 version (C = 8), against ~1e-6 from 32 up.
#define REMD_TC_MIN_C 32

#define TC_BM 128  // x rows of a block's tile
#define TC_BN 64   // y rows (columns) of a block's tile: TILE, as the partials
#define TC_STAGES 4
#define TC_THREADS 256
#define TC_STAGE_FLOATS ((TC_BM + TC_BN) * TC_LD)
#define TC_SMEM_BYTES (TC_STAGES * TC_STAGE_FLOATS * 4)

static_assert(TC_BN == TILE, "both routes share the row partials' layout");

__global__ void __launch_bounds__(NTHREADS)
remd_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 int n, int m, int c, int dist, float* __restrict__ rowpart_v,
                 int* __restrict__ rowpart_i, float* __restrict__ colpart_v,
                 int* __restrict__ colpart_i) {
  __shared__ float as[KC][TILE + 1];
  __shared__ float bs[KC][TILE + 1];
  __shared__ float xsq[TILE];
  __shared__ float ysq[TILE];
  __shared__ float cv[16][TILE];
  __shared__ int ci[16][TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int col0 = blockIdx.x * TILE;
  const int row0 = blockIdx.y * TILE;

  float acc[4][4], d[4][4];
  tile_dot<true>(x, row0, n, y, col0, m, c, as, bs, acc, xsq, ysq);
  tile_dist(acc, xsq, ysq, c, dist, d);

  // row minima over this tile's columns: 4 columns per thread, then the 16
  // threads of one half-warp that share the rows
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float bv = BIG_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + tx + 16 * b;
      if (col < m && better(d[a][b], col, bv, bi)) {
        bv = d[a][b];
        bi = col;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int row = row0 + ty + 16 * a;
    if (tx == 0 && row < n) {
      rowpart_v[(size_t)blockIdx.x * n + row] = bv;
      rowpart_i[(size_t)blockIdx.x * n + row] = bi;
    }
  }

  // column minima over this tile's rows: 4 rows per thread, then across the
  // 16 row groups through shared memory
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float bv = BIG_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + ty + 16 * a;
      if (row < n && better(d[a][b], row, bv, bi)) {
        bv = d[a][b];
        bi = row;
      }
    }
    cv[ty][tx + 16 * b] = bv;
    ci[ty][tx + 16 * b] = bi;
  }
  __syncthreads();
  if (tid < TILE) {
    float bv = cv[0][tid];
    int bi = ci[0][tid];
    for (int g = 1; g < 16; ++g) {
      if (better(cv[g][tid], ci[g][tid], bv, bi)) {
        bv = cv[g][tid];
        bi = ci[g][tid];
      }
    }
    const int col = col0 + tid;
    if (col < m) {
      colpart_v[(size_t)blockIdx.y * m + col] = bv;
      colpart_i[(size_t)blockIdx.y * m + col] = bi;
    }
  }
}

// ---- tensor-core route ---------------------------------------------------
// (its cp.async, TF32 split, mma.sync, stage loader and fragment reads are
// in tc.cuh; a stage holds the tile's TC_BM x rows, then its TC_BN y rows)

// The distance of one pair from its dot product, the squared norms and
// their floored reciprocal square roots: tile_dist's arithmetic for one
// element.
__device__ __forceinline__ float pair_dist(float dot, float xs, float ys,
                                           float rx, float ry, float inv_c,
                                           int dist) {
  float v = 0.f;
  if (dist != DIST_L2) v = 1.0f - (dot * rx) * ry;
  if (dist != DIST_COS) {
    const float msq = xs + ys - 2.0f * dot;
    v += sqrtf(fmaxf(msq, 1e-6f) * inv_c);
  }
  return v;
}

// One TC_BM x TC_BN tile of the distance matrix per block: its row minima
// (over the tile's columns) into rowpart[blockIdx.x], its column minima
// into colpart[blockIdx.y].
__global__ void __launch_bounds__(TC_THREADS, 1)
remd_tc_kernel(const float* __restrict__ x, const float* __restrict__ y,
               int n, int m, int c, int dist,
               float* __restrict__ rowpart_v, int* __restrict__ rowpart_i,
               float* __restrict__ colpart_v, int* __restrict__ colpart_i) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * TC_BN;
  const int row0 = blockIdx.y * TC_BM;

  int a_off[4], b_off[4];
  tc_frag_offsets(wm * 32, TC_BM + wn * 32, c, a_off, b_off);

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0.f;
  float xs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // rows j = 2 mb + h
  float ys[4] = {0.f, 0.f, 0.f, 0.f};         // columns j = nb

  const int nst = (c + TC_KC - 1) / TC_KC;
  const TcLoader<TC_BM, TC_BN> ld =
      tc_loader<TC_BM, TC_BN>(row0, n, col0, m, c, tid);
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nst)
      tc_load_stage(smem + s * TC_STAGE_FLOATS, ld, x, y, s * TC_KC, c,
                    true);
    cp_async_commit();
  }

  for (int s = 0; s < nst; ++s) {
    // stage s has landed for every thread, and every warp is done with
    // stage s - 1, whose buffer the load of stage s + TC_STAGES - 1 takes
    cp_async_wait_group<TC_STAGES - 2>();
    __syncthreads();
    if (s + TC_STAGES - 1 < nst)
      tc_load_stage(smem + ((s + TC_STAGES - 1) % TC_STAGES) * TC_STAGE_FLOATS,
                    ld, x, y, (s + TC_STAGES - 1) * TC_KC, c, true);
    cp_async_commit();

    const float* st = smem + (s % TC_STAGES) * TC_STAGE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < TC_KC; kk += 8) {
      TcFrag f;
      tc_read_split<true>(st, kk, a_off, b_off, f, xs, ys);
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
  __syncthreads();  // the stages' memory now holds the epilogue's tables

  float* xsq = smem;                          // [TC_BM]
  float* ysq = xsq + TC_BM;                   // [TC_BN]
  float* rv = ysq + TC_BN;                    // [2][TC_BM] by wn
  int* ri = reinterpret_cast<int*>(rv + 2 * TC_BM);
  float* cv = reinterpret_cast<float*>(ri + 2 * TC_BM);  // [TC_BM/32][TC_BN]
  int* ci = reinterpret_cast<int*>(cv + (TC_BM / 32) * TC_BN);

  // squared norms: the lane quad holds channels t and t + 4 of each k8 step
  // (every warp sums them; the first column's and first row's write them)
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = xs[mb][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (wn == 0 && t == 0) xsq[wm * 32 + 4 * g + 2 * mb + h] = v;
    }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    float v = ys[nb];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (wm == 0 && t == 0) ysq[wn * 32 + 4 * g + nb] = v;
  }
  __syncthreads();

  // distances in place of the dot products: acc[mb][nb][2 h + j] is tile
  // row wm * 32 + 4 g + 2 mb + h, tile column wn * 32 + 4 (2 t + j) + nb
  const float inv_c = 1.0f / (float)c;
  float xv[2][2], rx[2][2], yv[4][2], ry[4][2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xv[mb][h] = xsq[wm * 32 + 4 * g + 2 * mb + h];
      rx[mb][h] = 1.0f / sqrtf(fmaxf(xv[mb][h], 1e-12f));
    }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      yv[nb][j] = ysq[wn * 32 + 4 * (2 * t + j) + nb];
      ry[nb][j] = 1.0f / sqrtf(fmaxf(yv[nb][j], 1e-12f));
    }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int j = i & 1;
        acc[mb][nb][i] = pair_dist(acc[mb][nb][i], xv[mb][h], yv[nb][j],
                                   rx[mb][h], ry[nb][j], inv_c, dist);
      }

  // row minima: 8 columns a thread, then the lane quad (32 columns)
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bv = BIG_F;
      int bi = 0x7fffffff;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + wn * 32 + 4 * (2 * t + j) + nb;
          const float d = acc[mb][nb][2 * h + j];
          if (col < m && better(d, col, bv, bi)) {
            bv = d;
            bi = col;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (t == 0) {
        const int r = wm * 32 + 4 * g + 2 * mb + h;
        rv[wn * TC_BM + r] = bv;
        ri[wn * TC_BM + r] = bi;
      }
    }

  // column minima: 4 rows a thread, then the 8 lane groups (32 rows)
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float bv = BIG_F;
      int bi = 0x7fffffff;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wm * 32 + 4 * g + 2 * mb + h;
          const float d = acc[mb][nb][2 * h + j];
          if (row < n && better(d, row, bv, bi)) {
            bv = d;
            bi = row;
          }
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (g == 0) {
        const int col = wn * 32 + 4 * (2 * t + j) + nb;
        cv[wm * TC_BN + col] = bv;
        ci[wm * TC_BN + col] = bi;
      }
    }
  __syncthreads();

  // across the warps: 2 column halves for a row, 4 row quarters for a column
  if (tid < TC_BM) {
    float bv = rv[tid];
    int bi = ri[tid];
    if (better(rv[TC_BM + tid], ri[TC_BM + tid], bv, bi)) {
      bv = rv[TC_BM + tid];
      bi = ri[TC_BM + tid];
    }
    const int row = row0 + tid;
    if (row < n) {
      rowpart_v[(size_t)blockIdx.x * n + row] = bv;
      rowpart_i[(size_t)blockIdx.x * n + row] = bi;
    }
  } else if (tid < TC_BM + TC_BN) {
    const int j = tid - TC_BM;
    float bv = cv[j];
    int bi = ci[j];
#pragma unroll
    for (int q = 1; q < TC_BM / 32; ++q) {
      if (better(cv[q * TC_BN + j], ci[q * TC_BN + j], bv, bi)) {
        bv = cv[q * TC_BN + j];
        bi = ci[q * TC_BN + j];
      }
    }
    const int col = col0 + j;
    if (col < m) {
      colpart_v[(size_t)blockIdx.y * m + col] = bv;
      colpart_i[(size_t)blockIdx.y * m + col] = bi;
    }
  }
}

// ---- both routes -----------------------------------------------------------

// One thread per row (g < n) and per column (g >= n): folds the per-tile
// partial minima in tile order.
__global__ void remd_reduce_kernel(
    const float* __restrict__ rowpart_v, const int* __restrict__ rowpart_i,
    const float* __restrict__ colpart_v, const int* __restrict__ colpart_i,
    int n, int m, int n_col_tiles, int n_row_tiles, float* __restrict__ rowmin,
    int* __restrict__ rowarg, float* __restrict__ colmin,
    int* __restrict__ colarg) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n) {
    float bv = rowpart_v[g];
    int bi = rowpart_i[g];
    for (int t = 1; t < n_col_tiles; ++t) {
      const float v = rowpart_v[(size_t)t * n + g];
      const int i = rowpart_i[(size_t)t * n + g];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    rowmin[g] = bv;
    rowarg[g] = bi;
  } else if (g < n + m) {
    const int j = g - n;
    float bv = colpart_v[j];
    int bi = colpart_i[j];
    for (int t = 1; t < n_row_tiles; ++t) {
      const float v = colpart_v[(size_t)t * m + j];
      const int i = colpart_i[(size_t)t * m + j];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    colmin[j] = bv;
    colarg[j] = bi;
  }
}

static bool tc_ready[MAX_DEVICES];
static int tc_setups = 0;

extern "C" int remd_tc_setups(void) { return tc_setups; }

// The route the entry point takes for c channels: 1 tensor cores, 0 CUDA
// cores.
extern "C" int remd_route(int c) { return c >= REMD_TC_MIN_C ? 1 : 0; }

extern "C" int remd_tc_min_c(void) { return REMD_TC_MIN_C; }

// `route` -1 takes remd_route(c); 0 or 1 forces that route (measurements
// and tests). The tensor-core route needs x and y 16-byte aligned. Scratch: rowpart_{v,i} hold ceil(m/64)*n entries,
// colpart_{v,i} ceil(n/64)*m, enough for either route. Returns
// cudaGetLastError() after both launches.
extern "C" int remd_mins(const float* x, const float* y, int n, int m, int c,
                         int dist, int route, float* rowpart_v,
                         int* rowpart_i, float* colpart_v, int* colpart_i,
                         float* rowmin, int* rowarg, float* colmin,
                         int* colarg, cudaStream_t stream) {
  if (route < 0) route = remd_route(c);
  if (route == 1 && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                     reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const int ntm = (m + TILE - 1) / TILE;
  int ntn;
  if (route == 1) {
    cudaError_t err = smem_limit_once(remd_tc_kernel, TC_SMEM_BYTES, tc_ready,
                                      &tc_setups);
    if (err != cudaSuccess) return (int)err;
    ntn = (n + TC_BM - 1) / TC_BM;
    remd_tc_kernel<<<dim3(ntm, ntn), TC_THREADS, TC_SMEM_BYTES, stream>>>(
        x, y, n, m, c, dist, rowpart_v, rowpart_i, colpart_v, colpart_i);
  } else {
    ntn = (n + TILE - 1) / TILE;
    remd_tile_kernel<<<dim3(ntm, ntn), NTHREADS, 0, stream>>>(
        x, y, n, m, c, dist, rowpart_v, rowpart_i, colpart_v, colpart_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (n + m + threads - 1) / threads;
  remd_reduce_kernel<<<blocks, threads, 0, stream>>>(
      rowpart_v, rowpart_i, colpart_v, colpart_i, n, m, ntm, ntn, rowmin,
      rowarg, colmin, colarg);
  return (int)cudaGetLastError();
}
