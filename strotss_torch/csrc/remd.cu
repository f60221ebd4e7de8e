// REMD row and column minima, fused: the N x M distance matrix is never
// written to device memory.
//
// Replaces the Pallas kernel strotss_tpu/ops/kernels/remd.py
// (`_mins_kernel` with `_dist_tile`, called from `_mins_pallas_call`).
// For x (N, C) and y (M, C) it returns the row minima and column minima of
// the cosine, L2 or 'both' distance, each with its first argmin.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 on CUDA cores, 3.35 TB/s): the main
// path's cosine call (N = M = 1024, C = 2179) does 2*N*M*C = 4.57 GFLOP of
// products, 0.068 ms, and must read (N + M)*C*4 B = 17.8 MB, 0.0053 ms. It
// is bound by operations. The 'both' call on YUV (C = 3) does 6.3 MFLOP of
// products plus about 20 operations per pair for the two distances and the
// minima; it is bound by neither and costs what a launch costs.
//
// Design. The Pallas kernel carries its minima across a grid that runs in
// order on one core. CUDA blocks run at once, so each block takes one
// 64 x 64 tile (a grid of 16 x 16 = 256 blocks at N = M = 1024, enough for
// the 132 SMs): it forms the tile's dot products with fp32 FMAs from 64 x 32
// slices of x and y in shared memory, turns them into distances, and writes
// the tile's row minima and column minima with their argmins to partial
// buffers of shape (M/64, N) and (N/64, M). A second, small kernel reduces
// those buffers in a fixed order. There are no atomics, so the result is
// the same bit for bit on every run, and ties keep the smaller index (the
// first argmin). Row norms are summed inside the tile loop, from the same
// shared-memory slices, so no separate pass reads x or y. Each block reads
// its 64 rows of x and y once from L2; the 16-fold reuse of each row across
// blocks comes from the 50 MB L2, which holds both inputs.
#include "tile.cuh"

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

// Scratch: rowpart_{v,i} hold ceil(m/64)*n entries, colpart_{v,i}
// ceil(n/64)*m. Returns cudaGetLastError() after both launches.
extern "C" int remd_mins(const float* x, const float* y, int n, int m, int c,
                         int dist, float* rowpart_v, int* rowpart_i,
                         float* colpart_v, int* colpart_i, float* rowmin,
                         int* rowarg, float* colmin, int* colarg,
                         cudaStream_t stream) {
  const int ntm = (m + TILE - 1) / TILE;
  const int ntn = (n + TILE - 1) / TILE;
  remd_tile_kernel<<<dim3(ntm, ntn), NTHREADS, 0, stream>>>(
      x, y, n, m, c, dist, rowpart_v, rowpart_i, colpart_v, colpart_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (n + m + threads - 1) / threads;
  remd_reduce_kernel<<<blocks, threads, 0, stream>>>(
      rowpart_v, rowpart_i, colpart_v, colpart_i, n, m, ntm, ntn, rowmin,
      rowarg, colmin, colarg);
  return (int)cudaGetLastError();
}
