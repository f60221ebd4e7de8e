// Shared pieces of the hand-written fp32 kernels of remd.cu; sinkhorn.cu
// takes the distance codes.
//
// Every kernel here works on 64 x 64 output tiles with 256 threads. Thread
// (ty, tx) of the 16 x 16 layout owns rows ty + 16*a and columns tx + 16*b,
// a, b in 0..3, so neighbouring threads read neighbouring shared-memory
// words. Products are plain fp32 FMAs on the CUDA cores: no TF32, no bf16,
// matching the JAX kernels' Precision.HIGHEST.
#pragma once

#include <cuda_runtime.h>

#define TILE 64
#define KC 32
#define NTHREADS 256
#define BIG_F 3.4e38f

#define DIST_COS 0
#define DIST_L2 1
#define DIST_BOTH 2

// A (value, index) pair is better than another if it is smaller, or equal
// with a smaller index: a reduction in any order then keeps the first
// argmin, as the JAX kernel's min-then-smallest-index rule does.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Loads rows [row0, row0 + 64) x channels [k0, k0 + 32) of a row-major
// (n, c) matrix into s[k][row], zero-filling past the ragged edges.
__device__ __forceinline__ void load_rows_kmajor(
    float (*s)[TILE + 1], const float* __restrict__ src, int row0, int n,
    int k0, int c) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < (TILE * KC) / NTHREADS; ++q) {
    const int idx = tid + q * NTHREADS;
    const int r = idx / KC;
    const int k = idx % KC;
    const int gr = row0 + r;
    const int gk = k0 + k;
    s[k][r] = (gr < n && gk < c) ? src[(size_t)gr * c + gk] : 0.f;
  }
}

// acc[a][b] = sum_k X[row0 + ty + 16a, k] * Y[col0 + tx + 16b, k] over all
// c channels. With `sq`, the squared norms of the 64 X rows and 64 Y rows
// of the tile land in xsq[0..63] and ysq[0..63] (shared memory), each
// summed in channel order by one thread.
template <bool SQ>
__device__ __forceinline__ void tile_dot(
    const float* __restrict__ x, int row0, int n, const float* __restrict__ y,
    int col0, int m, int c, float (*as)[TILE + 1], float (*bs)[TILE + 1],
    float acc[4][4], float* xsq, float* ysq) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float sq = 0.f;
  for (int k0 = 0; k0 < c; k0 += KC) {
    load_rows_kmajor(as, x, row0, n, k0, c);
    load_rows_kmajor(bs, y, col0, m, k0, c);
    __syncthreads();
    if (SQ) {
      if (tid < TILE) {
#pragma unroll 8
        for (int k = 0; k < KC; ++k) sq = fmaf(as[k][tid], as[k][tid], sq);
      } else if (tid < 2 * TILE) {
#pragma unroll 8
        for (int k = 0; k < KC; ++k)
          sq = fmaf(bs[k][tid - TILE], bs[k][tid - TILE], sq);
      }
    }
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = as[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = bs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  if (SQ) {
    if (tid < TILE) {
      xsq[tid] = sq;
    } else if (tid < 2 * TILE) {
      ysq[tid - TILE] = sq;
    }
    __syncthreads();
  }
}

// d[a][b] = the `dist` distance of X row ty + 16a and Y row tx + 16b of the
// tile, from tile_dot<true>'s products and squared norms, with the floors of
// strotss_torch/ops/kernels/common.py: cosine 1 - x^.y^ (squared norms
// floored at 1e-12), L2 sqrt(max(|x|^2 + |y|^2 - 2 x.y, 1e-6) / c), or
// their sum ('both').
__device__ __forceinline__ void tile_dist(const float acc[4][4],
                                          const float* xsq, const float* ysq,
                                          int c, int dist, float d[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float inv_c = 1.0f / (float)c;
  float xs[4], ys[4], rx[4], ry[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    xs[a] = xsq[ty + 16 * a];
    rx[a] = 1.0f / sqrtf(fmaxf(xs[a], 1e-12f));
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    ys[b] = ysq[tx + 16 * b];
    ry[b] = 1.0f / sqrtf(fmaxf(ys[b], 1e-12f));
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float dot = acc[a][b];
      float v = 0.f;
      if (dist != DIST_L2) v = 1.0f - (dot * rx[a]) * ry[b];
      if (dist != DIST_COS) {
        const float msq = xs[a] + ys[b] - 2.0f * dot;
        v += sqrtf(fmaxf(msq, 1e-6f) * inv_c);
      }
      d[a][b] = v;
    }
  }
}
