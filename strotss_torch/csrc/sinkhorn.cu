// One streamed Sinkhorn half-update: out_i = LSE_j(-lam * d_ij + logv_j)
// for x (N, C) and y (M, C), without writing the N x M distance matrix.
//
// Replaces the Pallas kernel strotss_tpu/ops/kernels/sinkhorn.py
// (`_lse_kernel`, called from `lse_pass`). d is the cosine, L2 or 'both'
// distance of remd.cu, formed by the same device code (tile.cuh's tile_dot
// and tile_dist). The transposed update, LSE over the rows, is the same
// launch with x and y swapped: every distance is symmetric.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 on CUDA cores, 3.35 TB/s, 16
// special-function results per SM and clock, 4.2e12/s): at the --sinkhorn
// path's shape above the memory gate (N = M = 32769, C = 2179, cosine) one
// pass does 2*N*M*C = 4.68e12 operations of products, 70 ms, and must read
// (N + M)*C*4 B = 571 MB, 0.17 ms; it is bound by operations. The YUV term
// (C = 3, 'both') needs one expf and one sqrtf per pair, 2*N*M = 2.1e9
// special-function results, 0.51 ms, more than its 0.013 TFLOP of
// products, 0.19 ms.
//
// Design. On the TPU the grid runs in order, and constant-index output
// blocks carry each row's running (max, sumexp) across the column sweep.
// CUDA blocks run at once, so here one block of 256 threads owns a 64-row
// strip of x and sweeps the 64-column tiles of y itself, in order, keeping
// the running pair in registers: no atomics and no scratch, and the result
// is the same bit for bit on every run. Per tile it forms the 64 x 64 dot
// products with fp32 FMAs from 64 x 32 slices in shared memory, the
// distances, and z = -lam * d + logv_j (columns at or past m get -3.4e38,
// finite, so that no inf - inf appears). The 16 threads that share a row
// combine their maxima and their sums of exp(z - new_max) in a fixed
// butterfly of warp shuffles, then each row's pair is rescaled:
// run_sum = run_sum * exp(run_max - new_max) + tile_sum. expf and logf are
// the accurate library functions (no --use_fast_math). At N = 32769 there
// are 513 strips, about two waves on 132 SMs; computing each distance tile
// once per iteration for both sweeps, tensor cores and TMA are left for
// later.
#include "tile.cuh"

#define NEG_BIG (-3.4e38f)

__global__ void __launch_bounds__(NTHREADS)
sinkhorn_lse_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ logv, int n, int m, int c,
                    int dist, float lam, float* __restrict__ out) {
  __shared__ float as[KC][TILE + 1];
  __shared__ float bs[KC][TILE + 1];
  __shared__ float xsq[TILE];
  __shared__ float ysq[TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * TILE;

  float run_max[4], run_sum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    run_max[a] = NEG_BIG;
    run_sum[a] = 0.f;
  }

  for (int col0 = 0; col0 < m; col0 += TILE) {
    float acc[4][4], d[4][4];
    tile_dot<true>(x, row0, n, y, col0, m, c, as, bs, acc, xsq, ysq);
    tile_dist(acc, xsq, ysq, c, dist, d);

    float lv[4];
    bool in[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + tx + 16 * b;
      in[b] = col < m;
      lv[b] = in[b] ? logv[col] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float z[4];
      float tile_max = NEG_BIG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        z[b] = in[b] ? -lam * d[a][b] + lv[b] : NEG_BIG;
        tile_max = fmaxf(tile_max, z[b]);
      }
      // the 16 threads of row ty + 16a are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float new_max = fmaxf(run_max[a], tile_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) tile_sum += expf(z[b] - new_max);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      // exp(-3.4e38 - new_max) underflows to 0 at the first tile
      run_sum[a] = run_sum[a] * expf(run_max[a] - new_max) + tile_sum;
      run_max[a] = new_max;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + ty + 16 * a;
      if (row < n) out[row] = logf(fmaxf(run_sum[a], 1e-38f)) + run_max[a];
    }
  }
}

// out (n,) = LSE over the m columns. Returns cudaGetLastError() after the
// launch.
extern "C" int sinkhorn_lse(const float* x, const float* y, const float* logv,
                            int n, int m, int c, int dist, float lam,
                            float* out, cudaStream_t stream) {
  const int blocks = (n + TILE - 1) / TILE;
  sinkhorn_lse_kernel<<<blocks, NTHREADS, 0, stream>>>(x, y, logv, n, m, c,
                                                        dist, lam, out);
  return (int)cudaGetLastError();
}
