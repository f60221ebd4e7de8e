// Self-similarity content loss, forward and backward.
//
// Replaces the Pallas kernels strotss_tpu/ops/kernels/selfsim.py
// (`_fwd_kernel` through `_fwd_call`, `_bwd_kernel` through `_bwd_call`).
// With x^, y^ the row-normalised (N, C) samples, D = 1 - x^ x^T,
// A = D / c_x (column-wise) and B likewise for y, the forward returns
// sum|A - B| / N and t_j = sum_i sign(A - B)_ij D_ij for x and y; the
// backward returns (G + G^T) x^ and the same for y, where
// G_ij = (s_ij / c_j - t_j / c_j^2) / N is the derivative of the loss by D.
// The normalisation and its pull-back stay in PyTorch, as the JAX code
// keeps them outside its kernels.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 on CUDA cores, 3.35 TB/s), main
// path N = 1024, C = 2179:
//   forward: two Gram matrices x^ x^T and y^ y^T. Each is symmetric, so the
//     function needs only N(N+1)/2 dot products of length C per matrix:
//     2 * N(N+1)*C = 4.6 GFLOP, 0.068 ms; it reads 2*N*C*4 B = 17.8 MB,
//     0.0053 ms. Bound by operations.
//   backward: the two Gram matrices again to rebuild D (4.6 GFLOP) plus the
//     two products (G + G^T) x^, 2 * 2*N*N*C = 9.1 GFLOP: 13.7 GFLOP,
//     0.205 ms in all; bound by operations.
// These kernels compute every tile of the N x N plane, both halves of each
// symmetric Gram matrix, so they do 2x the forward's needed operations and
// 1.33x the backward's; using the symmetry is left to a later change.
//
// Design. Forward: one block per 64 x 64 tile of the N x N plane (256
// blocks at N = 1024), fp32 FMAs from 64 x 32 slices in shared memory. A
// block writes its share of sum|A - B| and its 64 column sums of t to
// partial buffers; a small kernel adds them up in a fixed order. No float
// atomics, so the loss and t are the same bit for bit on every run.
// Backward: the Pallas kernel makes two sweeps (G x^ and G^T x^) that
// recompute D each time and accumulate a (tile, C) gradient block across a
// grid that runs in order. Here a (64, 2179) block of the gradient fits in
// neither registers nor shared memory, and splitting the channels into
// slabs would rebuild D once per slab (18 times at 128 channels). So the
// backward rebuilds D once, tile by tile, and writes G for x and y to
// scratch: 2*N*N*4 B = 8 MB at N = 1024, which stays in the 50 MB L2. A
// second kernel is a tiled fp32 product (G + G^T) x^: G^T is the column
// pass, so one product serves both of the Pallas kernel's sweeps. The cost
// is O(N^2) scratch, which a later change must stream for N far above the
// main path's 1024.
#include "tile.cuh"

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__global__ void __launch_bounds__(NTHREADS)
selfsim_fwd_kernel(const float* __restrict__ xh, const float* __restrict__ yh,
                   const float* __restrict__ cx, const float* __restrict__ cy,
                   int n, int c, float* __restrict__ total_part,
                   float* __restrict__ tx_part, float* __restrict__ ty_part) {
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

// G for x and y, tile by tile, into two row-major (n, n) buffers.
__global__ void __launch_bounds__(NTHREADS)
selfsim_gmat_kernel(const float* __restrict__ xh, const float* __restrict__ yh,
                    const float* __restrict__ cx, const float* __restrict__ cy,
                    const float* __restrict__ tx, const float* __restrict__ ty,
                    int n, int c, float* __restrict__ gmx,
                    float* __restrict__ gmy) {
  __shared__ float as[KC][TILE + 1];
  __shared__ float bs[KC][TILE + 1];

  const int tid = threadIdx.x;
  const int tcol = tid % 16;
  const int trow = tid / 16;
  const int col0 = blockIdx.x * TILE;
  const int row0 = blockIdx.y * TILE;

  float gx[4][4], gy[4][4];
  tile_dot<false>(xh, row0, n, xh, col0, n, c, as, bs, gx, nullptr, nullptr);
  tile_dot<false>(yh, row0, n, yh, col0, n, c, as, bs, gy, nullptr, nullptr);

  const float inv_n = 1.0f / (float)n;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int col = col0 + tcol + 16 * b;
    if (col >= n) continue;
    const float cxj = cx[col];
    const float cyj = cy[col];
    const float txj = tx[col];
    const float tyj = ty[col];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + trow + 16 * a;
      if (row >= n) continue;
      const float dx = 1.0f - gx[a][b];
      const float dy = 1.0f - gy[a][b];
      const float s = sign_f(dx / cxj - dy / cyj);
      gmx[(size_t)row * n + col] = (s / cxj - txj / (cxj * cxj)) * inv_n;
      gmy[(size_t)row * n + col] = (-s / cyj + tyj / (cyj * cyj)) * inv_n;
    }
  }
}

// u[o, :] = sum_r (G[o, r] + G[r, o]) * v[r, :] for (n, n) G and (n, c) v.
// blockIdx.z picks x (0) or y (1); tiles of 64 rows x 64 channels.
__global__ void __launch_bounds__(NTHREADS)
selfsim_apply_kernel(const float* __restrict__ gmx,
                     const float* __restrict__ gmy,
                     const float* __restrict__ xh,
                     const float* __restrict__ yh, int n, int c,
                     float* __restrict__ ux, float* __restrict__ uy) {
  __shared__ float gs[KC][TILE + 1];   // G[o0 + o, r0 + k] at [k][o]
  __shared__ float gts[KC][TILE + 1];  // G[r0 + k, o0 + o] at [k][o]
  __shared__ float vs[KC][TILE + 1];   // v[r0 + k, c0 + j] at [k][j]

  const float* __restrict__ g = blockIdx.z ? gmy : gmx;
  const float* __restrict__ v = blockIdx.z ? yh : xh;
  float* __restrict__ u = blockIdx.z ? uy : ux;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c0 = blockIdx.x * TILE;
  const int o0 = blockIdx.y * TILE;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int r0 = 0; r0 < n; r0 += KC) {
    load_rows_kmajor(gs, g, o0, n, r0, n);
#pragma unroll
    for (int q = 0; q < (TILE * KC) / NTHREADS; ++q) {
      const int idx = tid + q * NTHREADS;
      const int k = idx / TILE;
      const int j = idx % TILE;
      const int gr = r0 + k;
      const int go = o0 + j;
      const int gc = c0 + j;
      gts[k][j] = (gr < n && go < n) ? g[(size_t)gr * n + go] : 0.f;
      vs[k][j] = (gr < n && gc < c) ? v[(size_t)gr * c + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        av[a] = gs[k][ty + 16 * a] + gts[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = vs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty + 16 * a;
    if (o >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int cc = c0 + tx + 16 * b;
      if (cc < c) u[(size_t)o * c + cc] = acc[a][b];
    }
  }
}

// Scratch: total_part holds ceil(n/64)^2 floats, tx_part and ty_part
// ceil(n/64)*n each. Returns cudaGetLastError() after both launches.
extern "C" int selfsim_fwd(const float* xh, const float* yh, const float* cx,
                           const float* cy, int n, int c, float* total_part,
                           float* tx_part, float* ty_part, float* loss,
                           float* tx, float* ty, cudaStream_t stream) {
  const int nt = (n + TILE - 1) / TILE;
  selfsim_fwd_kernel<<<dim3(nt, nt), NTHREADS, 0, stream>>>(
      xh, yh, cx, cy, n, c, total_part, tx_part, ty_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  selfsim_fwd_reduce_kernel<<<(n + 1 + threads - 1) / threads, threads, 0,
                              stream>>>(total_part, tx_part, ty_part, n, nt,
                                        nt * nt, loss, tx, ty);
  return (int)cudaGetLastError();
}

// Scratch: gmx and gmy hold n*n floats each. Outputs ux, uy are (n, c).
extern "C" int selfsim_bwd(const float* xh, const float* yh, const float* cx,
                           const float* cy, const float* tx, const float* ty,
                           int n, int c, float* gmx, float* gmy, float* ux,
                           float* uy, cudaStream_t stream) {
  const int nt = (n + TILE - 1) / TILE;
  selfsim_gmat_kernel<<<dim3(nt, nt), NTHREADS, 0, stream>>>(
      xh, yh, cx, cy, tx, ty, n, c, gmx, gmy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ct = (c + TILE - 1) / TILE;
  selfsim_apply_kernel<<<dim3(ct, nt, 2), NTHREADS, 0, stream>>>(
      gmx, gmy, xh, yh, n, c, ux, uy);
  return (int)cudaGetLastError();
}
