// VGG block1, fused: conv 3->64, ReLU, conv 64->64, ReLU with SAME padding,
// and its image-only backward.
//
// Replaces the Pallas kernels of strotss_tpu/ops/kernels/block1.py:
// `_fwd_kernel` (called from `_fwd_call`) and `_bwd_kernel` (from
// `_bwd_call`, with `_fold27` around it). Operands are rounded to bf16 where
// the TPU kernel rounds them (x, both kernels, the post-ReLU y1 before
// conv2; dz2, g1 * m1 and dy1 in the backward); every sum is taken in f32,
// the biases are added in f32 and both taps are stored in f32.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense on the tensor
// cores): at the 512 px content scale (H x W = 384 x 512) the forward does
// 2*H*W*(27 + 576)*64 = 15.2 GFLOP, 0.015 ms, and must read x (12 B a pixel)
// and write the two f32 taps (512 B a pixel), 103 MB, 0.031 ms. The
// backward does the same 15.2 GFLOP and must read g1, g2, tap1 and tap2
// (1 KiB a pixel) and write dx, 204 MB, 0.061 ms. Both are bound by bytes.
//
// Design. This first version computes on the CUDA cores: bf16 values are
// widened to f32 (exactly) and multiplied with f32 FMAs, so it does not
// reach the tensor-core rate that the bound assumes; `mma`/`wgmma` is later
// work. What it does about the bytes:
// - Forward, one kernel: a block takes a TH x TW tile of output pixels,
//   loads x with a 2-pixel halo, computes y1 on the tile plus a 1-pixel
//   halo into shared memory as bf16 (zero outside the image: SAME padding
//   of conv2), writes tap1 for the tile, then runs conv2 from shared memory
//   and writes tap2. y1 never goes to device memory; the halo recompute
//   costs (TH+2)(TW+2)/(TH*TW) = 1.4x of conv1's small share of the work.
// - Backward, two kernels: dy1 = conv2^T(dz2)*[tap1 > 0] + bf16(g1*[tap1>0])
//   per tile from dz2 = bf16(g2*[tap2 > 0]) with a 1-pixel halo, written to
//   a bf16 scratch (128 B a pixel); then dx = conv1^T(dy1) per tile from a
//   halo of that scratch. Both transposed convolutions are plain 3x3
//   convolutions with the flipped, transposed kernels the wrapper passes,
//   so dx needs no `_fold27`. The scratch costs 2 x 128 B a pixel of the
//   bound's 1036, and keeps each kernel's shared memory at ~97 KB, two
//   blocks an SM.
// - The 64x64 kernel (73.7 KB as bf16) sits in dynamic shared memory.
//   Thread (g, cg) of a conv block owns 4 pixels x 8 output channels: per
//   pair of input channels it reads 4 words of activations (pixel stride
//   33 words, so the 4 pixel groups of a warp hit distinct banks) and two
//   16-byte kernel rows (8 lanes read 128 contiguous bytes; the warp's 4
//   pixel groups share them), for 64 FMAs.
// No atomics: each output is written by one thread, so results are the
// same bit for bit on every run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TH 8    // output tile rows of the conv kernels
#define TW 16   // output tile columns (TH * TW = 128 = 32 groups of 4)
#define YH (TH + 2)
#define YW (TW + 2)
#define XH (TH + 4)
#define XW (TW + 4)
#define PW 33   // shared-memory words a pixel: 64 bf16 + 1 word of padding
#define NT 256
#define DH 8    // dx kernel tile rows
#define DW 32   // dx kernel tile columns (DH * DW = 256 = NT)

#define K2_BYTES (9 * 64 * 64 * 2)
#define FWD_SMEM (K2_BYTES + YH * YW * PW * 4 + XH * XW * 3 * 4 + 27 * 64 * 4 + 2 * 64 * 4)
#define DY1_SMEM (K2_BYTES + YH * YW * PW * 4)
#define DX_SMEM ((DH + 2) * (DW + 2) * PW * 4 + 9 * 64 * 16)

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ bool inside(int gh, int gw, int h, int w) {
  return gh >= 0 && gh < h && gw >= 0 && gw < w;
}

// Copies the (9, 64, 64) bf16 kernel into shared memory, 16 bytes a thread.
__device__ __forceinline__ void load_k64(uint4* ks, const uint4* k) {
  for (int i = threadIdx.x; i < K2_BYTES / 16; i += NT) ks[i] = k[i];
}

// acc[p][j] = sum over the 3x3 taps and 64 input channels of
// in[pixel p shifted by the tap][ci] * w[tap][ci][8 * cg + j].
// `in` holds a (TH + 2) x (TW + 2) tile of 64-channel bf16 pixels, PW words
// a pixel; base[p] is the word offset of output pixel p's top-left tap.
__device__ __forceinline__ void conv64_group(const uint32_t* in,
                                             const uint4* w, const int base[4],
                                             int cg, float acc[4][8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const int off = (ky * YW + kx) * PW;
      const uint4* wt = w + (ky * 3 + kx) * 64 * 8 + cg;
#pragma unroll 4
      for (int cp = 0; cp < 32; ++cp) {
        uint32_t u[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) u[p] = in[base[p] + off + cp];
        const uint4 wa = wt[(2 * cp) * 8];
        const uint4 wb = wt[(2 * cp + 1) * 8];
        const float fa[8] = {lo_f(wa.x), hi_f(wa.x), lo_f(wa.y), hi_f(wa.y),
                             lo_f(wa.z), hi_f(wa.z), lo_f(wa.w), hi_f(wa.w)};
        const float fb[8] = {lo_f(wb.x), hi_f(wb.x), lo_f(wb.y), hi_f(wb.y),
                             lo_f(wb.z), hi_f(wb.z), lo_f(wb.w), hi_f(wb.w)};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float a = lo_f(u[p]);
          const float b = hi_f(u[p]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[p][j] = fmaf(a, fa[j], acc[p][j]);
            acc[p][j] = fmaf(b, fb[j], acc[p][j]);
          }
        }
      }
    }
  }
}

// Thread tid's 4 output pixels (tile row, tile column) and their base
// offsets into a (TH + 2) x (TW + 2) input tile.
__device__ __forceinline__ void group_pixels(int g, int r[4], int c[4],
                                             int base[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int q = 4 * g + p;
    r[p] = q / TW;
    c[p] = q % TW;
    base[p] = (r[p] * YW + c[p]) * PW;
  }
}

// x (h, w, 3) f32; k1 (27, 64) f32 [ky][kx][ci][co], already bf16-rounded;
// k2 (9, 64, 64) bf16 [ky][kx][ci][co]; taps (h, w, 64) f32.
__global__ void __launch_bounds__(NT, 2)
block1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                  const float* __restrict__ b1, const uint4* __restrict__ k2,
                  const float* __restrict__ b2, int h, int w,
                  float* __restrict__ tap1, float* __restrict__ tap2) {
  extern __shared__ uint4 smem[];
  uint4* k2s = smem;
  uint32_t* y1s = reinterpret_cast<uint32_t*>(smem + K2_BYTES / 16);
  float* xs = reinterpret_cast<float*>(y1s + YH * YW * PW);
  float* k1s = xs + XH * XW * 3;
  float* b1s = k1s + 27 * 64;
  float* b2s = b1s + 64;
  const int tid = threadIdx.x;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;

  load_k64(k2s, k2);
  for (int i = tid; i < 27 * 64; i += NT) k1s[i] = k1[i];
  if (tid < 64) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  for (int i = tid; i < XH * XW * 3; i += NT) {
    const int q = i / 3;
    const int gh = h0 - 2 + q / XW;
    const int gw = w0 - 2 + q % XW;
    xs[i] = inside(gh, gw, h, w) ? bf16r(x[((size_t)gh * w + gw) * 3 + i % 3])
                                 : 0.f;
  }
  __syncthreads();

  // y1 on the tile and its 1-pixel halo; 0 outside the image
  uint16_t* y1h = reinterpret_cast<uint16_t*>(y1s);
  for (int i = tid; i < YH * YW * 64; i += NT) {
    const int q = i >> 6;
    const int co = i & 63;
    const int r = q / YW;
    const int c = q % YW;
    const int gh = h0 - 1 + r;
    const int gw = w0 - 1 + c;
    float y = 0.f;
    if (inside(gh, gw, h, w)) {
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            acc = fmaf(xs[((r + ky) * XW + c + kx) * 3 + ci],
                       k1s[((ky * 3 + kx) * 3 + ci) * 64 + co], acc);
      y = fmaxf(acc + b1s[co], 0.f);
      if (r >= 1 && r <= TH && c >= 1 && c <= TW)
        tap1[((size_t)gh * w + gw) * 64 + co] = y;
    }
    y1h[q * 2 * PW + co] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
  }
  __syncthreads();

  const int g = tid >> 3;
  const int cg = tid & 7;
  int r[4], c[4], base[4];
  group_pixels(g, r, c, base);
  float acc[4][8];
  conv64_group(y1s, k2s, base, cg, acc);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gh = h0 + r[p];
    const int gw = w0 + c[p];
    if (!inside(gh, gw, h, w)) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[p][j] + b2s[cg * 8 + j], 0.f);
    float4* out = reinterpret_cast<float4*>(tap2 + ((size_t)gh * w + gw) * 64 +
                                            cg * 8);
    out[0] = make_float4(v[0], v[1], v[2], v[3]);
    out[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// dy1 = conv(dz2, k2r) * [tap1 > 0] + bf16(g1 * [tap1 > 0]), rounded to bf16,
// with dz2 = bf16(g2 * [tap2 > 0]); k2r (9, 64, 64) bf16 is k2 flipped in
// both spatial axes with its channel axes swapped, [ky][kx][co][ci].
__global__ void __launch_bounds__(NT, 2)
block1_dy1_kernel(const float* __restrict__ tap1, const float* __restrict__ tap2,
                  const float* __restrict__ g1, const float* __restrict__ g2,
                  const uint4* __restrict__ k2r, int h, int w,
                  uint4* __restrict__ dy1) {
  extern __shared__ uint4 smem[];
  uint4* ks = smem;
  uint32_t* dzs = reinterpret_cast<uint32_t*>(smem + K2_BYTES / 16);
  const int tid = threadIdx.x;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;

  load_k64(ks, k2r);
  for (int i = tid; i < YH * YW * 32; i += NT) {
    const int q = i >> 5;
    const int cw = i & 31;
    const int gh = h0 - 1 + q / YW;
    const int gw = w0 - 1 + q % YW;
    uint32_t u = 0;
    if (inside(gh, gw, h, w)) {
      const size_t at = ((size_t)gh * w + gw) * 64 + 2 * cw;
      const float2 gv = *reinterpret_cast<const float2*>(g2 + at);
      const float2 tv = *reinterpret_cast<const float2*>(tap2 + at);
      u = pack_bf16(tv.x > 0.f ? gv.x : 0.f, tv.y > 0.f ? gv.y : 0.f);
    }
    dzs[q * PW + cw] = u;
  }
  __syncthreads();

  const int g = tid >> 3;
  const int cg = tid & 7;
  int r[4], c[4], base[4];
  group_pixels(g, r, c, base);
  float acc[4][8];
  conv64_group(dzs, ks, base, cg, acc);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gh = h0 + r[p];
    const int gw = w0 + c[p];
    if (!inside(gh, gw, h, w)) continue;
    const size_t at = ((size_t)gh * w + gw) * 64 + cg * 8;
    const float4* t4 = reinterpret_cast<const float4*>(tap1 + at);
    const float4* g4 = reinterpret_cast<const float4*>(g1 + at);
    const float4 ta = t4[0], tb = t4[1], ga = g4[0], gb = g4[1];
    const float t[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
    const float gg[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d[j] = t[j] > 0.f ? acc[p][j] + bf16r(gg[j]) : 0.f;
    dy1[((size_t)gh * w + gw) * 8 + cg] =
        make_uint4(pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]),
                   pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7]));
  }
}

// dx = conv(dy1, k1r): one thread a pixel of a DH x DW tile. k1r (9, 64, 4)
// f32, bf16-rounded: [ky][kx][co][c] of k1 flipped in both spatial axes,
// c padded from 3 to 4.
__global__ void __launch_bounds__(NT)
block1_dx_kernel(const uint32_t* __restrict__ dy1, const float4* __restrict__ k1r,
                 int h, int w, float* __restrict__ dx) {
  extern __shared__ uint4 smem[];
  uint32_t* ds = reinterpret_cast<uint32_t*>(smem);
  float4* ks = reinterpret_cast<float4*>(ds + (DH + 2) * (DW + 2) * PW);
  const int tid = threadIdx.x;
  const int h0 = blockIdx.y * DH;
  const int w0 = blockIdx.x * DW;

  for (int i = tid; i < 9 * 64; i += NT) ks[i] = k1r[i];
  for (int i = tid; i < (DH + 2) * (DW + 2) * 32; i += NT) {
    const int q = i >> 5;
    const int cw = i & 31;
    const int gh = h0 - 1 + q / (DW + 2);
    const int gw = w0 - 1 + q % (DW + 2);
    ds[q * PW + cw] =
        inside(gh, gw, h, w) ? dy1[((size_t)gh * w + gw) * 32 + cw] : 0u;
  }
  __syncthreads();

  const int r = tid / DW;
  const int c = tid % DW;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const uint32_t* src = ds + ((r + ky) * (DW + 2) + c + kx) * PW;
      const float4* kt = ks + (ky * 3 + kx) * 64;
#pragma unroll 8
      for (int cp = 0; cp < 32; ++cp) {
        const uint32_t u = src[cp];
        const float lo = lo_f(u), hi = hi_f(u);
        const float4 ka = kt[2 * cp];
        const float4 kb = kt[2 * cp + 1];
        a0 = fmaf(hi, kb.x, fmaf(lo, ka.x, a0));
        a1 = fmaf(hi, kb.y, fmaf(lo, ka.y, a1));
        a2 = fmaf(hi, kb.z, fmaf(lo, ka.z, a2));
      }
    }
  }
  const int gh = h0 + r;
  const int gw = w0 + c;
  if (inside(gh, gw, h, w)) {
    float* o = dx + ((size_t)gh * w + gw) * 3;
    o[0] = a0;
    o[1] = a1;
    o[2] = a2;
  }
}

// Returns cudaGetLastError() after the launch.
extern "C" int block1_fwd(const float* x, const float* k1, const float* b1,
                          const void* k2, const float* b2, int h, int w,
                          float* tap1, float* tap2, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block1_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  block1_fwd_kernel<<<grid, NT, FWD_SMEM, stream>>>(
      x, k1, b1, static_cast<const uint4*>(k2), b2, h, w, tap1, tap2);
  return (int)cudaGetLastError();
}

// Scratch: dy1 holds h * w * 64 bf16. Returns cudaGetLastError() after both
// launches.
extern "C" int block1_bwd(const float* tap1, const float* tap2,
                          const float* g1, const float* g2, const void* k2r,
                          const float* k1r, int h, int w, void* dy1,
                          float* dx, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block1_dy1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DY1_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  block1_dy1_kernel<<<grid, NT, DY1_SMEM, stream>>>(
      tap1, tap2, g1, g2, static_cast<const uint4*>(k2r), h, w,
      static_cast<uint4*>(dy1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      block1_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_dx((w + DW - 1) / DW, (h + DH - 1) / DH);
  block1_dx_kernel<<<grid_dx, NT, DX_SMEM, stream>>>(
      static_cast<const uint32_t*>(dy1), reinterpret_cast<const float4*>(k1r),
      h, w, dx);
  return (int)cudaGetLastError();
}
