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
// Forward (K3a), on the tensor cores. Both convolutions are implicit GEMMs
// on `mma.sync.m16n8k16` with bf16 operands and f32 sums; conv2 alone is
// 14.5 GFLOP, 0.217 ms at the CUDA cores' f32 rate, so it cannot stay there.
// - Persistent blocks: two blocks of 128 threads per SM (103 KB of shared
//   memory each) walk the 8 x 16 output tiles with a fixed stride. Each
//   copies the 64x64 3x3 kernel (73.7 KB bf16) into shared memory once, not
//   once per tile, and keeps conv1's kernel as mma fragments in registers.
//   Two blocks an SM let one block's conv2 run beside the other's conv1 and
//   stores; one block of 256 threads on 16 x 16 tiles was slower.
// - conv1 (K = 27, padded to 32 with zero weights) runs on the tile plus a
//   1-pixel halo, 10 x 18 = 180 pixels (1.41x the tile): each thread builds
//   its A fragments straight from the x tile (a 2-pixel halo, f32, rounded
//   to bf16 as it is packed). Its epilogue adds b1 and applies ReLU, writes
//   tap1 for the tile's own pixels and r(y1) into shared memory, zero
//   outside the image: conv2's SAME padding.
// - conv2: M = 128 pixels, N = 64, K = 9 taps x 64 channels. A tap is the
//   y1 tile shifted, so `ldmatrix` reads each fragment row (one pixel's 8
//   channels, 16 B) at the shifted pixel: no im2col copy. The kernel operand
//   comes through `ldmatrix.trans` from its [tap][ci][co] layout. Pixel and
//   kernel rows are 128 B, so their 16-byte chunks are XOR-swizzled with
//   the row's low 3 bits, and every 8-row `ldmatrix` phase is free of bank
//   conflicts. Each warp owns 2 tile rows x 64 channels (64 f32 sums a
//   thread); the epilogue adds b2, applies ReLU and stores float2s, each
//   lane quad one 32-byte sector of a pixel.
// - While conv2 runs, `cp.async` brings the next tile's x halo into the
//   other of two x buffers.
// The wrapper builds the weight layouts once per weight tensor; the C entry
// sets the shared-memory limit and reads the SM count once per device.
// Measured on an H100 80GB HBM3 at 700 W (`chip_smoke.py`, 384 x 512): about
// 0.060 ms on the device, 2.0x its bound, where the CUDA-core design it
// replaces took 0.56 ms, 18x. What is left is not DRAM but the shared-memory
// and load/store pipe (`tools/k3a_ablation.py` times the kernel with parts
// left out): conv2's `ldmatrix` traffic, the kernel operand reloaded by
// every warp for every tile; the float2 stores, each touching 8 pixels'
// lines; conv1's fragment building and epilogue.
//
// Backward (K3b) still computes on the CUDA cores, in the first design:
// bf16 values are widened to f32 (exactly) and multiplied with f32 FMAs.
// Its dy1 kernel has the forward's shape and can take the forward's
// tensor-core conv2 routine (`conv64_mma`) in its own redesign. What it
// does about the bytes:
// - Two kernels: dy1 = conv2^T(dz2)*[tap1 > 0] + bf16(g1*[tap1>0])
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

#define TH 8    // output tile rows of the backward's conv kernels
#define TW 16   // output tile columns (TH * TW = 128 = 32 groups of 4)
#define YH (TH + 2)
#define YW (TW + 2)
#define PW 33   // shared-memory words a pixel: 64 bf16 + 1 word of padding
#define NT 256
#define DH 8    // dx kernel tile rows
#define DW 32   // dx kernel tile columns (DH * DW = 256 = NT)

#define K2_BYTES (9 * 64 * 64 * 2)
#define DY1_SMEM (K2_BYTES + YH * YW * PW * 4)
#define DX_SMEM ((DH + 2) * (DW + 2) * PW * 4 + 9 * 64 * 16)

// Forward: FTH x FTW output tiles, y1 on FYH x FYW pixels (1-pixel halo), x
// on FXH x FXW pixels (2-pixel halo); FM y1 pixels in FM_BLOCKS m16 blocks;
// FNT threads a block, 2 blocks an SM.
#define FTH 8
#define FTW 16
#define FYH (FTH + 2)
#define FYW (FTW + 2)
#define FXH (FTH + 4)
#define FXW (FTW + 4)
#define FM (FYH * FYW)
#define FM_BLOCKS ((FM + 15) / 16)
#define FX_FLOATS (FXH * FXW * 3)
#define FNT 128
#define FWD_SMEM (K2_BYTES + FM * 128 + 2 * FX_FLOATS * 4 + 2 * 64 * 4)
#define MAX_DEVICES 64

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

// ---- tensor-core building blocks of the forward --------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major); bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (of 8) of row `row` in a table of
// 128-byte rows whose chunks are XOR-swizzled with the row's low 3 bits.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// acc[mb][nb] += the 3x3 convolution of a FYH x FYW-pixel tile of
// 64-channel bf16 pixels `in` (rows of 128 B, swizzled) with the kernel `k`
// ((9 * 64) rows [tap][ci] of 64 bf16 co, swizzled), for this warp's two
// output rows 2 * warp + mb of the FTH x FTW tile and output channels
// 8 * nb .. 8 * nb + 7. The m16n8 fragment layout: lane (g, q) = (lane / 4,
// lane % 4) holds acc[mb][nb][0..1] for output column g, channels
// 8 nb + 2q + {0, 1}, and acc[mb][nb][2..3] for column g + 8.
__device__ __forceinline__ void conv64_mma(uint32_t in, uint32_t k, int warp,
                                           int lane, float acc[2][8][4]) {
  // A: lane l gives the row of pixel column l % 16 at channel chunk l / 16
  int pa[2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) pa[mb] = (2 * warp + mb) * FYW + (lane & 15);
  const int ha = lane >> 4;
  // B (.trans): lane l gives kernel row ci = 8 * ((l / 8) % 2) + l % 8 of
  // the k16 step, co chunk 2 * np + l / 16
  const int brow = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int bh = lane >> 4;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * FYW + tap % 3;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
        ldsm_x4(in + swz(pa[mb] + shift, 2 * ks + ha), a[mb]);
      const int row = tap * 64 + ks * 16 + brow;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(k + swz(row, 2 * np + bh), b);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          mma_bf16(acc[mb][2 * np], a[mb], b[0], b[1]);
          mma_bf16(acc[mb][2 * np + 1], a[mb], b[2], b[3]);
        }
      }
    }
  }
}

// Starts the copy of x's (FXH x FXW x 3) halo around the tile at (h0, w0)
// into xs; zeros outside the image.
__device__ __forceinline__ void load_x(float* xs, const float* x, int h,
                                       int w, int h0, int w0) {
  for (int i = threadIdx.x; i < FX_FLOATS; i += FNT) {
    const int q = i / 3;
    const int gh = h0 - 2 + q / FXW;
    const int gw = w0 - 2 + q % FXW;
    if (inside(gh, gw, h, w))
      cp_async4(xs + i, x + ((size_t)gh * w + gw) * 3 + (i - 3 * q));
    else
      xs[i] = 0.f;
  }
}

// x (h, w, 3) f32; k1 (64, 32) bf16 [co][ky][kx][ci], k padded from 27 to 32
// with zeros; k2 (9, 64, 64) bf16 [ky][kx][ci][co]; taps (h, w, 64) f32.
// Two blocks an SM; block b takes tiles b, b + gridDim.x, ... in that order.
__global__ void __launch_bounds__(FNT, 2)
block1_fwd_kernel(const float* __restrict__ x, const uint32_t* __restrict__ k1,
                  const float* __restrict__ b1, const uint4* __restrict__ k2,
                  const float* __restrict__ b2, int h, int w,
                  float* __restrict__ tap1, float* __restrict__ tap2) {
  extern __shared__ uint4 smem[];
  uint4* k2s = smem;
  uint4* y1s = smem + K2_BYTES / 16;
  float* xs = reinterpret_cast<float*>(y1s + FM * 8);
  float* b1s = xs + 2 * FX_FLOATS;
  float* b2s = b1s + 64;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ntx = (w + FTW - 1) / FTW;
  const int ntiles = ntx * ((h + FTH - 1) / FTH);

  // once per block: k2 (swizzled), the biases, the first tile's x
  for (int i = tid; i < K2_BYTES / 16; i += FNT)
    cp_async16(k2s + (i & ~7) + ((i & 7) ^ ((i >> 3) & 7)), k2 + i);
  if (tid < 64) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  load_x(xs, x, h, w, (blockIdx.x / ntx) * FTH, (blockIdx.x % ntx) * FTW);
  cp_async_commit();

  // conv1's kernel as B fragments: kb[nb][ks] holds k = 16 ks + 2q + {0, 1}
  // and + 8 of channel 8 nb + g
  uint32_t kb[8][2][2];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      kb[nb][ks][0] = __ldg(k1 + (nb * 8 + g) * 16 + ks * 8 + q);
      kb[nb][ks][1] = __ldg(k1 + (nb * 8 + g) * 16 + ks * 8 + 4 + q);
    }
  // conv1's A fragments: this lane's k = 16 ks + 8 hi + 2q + e as an offset
  // into the x tile from a y1 pixel's top-left tap; -1 past k = 26
  int xoff[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 16 * ks + 8 * hi + 2 * q + e;
        const int tap = kk / 3;
        xoff[ks][hi][e] =
            kk < 27 ? ((tap / 3) * FXW + tap % 3) * 3 + kk % 3 : -1;
      }
  const uint32_t y1a = smem_addr(y1s);
  const uint32_t k2a = smem_addr(k2s);

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const float* xb = xs + (it & 1) * FX_FLOATS;
    const int h0 = (tile / ntx) * FTH;
    const int w0 = (tile % ntx) * FTW;
    cp_async_wait_all();
    __syncthreads();  // x is here, and the last tile's conv2 is done with y1s

    // conv1 on the y1 tile: M = FM pixels, N = 64, K = 32
    for (int mb = warp; mb < FM_BLOCKS; mb += FNT / 32) {
      int base[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = min(mb * 16 + g + 8 * hh, FM - 1);
        base[hh] = ((m / FYW) * FXW + m % FYW) * 3;
      }
      float acc[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nb][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int o0 = xoff[ks][hi][0];
            const int o1 = xoff[ks][hi][1];
            a[2 * hi + hh] = pack_bf16(o0 >= 0 ? xb[base[hh] + o0] : 0.f,
                                       o1 >= 0 ? xb[base[hh] + o1] : 0.f);
          }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          mma_bf16(acc[nb], a, kb[nb][ks][0], kb[nb][ks][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mb * 16 + g + 8 * hh;
        if (m >= FM) continue;
        const int r = m / FYW;
        const int c = m % FYW;
        const int gh = h0 - 1 + r;
        const int gw = w0 - 1 + c;
        const bool in = inside(gh, gw, h, w);
        const bool own = in && r >= 1 && r <= FTH && c >= 1 && c <= FTW;
        uint32_t* yrow = reinterpret_cast<uint32_t*>(y1s + m * 8);
        float* t1 = own ? tap1 + ((size_t)gh * w + gw) * 64 + 2 * q : tap1;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 bb = *reinterpret_cast<const float2*>(b1s + nb * 8 + 2 * q);
          const float v0 = in ? fmaxf(acc[nb][2 * hh] + bb.x, 0.f) : 0.f;
          const float v1 = in ? fmaxf(acc[nb][2 * hh + 1] + bb.y, 0.f) : 0.f;
          yrow[((nb ^ (m & 7)) << 2) + q] = pack_bf16(v0, v1);
          if (own) *reinterpret_cast<float2*>(t1 + nb * 8) = make_float2(v0, v1);
        }
      }
    }
    __syncthreads();  // y1s is whole; every thread is done with xb

    const int next = tile + gridDim.x;
    if (next < ntiles)
      load_x(xs + ((it + 1) & 1) * FX_FLOATS, x, h, w, (next / ntx) * FTH,
             (next % ntx) * FTW);
    cp_async_commit();

    float acc[2][8][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mb][nb][j] = 0.f;
    conv64_mma(y1a, k2a, warp, lane, acc);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int gh = h0 + 2 * warp + mb;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gw = w0 + g + 8 * hh;
        if (gh >= h || gw >= w) continue;
        float* t2 = tap2 + ((size_t)gh * w + gw) * 64 + 2 * q;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 bb = *reinterpret_cast<const float2*>(b2s + nb * 8 + 2 * q);
          *reinterpret_cast<float2*>(t2 + nb * 8) =
              make_float2(fmaxf(acc[mb][nb][2 * hh] + bb.x, 0.f),
                          fmaxf(acc[mb][nb][2 * hh + 1] + bb.y, 0.f));
        }
      }
    }
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

// How many times the forward's C entry set the kernel's shared-memory limit
// (once per device and process).
static int fwd_setups = 0;

// Returns cudaGetLastError() after the launch.
extern "C" int block1_fwd(const float* x, const void* k1, const float* b1,
                          const void* k2, const float* b2, int h, int w,
                          float* tap1, float* tap2, cudaStream_t stream) {
  static int sm_count[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(block1_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = n;
    ++fwd_setups;
  }
  const int ntiles = ((h + FTH - 1) / FTH) * ((w + FTW - 1) / FTW);
  if (ntiles == 0) return 0;
  const int grid = ntiles < 2 * sm_count[dev] ? ntiles : 2 * sm_count[dev];
  block1_fwd_kernel<<<grid, FNT, FWD_SMEM, stream>>>(
      x, static_cast<const uint32_t*>(k1), b1, static_cast<const uint4*>(k2),
      b2, h, w, tap1, tap2);
  return (int)cudaGetLastError();
}

extern "C" int block1_fwd_setups(void) { return fwd_setups; }

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
