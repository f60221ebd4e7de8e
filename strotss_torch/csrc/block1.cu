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
// Backward (K3b), on the tensor cores as well, in two kernels joined by a
// bf16 scratch dy1 (128 B a pixel, written once and read once, mostly from
// L2: 2 x 128 B of the bound's 1036 B a pixel):
// - dy1 = r(conv(dz2, k2r) * [tap1 > 0] + r(g1 * [tap1 > 0])) with
//   dz2 = r(g2 * [tap2 > 0]). The transposed conv2 is a plain 3x3
//   convolution with k2 flipped and its channel axes swapped ([tap][co][ci],
//   laid out once per weight tensor by the wrapper), so it is K3a's conv2
//   routine `conv64_mma` as it is, on the same 8 x 16 tiles: persistent
//   blocks, two of 128 threads an SM (97 KB of shared memory each), copy
//   the 73.7 KB kernel into shared memory once and walk the tiles with a
//   fixed stride. Per tile the block builds dz2 on the tile plus a 1-pixel
//   halo from f32 g2 and tap2 (masked and rounded, so no `cp.async`; each
//   thread keeps 4 pixel chunks' loads in flight), zero outside the image;
//   the epilogue reads tap1 and g1 at the mma fragments' positions (a lane
//   quad covers one 32-byte sector) and writes r(dy1). The other block on
//   the SM overlaps one block's loads with its mma.
// - dx = conv(dy1, k1r) on `mma.sync` too: M = 128 pixels, K = 9 taps x 64
//   channels, N = 8 (3 channels and 5 zero columns). The dy1 tile with its
//   halo comes by `cp.async` into one of two buffers while the other is
//   read with `ldmatrix`; k1r (9 KB) stays in registers as B fragments.
// As in the forward, the wrapper builds the weight layouts once per weight
// tensor, and the C entry sets the dy1 kernel's shared-memory limit once
// per device. Measured on an H100 80GB HBM3 at 700 W (`chip_smoke.py`,
// 384 x 512): 0.110 ms on the device, 1.8x its bound (dy1 0.095 ms, dx
// 0.015), where the CUDA-core design it replaces took 0.50 ms (dy1 0.445,
// dx 0.053). dy1 is now 1.4x its own floor (g1, g2, tap1 and tap2 read,
// dy1 written: 1,152 B a pixel, 0.068 ms); what holds it there is not
// measured yet. Candidates: the halo's 1.41x reads of g2 and tap2, and a
// block's dz2 build, which nothing in the block overlaps.
//
// Pair axis: both directions take nimg images of one shape, contiguous as
// (nimg, h, w, c). The persistent blocks walk the tiles of all images as one
// sequence, walk index t being tile t % ntiles of image t / ntiles; the
// next tile's prefetch reads from that tile's own image, and the grid is
// sized by nimg * ntiles. A tile's arithmetic does not depend on which
// block takes it, so each image's result is bit for bit the result of a
// one-image launch, and one C call per direction serves the whole batch.
// Measured on an H100 80GB HBM3 at 700 W (`chip_smoke.py`, 8 images): at
// 48 x 64 (24 tiles an image) the batched forward takes 0.041 ms wall
// against 0.386 ms for 8 one-image launches, the backward 0.074 against
// 0.488; at 384 x 512 the forward 0.503 against 0.535 (0.440 ms on the
// device, 1.8x its bound), the backward 0.842 against 0.959.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define K2_BYTES (9 * 64 * 64 * 2)

// FTH x FTW output tiles in both directions. Forward: y1 on FYH x FYW
// pixels (1-pixel halo), x on FXH x FXW pixels (2-pixel halo); FM y1 pixels
// in FM_BLOCKS m16 blocks; FNT threads a block, 2 blocks an SM. Backward:
// dz2 and dy1 on FYH x FYW pixels.
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
#define DY1_SMEM (K2_BYTES + FM * 128)
#define DX_SMEM (2 * FM * 128)  // under 48 KB: no attribute to set
#define DX_BLOCKS 4             // dx blocks an SM
#define MAX_DEVICES 64

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ bool inside(int gh, int gw, int h, int w) {
  return gh >= 0 && gh < h && gw >= 0 && gw < w;
}

// ---- tensor-core building blocks --------------------------------------

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

// x (nimg, h, w, 3) f32; k1 (64, 32) bf16 [co][ky][kx][ci], k padded from 27
// to 32 with zeros; k2 (9, 64, 64) bf16 [ky][kx][ci][co]; taps (nimg, h, w,
// 64) f32. The tiles of all images form one walk: walk index t is tile
// t % ntiles of image t / ntiles. Two blocks an SM; block b takes t = b,
// b + gridDim.x, ... in that order.
__global__ void __launch_bounds__(FNT, 2)
block1_fwd_kernel(const float* __restrict__ x, const uint32_t* __restrict__ k1,
                  const float* __restrict__ b1, const uint4* __restrict__ k2,
                  const float* __restrict__ b2, int h, int w, int nimg,
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
  const int nwalk = nimg * ntiles;
  const size_t hw = (size_t)h * w;

  // once per block: k2 (swizzled), the biases, the first tile's x
  for (int i = tid; i < K2_BYTES / 16; i += FNT)
    cp_async16(k2s + (i & ~7) + ((i & 7) ^ ((i >> 3) & 7)), k2 + i);
  if (tid < 64) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  {
    const int img = blockIdx.x / ntiles;
    const int tile = blockIdx.x - img * ntiles;
    load_x(xs, x + img * hw * 3, h, w, (tile / ntx) * FTH,
           (tile % ntx) * FTW);
  }
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
  for (int t = blockIdx.x; t < nwalk; t += gridDim.x, ++it) {
    const float* xb = xs + (it & 1) * FX_FLOATS;
    const int img = t / ntiles;
    const int tile = t - img * ntiles;
    const int h0 = (tile / ntx) * FTH;
    const int w0 = (tile % ntx) * FTW;
    float* const tap1i = tap1 + img * hw * 64;
    float* const tap2i = tap2 + img * hw * 64;
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
        float* t1 = own ? tap1i + ((size_t)gh * w + gw) * 64 + 2 * q : tap1i;
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

    // the next tile's x, from its own image
    const int next = t + gridDim.x;
    if (next < nwalk) {
      const int nxt_img = next / ntiles;
      const int nxt_tile = next - nxt_img * ntiles;
      load_x(xs + ((it + 1) & 1) * FX_FLOATS, x + nxt_img * hw * 3, h, w,
             (nxt_tile / ntx) * FTH, (nxt_tile % ntx) * FTW);
    }
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
        float* t2 = tap2i + ((size_t)gh * w + gw) * 64 + 2 * q;
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

// Writes dz2 = r(g2 * [tap2 > 0]) on the FYH x FYW pixels around the tile
// at (h0, w0) into dzs as 128-byte bf16 rows, swizzled; 0 outside the
// image (the transposed convolution's SAME padding). Each thread starts the
// loads of 4 of its 16-byte chunks before it packs any of them.
__device__ __forceinline__ void build_dz2(uint4* dzs, const float* g2,
                                          const float* tap2, int h, int w,
                                          int h0, int w0) {
  constexpr int PER = (FM * 8 + FNT - 1) / FNT;
  constexpr int BATCH = 4;
  static_assert(PER % BATCH == 0, "whole batches of chunks a thread");
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += BATCH) {
    float4 gv[BATCH][2], tv[BATCH][2];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (j0 + j) * FNT;
      const int m = i >> 3;
      const int gh = h0 - 1 + m / FYW;
      const int gw = w0 - 1 + m % FYW;
      if (i < FM * 8 && inside(gh, gw, h, w)) {
        const size_t at = ((size_t)gh * w + gw) * 64 + (i & 7) * 8;
        const float4* gp = reinterpret_cast<const float4*>(g2 + at);
        const float4* tp = reinterpret_cast<const float4*>(tap2 + at);
        gv[j][0] = gp[0];
        gv[j][1] = gp[1];
        tv[j][0] = tp[0];
        tv[j][1] = tp[1];
      } else {
        tv[j][0] = tv[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        gv[j][0] = gv[j][1] = tv[j][0];
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = threadIdx.x + (j0 + j) * FNT;
      if (i >= FM * 8) continue;
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 gg = gv[j][e];
        const float4 tt = tv[j][e];
        u[2 * e] = pack_bf16(tt.x > 0.f ? gg.x : 0.f, tt.y > 0.f ? gg.y : 0.f);
        u[2 * e + 1] = pack_bf16(tt.z > 0.f ? gg.z : 0.f, tt.w > 0.f ? gg.w : 0.f);
      }
      const int m = i >> 3;
      dzs[(i & ~7) + ((i & 7) ^ (m & 7))] = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// dy1 = r(conv(dz2, k2r) * [tap1 > 0] + r(g1 * [tap1 > 0])) with
// dz2 = r(g2 * [tap2 > 0]); k2r (9, 64, 64) bf16 is k2 flipped in both
// spatial axes with its channel axes swapped, [ky][kx][co][ci]; tap1, tap2,
// g1, g2 (nimg, h, w, 64) f32; dy1 (nimg, h, w, 64) bf16. Two blocks an SM;
// block b takes walk indices t = b, b + gridDim.x, ... in that order, tile
// t % ntiles of image t / ntiles.
__global__ void __launch_bounds__(FNT, 2)
block1_dy1_kernel(const float* __restrict__ tap1, const float* __restrict__ tap2,
                  const float* __restrict__ g1, const float* __restrict__ g2,
                  const uint4* __restrict__ k2r, int h, int w, int nimg,
                  uint32_t* __restrict__ dy1) {
  extern __shared__ uint4 smem[];
  uint4* k2s = smem;
  uint4* dzs = smem + K2_BYTES / 16;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ntx = (w + FTW - 1) / FTW;
  const int ntiles = ntx * ((h + FTH - 1) / FTH);
  const int nwalk = nimg * ntiles;
  const size_t hw64 = (size_t)h * w * 64;

  // once per block: k2r, swizzled as K3a's k2
  for (int i = tid; i < K2_BYTES / 16; i += FNT)
    cp_async16(k2s + (i & ~7) + ((i & 7) ^ ((i >> 3) & 7)), k2r + i);
  cp_async_commit();
  const uint32_t dza = smem_addr(dzs);
  const uint32_t k2a = smem_addr(k2s);

  for (int t = blockIdx.x; t < nwalk; t += gridDim.x) {
    const int img = t / ntiles;
    const int tile = t - img * ntiles;
    const int h0 = (tile / ntx) * FTH;
    const int w0 = (tile % ntx) * FTW;
    const float* const tap1i = tap1 + img * hw64;
    const float* const g1i = g1 + img * hw64;
    uint32_t* const dy1i = dy1 + img * hw64 / 2;
    __syncthreads();  // the last tile's convolution is done with dzs
    build_dz2(dzs, g2 + img * hw64, tap2 + img * hw64, h, w, h0, w0);
    cp_async_wait_all();
    __syncthreads();  // dz2 is whole; k2r is here

    float acc[2][8][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mb][nb][j] = 0.f;
    conv64_mma(dza, k2a, warp, lane, acc);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int gh = h0 + 2 * warp + mb;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gw = w0 + g + 8 * hh;
        if (gh >= h || gw >= w) continue;
        const size_t px = (size_t)gh * w + gw;
        const float* t1 = tap1i + px * 64 + 2 * q;
        const float* gg = g1i + px * 64 + 2 * q;
        uint32_t* d = dy1i + px * 32 + q;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 t = *reinterpret_cast<const float2*>(t1 + nb * 8);
          const float2 gv = *reinterpret_cast<const float2*>(gg + nb * 8);
          d[nb * 4] = pack_bf16(
              t.x > 0.f ? acc[mb][nb][2 * hh] + bf16r(gv.x) : 0.f,
              t.y > 0.f ? acc[mb][nb][2 * hh + 1] + bf16r(gv.y) : 0.f);
        }
      }
    }
  }
}

// Starts the copy of dy1's FYH x FYW pixels around the tile at (h0, w0)
// into ts as swizzled 128-byte rows; zeros outside the image.
__device__ __forceinline__ void load_dy1(uint4* ts, const uint4* dy1, int h,
                                         int w, int h0, int w0) {
  for (int i = threadIdx.x; i < FM * 8; i += FNT) {
    const int m = i >> 3;
    const int gh = h0 - 1 + m / FYW;
    const int gw = w0 - 1 + m % FYW;
    uint4* dst = ts + (i & ~7) + ((i & 7) ^ (m & 7));
    if (inside(gh, gw, h, w))
      cp_async16(dst, dy1 + ((size_t)gh * w + gw) * 8 + (i & 7));
    else
      *dst = make_uint4(0u, 0u, 0u, 0u);
  }
}

// dx = conv(dy1, k1r): k1r (9, 64, 8) bf16 [ky][kx][co][c] is k1 flipped in
// both spatial axes with its channel axes swapped, c padded from 3 to 8
// with zeros; dy1 (nimg, h, w, 64) bf16; dx (nimg, h, w, 3) f32. DX_BLOCKS
// blocks an SM, each walking the tiles of all images as the dy1 kernel
// does, the next tile's dy1 (from its own image) in flight.
__global__ void __launch_bounds__(FNT, DX_BLOCKS)
block1_dx_kernel(const uint4* __restrict__ dy1,
                 const unsigned short* __restrict__ k1r, int h, int w,
                 int nimg, float* __restrict__ dx) {
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ntx = (w + FTW - 1) / FTW;
  const int ntiles = ntx * ((h + FTH - 1) / FTH);
  const int nwalk = nimg * ntiles;
  const size_t hw = (size_t)h * w;

  {
    const int img = blockIdx.x / ntiles;
    const int tile = blockIdx.x - img * ntiles;
    load_dy1(smem, dy1 + img * hw * 8, h, w, (tile / ntx) * FTH,
             (tile % ntx) * FTW);
  }
  cp_async_commit();
  // k1r as B fragments: kb[tap][ks][j] holds k = 16 ks + 8 j + 2q + {0, 1}
  // of output channel g
  uint32_t kb[9][4][2];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = tap * 64 + 16 * ks + 8 * j + 2 * q;
        kb[tap][ks][j] = (uint32_t)__ldg(k1r + k * 8 + g) |
                         ((uint32_t)__ldg(k1r + (k + 1) * 8 + g) << 16);
      }
  // A: lane l gives the row of pixel column l % 16 at channel chunk l / 16
  int pa[2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) pa[mb] = (2 * warp + mb) * FYW + (lane & 15);
  const int ha = lane >> 4;

  int it = 0;
  for (int t = blockIdx.x; t < nwalk; t += gridDim.x, ++it) {
    const int img = t / ntiles;
    const int tile = t - img * ntiles;
    const int h0 = (tile / ntx) * FTH;
    const int w0 = (tile % ntx) * FTW;
    cp_async_wait_all();
    __syncthreads();  // this tile's dy1 is here; the other buffer is free
    const int next = t + gridDim.x;
    if (next < nwalk) {
      const int nxt_img = next / ntiles;
      const int nxt_tile = next - nxt_img * ntiles;
      load_dy1(smem + ((it + 1) & 1) * FM * 8, dy1 + nxt_img * hw * 8, h, w,
               (nxt_tile / ntx) * FTH, (nxt_tile % ntx) * FTW);
    }
    cp_async_commit();

    const uint32_t in = smem_addr(smem + (it & 1) * FM * 8);
    float acc[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mb][j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * FYW + tap % 3;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          uint32_t a[4];
          ldsm_x4(in + swz(pa[mb] + shift, 2 * ks + ha), a);
          mma_bf16(acc[mb], a, kb[tap][ks][0], kb[tap][ks][1]);
        }
    }
    // lane (g, q) holds channels 2q, 2q + 1 of columns g and g + 8: lanes
    // q = 0 and 1 hold the 3 real ones
    if (q < 2) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int gh = h0 + 2 * warp + mb;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int gw = w0 + g + 8 * hh;
          if (gh >= h || gw >= w) continue;
          float* o = dx + (img * hw + (size_t)gh * w + gw) * 3 + 2 * q;
          o[0] = acc[mb][2 * hh];
          if (q == 0) o[1] = acc[mb][2 * hh + 1];
        }
      }
    }
  }
}

// Per device: the SM count, read once, and how many times each C entry set
// its kernels' shared-memory limits (once per device and process).
static int sm_count[MAX_DEVICES];
static bool fwd_ready[MAX_DEVICES];
static bool bwd_ready[MAX_DEVICES];
static int fwd_setups = 0;
static int bwd_setups = 0;

// The current device and its SM count.
static cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[*dev] == 0)
    err = cudaDeviceGetAttribute(&sm_count[*dev],
                                 cudaDevAttrMultiProcessorCount, *dev);
  return err;
}

static int tiles(int h, int w) {
  return ((h + FTH - 1) / FTH) * ((w + FTW - 1) / FTW);
}

// How many blocks to launch: `per_sm` an SM, no more than there are tiles
// in the walk (all images' tiles).
static int grid_size(int nwalk, int per_sm, int dev) {
  const int full = per_sm * sm_count[dev];
  return nwalk < full ? nwalk : full;
}

// x and the taps hold nimg images; one launch walks all their tiles.
// Returns cudaGetLastError() after the launch.
extern "C" int block1_fwd(const float* x, const void* k1, const float* b1,
                          const void* k2, const float* b2, int h, int w,
                          int nimg, float* tap1, float* tap2,
                          cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!fwd_ready[dev]) {
    err = cudaFuncSetAttribute(block1_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    fwd_ready[dev] = true;
    ++fwd_setups;
  }
  const int nwalk = nimg * tiles(h, w);
  if (nwalk == 0) return 0;
  block1_fwd_kernel<<<grid_size(nwalk, 2, dev), FNT, FWD_SMEM, stream>>>(
      x, static_cast<const uint32_t*>(k1), b1, static_cast<const uint4*>(k2),
      b2, h, w, nimg, tap1, tap2);
  return (int)cudaGetLastError();
}

extern "C" int block1_fwd_setups(void) { return fwd_setups; }

// The taps, cotangents and dx hold nimg images. Scratch: dy1 holds
// nimg * h * w * 64 bf16. Returns cudaGetLastError() after both launches.
extern "C" int block1_bwd(const float* tap1, const float* tap2,
                          const float* g1, const float* g2, const void* k2r,
                          const void* k1r, int h, int w, int nimg, void* dy1,
                          float* dx, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!bwd_ready[dev]) {
    err = cudaFuncSetAttribute(block1_dy1_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DY1_SMEM);
    if (err != cudaSuccess) return (int)err;
    bwd_ready[dev] = true;
    ++bwd_setups;
  }
  const int nwalk = nimg * tiles(h, w);
  if (nwalk == 0) return 0;
  block1_dy1_kernel<<<grid_size(nwalk, 2, dev), FNT, DY1_SMEM,
                      stream>>>(tap1, tap2, g1, g2,
                                static_cast<const uint4*>(k2r), h, w, nimg,
                                static_cast<uint32_t*>(dy1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block1_dx_kernel<<<grid_size(nwalk, DX_BLOCKS, dev), FNT, DX_SMEM,
                     stream>>>(static_cast<const uint4*>(dy1),
                               static_cast<const unsigned short*>(k1r), h, w,
                               nimg, dx);
  return (int)cudaGetLastError();
}

extern "C" int block1_bwd_setups(void) { return bwd_setups; }
