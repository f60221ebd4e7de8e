// One streamed Sinkhorn half-update: out_i = LSE_j(-lam * d_ij + logv_j)
// for x (N, C) and y (M, C), without writing the N x M distance matrix.
//
// Replaces the Pallas kernel strotss_tpu/ops/kernels/sinkhorn.py
// (`_lse_kernel`, called from `lse_pass`). d is the cosine, L2 or 'both'
// distance with the floors of tile.cuh's tile_dist: squared norms floored
// at 1e-12 before the rsqrt, L2 as sqrt(max(|x|^2 + |y|^2 - 2 x.y, 1e-6) /
// C). Columns at or past M contribute nothing. The transposed update, LSE
// over the rows, is the same call with x and y swapped: every distance is
// symmetric. There are no atomics, and partial results are combined in a
// fixed order, so every result is the same bit for bit on every run.
//
// Operands are prepared once per solve (`sinkhorn_prep_kernel`, one launch
// for x and y): the 60 passes of a solve only swap x and y and change logv.
// Rows are padded with zeros to a multiple of SK_ROW_PAD and channels to
// C' (`sk_cpad`), and each row's squared norm (f32, summed lane by lane
// over a warp, then a fixed butterfly) and 1 / sqrt(max(norm, 1e-12)) are
// stored beside the rows. That is O((N + M) C) memory: 1.2 GB for a
// 32769-sample feature solve.
//
// Two routes, chosen by C alone (SK_TC_MIN_C, as K1's REMD_TC_MIN_C):
//
// Tensor-core route (`sinkhorn_lse_tc_kernel`, C >= 32: the 2179-channel
// feature term).
// - Bound on an H100 SXM (495 TFLOP/s TF32 dense, 3.35 TB/s): one pass at
//   N = M = 32769, C = 2179 does 2NMC = 4.68e12 operations of products;
//   as three TF32 products each, 1.40e13, 28.4 ms (69.9 ms on the fp32
//   CUDA cores). It must read (N + M) C 4 B = 0.57 GB, 0.17 ms: it is bound
//   by operations.
// - Precision. The JAX kernel's products are Precision.HIGHEST and the
//   result is held to 1e-5 of max|out|, where lam * d goes straight into
//   the exponent, so plain TF32 cannot serve. The preparation splits each
//   f32 value v into TF32 parts big = rna(v) and small = rna(v - big) (the
//   bits of tc.cuh's tf32_split), stored as (2, rows, C') with C' = C
//   rounded up to 32: 128-byte rows, which TMA addresses (the raw rows of
//   8716 bytes are not 16-byte multiples). x.y is big.small + small.big +
//   big.big ("3xTF32"; the dropped small.small is ~2^-22 of a product).
// - Products: `wgmma.mma_async.m64n192k8.f32.tf32.tf32`, both operands
//   K-major from shared memory through descriptors (64-byte swizzle, rows
//   of 16 channels, as TMA writes them). A block of 256 threads owns a
//   128-row strip of x and a chunk of its column tiles of BN = 192 columns;
//   its two warpgroups each multiply 64 rows by BN columns, 3 x 2 wgmma a
//   stage of 16 channels, one wgmma group in flight behind the one being
//   issued. Thread 0 also issues the TMA copies of each stage (the four
//   parts of 16 channels of the 128 x rows and BN y rows, 40 KB) into a
//   ring of 5 stages with full/empty mbarriers. A producer warp of its own
//   would put 3 warps on one SM sub-partition and cap every thread at 168
//   registers; ptxas did not give the consumers more after setmaxnreg.
// - Accumulation. The tensor cores' f32 sums truncate. Summed over all of
//   C in the accumulators (a build with 256-column tiles and no
//   promotion, which tools/k4_ablation.py makes from an edited copy of
//   this file), the 32769 x 32769 x 2179 cosine pass came 1.2e-5 of
//   max|out| from the plain version, over check_lse's 1e-5; each period of
//   SK_PERIOD = 8 stages (128 channels) summed on the tensor cores and then
//   added into f32 registers came 1.4e-6 (vs float64 1.9e-7, the plain
//   version 2.7e-7; PERF.md). The two f32 sets of 96 registers bound BN at
//   192. The period's end is no branch: ptxas serializes every wgmma of a
//   kernel that touches the accumulators on a path it cannot prove uniform
//   (its advisory C7518, which tools/k4_ablation.py prints if it appears).
// - Epilogue in registers. After a column tile's last period, each thread
//   forms d and z = -lam d + logv_j for its 2 rows x BN/4 columns from the
//   f32 sums and the tile's column data (staged in shared memory when the
//   tile starts) and folds them into its own running (max, sum) per row,
//   with accurate expf (no fast math). At the end of its chunk the lane
//   quad that shares a row combines its four pairs by shuffles; lane 0
//   writes the chunk's (max, sum).
// - Grid. N = 32769 is 256 full strips and one strip of one row; one block
//   a strip leaves the 257th alone for a whole sweep. Each strip's column
//   tiles are split over S chunks (`sinkhorn.lse_split` picks S from N, M
//   and the SM count), one block an item (strip, chunk), the chunks of one
//   strip next to each other so that blocks running together share the x
//   strip in L2;
//   `sinkhorn_combine_kernel` folds the S partials of each row in chunk
//   order.
// - Measured (H100 80GB HBM3, 700 W; chip_smoke.py and
//   tools/k4_ablation.py, PERF.md): 43-48 ms at 32769 x 32769 x 2179
//   cosine, 1.5-1.7x the bound above; the unpromoted 256-column build
//   38-40 ms: the wgmma reach ~66% of the 3xTF32 rate with 192 columns and
//   promotion, ~73% with 256 and none.
//
// CUDA-core route (`sinkhorn_lse_cc_kernel<KC4>`, C < 32: the YUV term,
// C = 3, 'both'). Bound: one expf and one sqrtf a pair, 2NM = 2.1e9
// special-function results at 16 per SM and clock, 0.51 ms at 32769^2.
// Each thread keeps 4 rows (C padded to a multiple of 4, in float4
// registers) with their norms; a block of 256 threads owns 1024 rows and
// sweeps a chunk of 256-column tiles staged in shared memory, every thread
// reading the same column (a broadcast). Each pair costs C' FMAs, the
// distance, and one expf: the running max is raised only when z exceeds
// it (the sum rescaled then), and each tile's terms are summed apart and
// then added to the running sum. The old route streamed 32-wide zero-filled
// slices through tile_dot, 32 FMAs a pair where 3 are needed: 5.66 ms
// there, 1.8 ms here.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

#define SK_TC_MIN_C 32  // C from which the tensor-core route is taken
#define SK_ROW_PAD 256  // prepared rows: a multiple of this
#define SK_TC_CPAD 32   // tensor-core route: C' a multiple of this
#define SK_BM 128       // x rows of a block (2 warpgroups x 64)
#define SK_BN 192       // y columns of a tile
#define SK_KS 16        // channels a stage (64-byte rows)
#define SK_PERIOD 8     // stages summed on the tensor cores, then in f32
#define SK_RING_BYTES (200 * 1024)  // shared memory for the ring of stages
#define SK_CC_ROWS 4    // CUDA-core route: rows a thread
#define SK_CC_TILE 256  // CUDA-core route: columns a tile, threads a block
#define NEG_BIG (-3.4e38f)

// ---- preparation ---------------------------------------------------------

static __host__ __device__ int sk_cpad(int c) {
  return c >= SK_TC_MIN_C ? (c + SK_TC_CPAD - 1) / SK_TC_CPAD * SK_TC_CPAD
                          : (c + 3) / 4 * 4;
}

// One warp a row of x (rows 0..rows_x-1) or of y (then rows_y more).
// Tensor-core route: parts (2, rows, cp), big then small; CUDA-core route:
// the f32 values (rows, cp). norms (2, rows): |row|^2 and
// 1 / sqrt(max(|row|^2, 1e-12)). Zero past the real rows and channels.
__global__ void __launch_bounds__(256)
sinkhorn_prep_kernel(const float* __restrict__ x, int n,
                     const float* __restrict__ y, int m, int c, int cp,
                     int tc, float* __restrict__ px, float* __restrict__ nx,
                     int rows_x, float* __restrict__ py,
                     float* __restrict__ ny, int rows_y) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool is_y = w >= rows_x;
  const int r = is_y ? w - rows_x : w;
  if (is_y && r >= rows_y) return;
  const float* src = is_y ? y : x;
  const int real = is_y ? m : n;
  const int rows = is_y ? rows_y : rows_x;
  float* parts = is_y ? py : px;
  float* norms = is_y ? ny : nx;
  float sq = 0.f;
  for (int k = lane; k < cp; k += 32) {
    const float v = (r < real && k < c) ? src[(size_t)r * c + k] : 0.f;
    sq = fmaf(v, v, sq);
    if (tc) {
      uint32_t big, small;
      tf32_split(v, big, small);
      parts[(size_t)r * cp + k] = __uint_as_float(big);
      parts[((size_t)rows + r) * cp + k] = __uint_as_float(small);
    } else {
      parts[(size_t)r * cp + k] = v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) {
    norms[r] = sq;
    norms[rows + r] = 1.0f / sqrtf(fmaxf(sq, 1e-12f));
  }
}

// ---- shared by both routes -----------------------------------------------

// tile_dist's distance of one pair from its dot product and the prepared
// norms.
__device__ __forceinline__ float sk_dist(float dot, float xs, float rx,
                                         float ys, float ry, int dist,
                                         float inv_c) {
  float v = 0.f;
  if (dist != DIST_L2) v = 1.0f - (dot * rx) * ry;
  if (dist != DIST_COS) v += sqrtf(fmaxf(xs + ys - 2.0f * dot, 1e-6f) * inv_c);
  return v;
}

// (max, sum) of two partial LSEs; commutative bit for bit, so the lanes of
// a butterfly agree.
__device__ __forceinline__ void sk_merge(float& mx, float& sm, float omx,
                                         float osm) {
  const float nm = fmaxf(mx, omx);
  sm = sm * expf(mx - nm) + osm * expf(omx - nm);
  mx = nm;
}

// The column tiles [t0, t1) of chunk q of `tiles` over `split` chunks.
__device__ __forceinline__ void sk_chunk(int q, int tiles, int split,
                                         int& t0, int& t1) {
  t0 = (int)((long long)q * tiles / split);
  t1 = (int)((long long)(q + 1) * tiles / split);
}

// out_r = log(sum_q s_qr exp(m_qr - M_r)) + M_r over the chunks in order;
// part (2, split, n): maxima, then sums.
__global__ void __launch_bounds__(256)
sinkhorn_combine_kernel(const float* __restrict__ part, int n, int split,
                        float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float mx = NEG_BIG;
  for (int q = 0; q < split; ++q) mx = fmaxf(mx, part[(size_t)q * n + r]);
  float sm = 0.f;
  for (int q = 0; q < split; ++q)
    sm += part[((size_t)split + q) * n + r] *
          expf(part[(size_t)q * n + r] - mx);
  out[r] = logf(fmaxf(sm, 1e-38f)) + mx;
}

// ---- tensor-core route ---------------------------------------------------

WGMMA_TF32_SS(96, "192", WG_R96, WG_F96, "96", "97", "98")

// Folds one column tile's dot products (the accumulators) into the running
// (max, sum) of the thread's two rows a (g) and b (g + 8). cb: the tile's
// |y|^2, 1 / |y| and logv in shared memory, SK_BN each.
__device__ __forceinline__ void sk_tile_epilogue(
    float (&acc)[SK_BN / 2], int col0, int m, const float* cb, float xs_a,
    float rx_a, float xs_b, float rx_b, int dist, float lam, float inv_c,
    float& mx_a, float& sm_a, float& mx_b, float& sm_b) {
  const int t4 = threadIdx.x % 4;
  float tmax_a = NEG_BIG, tmax_b = NEG_BIG;
#pragma unroll
  for (int j = 0; j < SK_BN / 8; ++j) {
    const int cl = 8 * j + 2 * t4;
    const float2 ys = *reinterpret_cast<const float2*>(cb + cl);
    const float2 ry = *reinterpret_cast<const float2*>(cb + SK_BN + cl);
    const float2 lv = *reinterpret_cast<const float2*>(cb + 2 * SK_BN + cl);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = col0 + cl + e < m;
      const float ysv = e ? ys.y : ys.x, ryv = e ? ry.y : ry.x;
      const float lvv = e ? lv.y : lv.x;
      const float za =
          -lam * sk_dist(acc[4 * j + e], xs_a, rx_a, ysv, ryv, dist, inv_c) +
          lvv;
      const float zb = -lam * sk_dist(acc[4 * j + 2 + e], xs_b, rx_b, ysv,
                                      ryv, dist, inv_c) +
                       lvv;
      acc[4 * j + e] = in ? za : NEG_BIG;
      acc[4 * j + 2 + e] = in ? zb : NEG_BIG;
      tmax_a = fmaxf(tmax_a, acc[4 * j + e]);
      tmax_b = fmaxf(tmax_b, acc[4 * j + 2 + e]);
    }
    // one n8 block's column data at a time: hoisting every block's loads
    // would take 3 SK_BN / 4 registers
    asm volatile("" ::: "memory");
  }
  const float nm_a = fmaxf(mx_a, tmax_a), nm_b = fmaxf(mx_b, tmax_b);
  float s_a = 0.f, s_b = 0.f;
#pragma unroll
  for (int j = 0; j < SK_BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // masked columns hold NEG_BIG: they add nothing, even where no
      // column of the thread's has been inside yet
      const bool in = col0 + 8 * j + 2 * t4 + e < m;
      s_a += in ? expf(acc[4 * j + e] - nm_a) : 0.f;
      s_b += in ? expf(acc[4 * j + 2 + e] - nm_b) : 0.f;
    }
  sm_a = sm_a * expf(mx_a - nm_a) + s_a;
  sm_b = sm_b * expf(mx_b - nm_b) + s_b;
  mx_a = nm_a;
  mx_b = nm_b;
}

// Shared-memory plan of the tensor-core kernel. A stage holds 16 channels
// of the big, then the small parts of the 128 x rows, then of the SK_BN
// y rows.
struct SkTc {
  static constexpr int A_BYTES = SK_BM * SK_KS * 4;  // one part, x rows
  static constexpr int B_BYTES = SK_BN * SK_KS * 4;  // one part, y rows
  static constexpr int STAGE = 2 * (A_BYTES + B_BYTES);
  static constexpr int STAGES = SK_RING_BYTES / STAGE;
  // stages, full and empty barriers, two tiles' column data, alignment
  static constexpr int SMEM =
      STAGES * STAGE + 2 * STAGES * 8 + 2 * 3 * SK_BN * 4 + 1024;
};

// One block an item (strip, chunk) = blockIdx.x: rows [128 strip, +128) of
// x, the column tiles of chunk q. ta, tb: TMA maps of the prepared x and y
// parts as 2D (2 rows, cp) arrays, boxes of 16 channels x 128 (ta) and
// SK_BN (tb) rows. part (2, split, n). 256 threads: two warpgroups of 64 rows
// each; thread 0 also issues the copies.
__global__ void __launch_bounds__(256, 1)
sinkhorn_lse_tc_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const float* __restrict__ nx, int rows_x,
                       const float* __restrict__ ny, int rows_y,
                       const float* __restrict__ logv, int n, int m, int c,
                       int cp, int dist, float lam, int split,
                       float* __restrict__ part) {
  using P = SkTc;
  extern __shared__ uint8_t sk_raw[];
  // the swizzled tiles want 512-byte aligned bases; align to 1024
  uint8_t* smem = sk_raw + ((1024 - (smem_addr(sk_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;
  float* colbuf = reinterpret_cast<float*>(empty + P::STAGES);

  const int strip = blockIdx.x / split, q = blockIdx.x % split;
  const int tiles = (m + SK_BN - 1) / SK_BN;
  int t0, t1;
  sk_chunk(q, tiles, split, t0, t1);
  const int row0 = strip * SK_BM;
  const int ksteps = cp / SK_KS;
  const int total = (t1 - t0) * ksteps;  // stages of the item

  // stage k of the item into its slot (thread 0), once the slot is free
  auto issue = [&](int k) {
    if (k >= total) return;
    const int slot = k % P::STAGES;
    mbar_wait(&empty[slot], ((k / P::STAGES) & 1) ^ 1);
    uint8_t* st = smem + slot * P::STAGE;
    mbar_expect_tx(&full[slot], P::STAGE);
    const int kc = (k % ksteps) * SK_KS, col0 = (t0 + k / ksteps) * SK_BN;
    tma_load(st, &ta, &full[slot], kc, row0);
    tma_load(st + P::A_BYTES, &ta, &full[slot], kc, rows_x + row0);
    tma_load(st + 2 * P::A_BYTES, &tb, &full[slot], kc, col0);
    tma_load(st + 2 * P::A_BYTES + P::B_BYTES, &tb, &full[slot], kc,
             rows_y + col0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < P::STAGES - 1; ++k) issue(k);
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;  // 64 rows of the strip each
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ra = row0 + cw * 64 + warp * 16 + lane / 4, rb = ra + 8;
  const float xs_a = nx[ra], rx_a = nx[rows_x + ra];
  const float xs_b = nx[rb], rx_b = nx[rows_x + rb];
  const float inv_c = 1.0f / (float)c;
  float mx_a = NEG_BIG, sm_a = 0.f, mx_b = NEG_BIG, sm_b = 0.f;
  float acc[SK_BN / 2];
  float tot[SK_BN / 2];
  const uint32_t base = smem_addr(smem);
  int g = 0;  // the item's stage
  for (int t = t0; t < t1; ++t) {
    // this tile's column data, read by the epilogue after the products;
    // columns past the prepared rows (SK_BN need not divide them) read 0
    float* cb = colbuf + (t & 1) * 3 * SK_BN;
    if (threadIdx.x < SK_BN) {
      const int col = t * SK_BN + threadIdx.x;
      const bool ok = col < rows_y;
      cb[threadIdx.x] = ok ? ny[col] : 0.f;
      cb[SK_BN + threadIdx.x] = ok ? ny[rows_y + col] : 0.f;
      cb[2 * SK_BN + threadIdx.x] = col < m ? logv[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SK_BN / 2; ++i) tot[i] = 0.f;
    // periods of stages summed on the tensor cores; no branch around an
    // access of the accumulators, which would serialize the wgmma
    for (int p0 = 0; p0 < ksteps; p0 += SK_PERIOD) {
      const int p1 = min(p0 + SK_PERIOD, ksteps);
      int held = -1;  // the slot the wgmma group in flight reads
      for (int ks = p0; ks < p1; ++ks, ++g) {
        const int slot = g % P::STAGES;
        mbar_wait(&full[slot], (g / P::STAGES) & 1);
        const uint32_t st = base + slot * P::STAGE;
        const uint32_t a_big = st + cw * 64 * SK_KS * 4;
        const uint32_t a_small = a_big + P::A_BYTES;
        const uint32_t b_big = st + 2 * P::A_BYTES;
        const uint32_t b_small = b_big + P::B_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < SK_KS / 8; ++kk) {
          const uint32_t o = 32 * kk;
          wgmma_tf32(acc, desc_sw64(a_big + o), desc_sw64(b_small + o),
                     ks != p0 || kk != 0);
          wgmma_tf32(acc, desc_sw64(a_small + o), desc_sw64(b_big + o), 1);
          wgmma_tf32(acc, desc_sw64(a_big + o), desc_sw64(b_big + o), 1);
        }
        wg_commit();
        wg_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = slot;
        // the stage P::STAGES - 1 ahead, into the slot of stage g - 1
        if (threadIdx.x == 0) issue(g + P::STAGES - 1);
      }
      wg_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[held]);
      // the period's sums into f32 registers
#pragma unroll
      for (int i = 0; i < SK_BN / 2; ++i) tot[i] += acc[i];
    }
    __syncthreads();  // cb is written
    sk_tile_epilogue(tot, t * SK_BN, m, cb, xs_a, rx_a, xs_b, rx_b, dist,
                     lam, inv_c, mx_a, sm_a, mx_b, sm_b);
  }
  // the lane quad of a row: t ^ 1, then t ^ 2
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float oma = __shfl_xor_sync(0xffffffffu, mx_a, off);
    const float osa = __shfl_xor_sync(0xffffffffu, sm_a, off);
    const float omb = __shfl_xor_sync(0xffffffffu, mx_b, off);
    const float osb = __shfl_xor_sync(0xffffffffu, sm_b, off);
    sk_merge(mx_a, sm_a, oma, osa);
    sk_merge(mx_b, sm_b, omb, osb);
  }
  if (lane % 4 == 0) {
    if (ra < n) {
      part[(size_t)q * n + ra] = mx_a;
      part[((size_t)split + q) * n + ra] = sm_a;
    }
    if (rb < n) {
      part[(size_t)q * n + rb] = mx_b;
      part[((size_t)split + q) * n + rb] = sm_b;
    }
  }
}

// ---- CUDA-core route -----------------------------------------------------

// One block an item (strip of 1024 rows, chunk) = blockIdx.x; thread i
// keeps rows 1024 strip + i + 256 r, r < 4. px (rows_x, 4 KC4), py
// (rows_y, 4 KC4): the prepared f32 rows.
template <int KC4>
__global__ void __launch_bounds__(SK_CC_TILE)
sinkhorn_lse_cc_kernel(const float* __restrict__ px,
                       const float* __restrict__ nx, int rows_x,
                       const float* __restrict__ py,
                       const float* __restrict__ ny, int rows_y,
                       const float* __restrict__ logv, int n, int m, int c,
                       int dist, float lam, int split,
                       float* __restrict__ part) {
  __shared__ float4 yv[KC4][SK_CC_TILE];
  __shared__ float yn[3][SK_CC_TILE];  // |y|^2, its rsqrt, logv

  const int tid = threadIdx.x;
  const int strip = blockIdx.x / split, q = blockIdx.x % split;
  const int tiles = (m + SK_CC_TILE - 1) / SK_CC_TILE;
  int t0, t1;
  sk_chunk(q, tiles, split, t0, t1);
  const float4* px4 = reinterpret_cast<const float4*>(px);
  const float4* py4 = reinterpret_cast<const float4*>(py);

  float4 xv[SK_CC_ROWS][KC4];
  float xs[SK_CC_ROWS], rx[SK_CC_ROWS], mx[SK_CC_ROWS], sm[SK_CC_ROWS];
#pragma unroll
  for (int i = 0; i < SK_CC_ROWS; ++i) {
    const int r = strip * SK_CC_ROWS * SK_CC_TILE + tid + SK_CC_TILE * i;
    const bool ok = r < rows_x;
#pragma unroll
    for (int k = 0; k < KC4; ++k)
      xv[i][k] = ok ? px4[(size_t)r * KC4 + k] : make_float4(0, 0, 0, 0);
    xs[i] = ok ? nx[r] : 0.f;
    rx[i] = ok ? nx[rows_x + r] : 0.f;
    mx[i] = NEG_BIG;
    sm[i] = 0.f;
  }
  const float inv_c = 1.0f / (float)c;

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * SK_CC_TILE;
    __syncthreads();  // the tile before is read
    const int j = col0 + tid;
    const bool ok = j < rows_y;
#pragma unroll
    for (int k = 0; k < KC4; ++k)
      yv[k][tid] = ok ? py4[(size_t)j * KC4 + k] : make_float4(0, 0, 0, 0);
    yn[0][tid] = ok ? ny[j] : 0.f;
    yn[1][tid] = ok ? ny[rows_y + j] : 0.f;
    yn[2][tid] = j < m ? logv[j] : 0.f;
    __syncthreads();
    const int cols = min(SK_CC_TILE, m - col0);
    float loc[SK_CC_ROWS];
#pragma unroll
    for (int i = 0; i < SK_CC_ROWS; ++i) loc[i] = 0.f;
#pragma unroll 2
    for (int jj = 0; jj < cols; ++jj) {
      float4 y4[KC4];
#pragma unroll
      for (int k = 0; k < KC4; ++k) y4[k] = yv[k][jj];
      const float ys = yn[0][jj], ry = yn[1][jj], lv = yn[2][jj];
#pragma unroll
      for (int i = 0; i < SK_CC_ROWS; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < KC4; ++k) {
          dot = fmaf(xv[i][k].x, y4[k].x, dot);
          dot = fmaf(xv[i][k].y, y4[k].y, dot);
          dot = fmaf(xv[i][k].z, y4[k].z, dot);
          dot = fmaf(xv[i][k].w, y4[k].w, dot);
        }
        const float z = -lam * sk_dist(dot, xs[i], rx[i], ys, ry, dist,
                                       inv_c) + lv;
        if (z > mx[i]) {
          // a new running max: rescale what was summed (exp of -3.4e38 -
          // z is 0 at the first column)
          const float sc = expf(mx[i] - z);
          sm[i] *= sc;
          loc[i] *= sc;
          mx[i] = z;
        }
        loc[i] += expf(z - mx[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < SK_CC_ROWS; ++i) sm[i] += loc[i];
  }
#pragma unroll
  for (int i = 0; i < SK_CC_ROWS; ++i) {
    const int r = strip * SK_CC_ROWS * SK_CC_TILE + tid + SK_CC_TILE * i;
    if (r < n) {
      part[(size_t)q * n + r] = mx[i];
      part[((size_t)split + q) * n + r] = sm[i];
    }
  }
}

// ---- C entries -------------------------------------------------------------

// A TMA map of prepared parts (2 rows, cp) f32: boxes of 16 channels x
// box_rows rows, 64-byte swizzle.
static cudaError_t sk_map(CUtensorMap* map, const float* parts, int rows,
                          int cp, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cp, (cuuint64_t)2 * rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cp * 4};
  const cuuint32_t box[2] = {SK_KS, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<float*>(parts), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

static bool sk_ready[MAX_DEVICES];
static int sk_setups = 0;

static cudaError_t sk_launch_tc(const float* px, const float* nx, int rows_x,
                                const float* py, const float* ny, int rows_y,
                                const float* logv, int n, int m, int c,
                                int cp, int dist, float lam, int split,
                                float* part, cudaStream_t stream) {
  cudaError_t err = smem_limit_once(sinkhorn_lse_tc_kernel, SkTc::SMEM,
                                    sk_ready, &sk_setups);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  err = sk_map(&ta, px, rows_x, cp, SK_BM);
  if (err == cudaSuccess) err = sk_map(&tb, py, rows_y, cp, SK_BN);
  if (err != cudaSuccess) return err;
  const int blocks = (n + SK_BM - 1) / SK_BM * split;
  sinkhorn_lse_tc_kernel<<<blocks, 256, SkTc::SMEM, stream>>>(
      ta, tb, nx, rows_x, ny, rows_y, logv, n, m, c, cp, dist, lam, split,
      part);
  return cudaGetLastError();
}

extern "C" int sinkhorn_tc_min_c() { return SK_TC_MIN_C; }

// The channels of a prepared row of c channels.
extern "C" int sinkhorn_prep_channels(int c) { return sk_cpad(c); }

// Times the C entry set the tensor-core kernel's shared-memory limit.
extern "C" int sinkhorn_setups() { return sk_setups; }

// Prepares x (n, c) into px, nx and y (m, c) into py, ny (rows_x, rows_y
// multiples of SK_ROW_PAD, at least n and m), one launch.
extern "C" int sinkhorn_prep(const float* x, int n, const float* y, int m,
                             int c, float* px, float* nx, int rows_x,
                             float* py, float* ny, int rows_y,
                             cudaStream_t stream) {
  if (rows_x % SK_ROW_PAD || rows_y % SK_ROW_PAD || rows_x < n ||
      rows_y < m)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows_x + rows_y) / 8;
  sinkhorn_prep_kernel<<<blocks, 256, 0, stream>>>(
      x, n, y, m, c, sk_cpad(c), c >= SK_TC_MIN_C, px, nx, rows_x, py, ny,
      rows_y);
  return (int)cudaGetLastError();
}

// out (n,) = LSE over the m columns, from prepared operands. split: the
// chunks of each strip's column tiles (1..tiles). part: (2, split, n)
// floats of scratch. Returns cudaGetLastError() after the launches.
extern "C" int sinkhorn_lse(const float* px, const float* nx, int rows_x,
                            const float* py, const float* ny, int rows_y,
                            const float* logv, int n, int m, int c, int dist,
                            float lam, int split, float* part, float* out,
                            cudaStream_t stream) {
  const int cp = sk_cpad(c);
  const bool tc = c >= SK_TC_MIN_C;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int bn = tc ? SK_BN : SK_CC_TILE;
  const int tiles = (m + bn - 1) / bn;
  if (split < 1 || split > tiles) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (tc) {
    err = sk_launch_tc(px, nx, rows_x, py, ny, rows_y, logv, n, m, c, cp,
                       dist, lam, split, part, stream);
  } else {
    const int rows_b = SK_CC_ROWS * SK_CC_TILE;
    const int blocks = (n + rows_b - 1) / rows_b * split;
    switch (cp / 4) {
#define SK_CC_CASE(K)                                                      \
  case K:                                                                  \
    sinkhorn_lse_cc_kernel<K><<<blocks, SK_CC_TILE, 0, stream>>>(          \
        px, nx, rows_x, py, ny, rows_y, logv, n, m, c, dist, lam, split,   \
        part);                                                             \
    break;
      SK_CC_CASE(1) SK_CC_CASE(2) SK_CC_CASE(3) SK_CC_CASE(4)
      SK_CC_CASE(5) SK_CC_CASE(6) SK_CC_CASE(7) SK_CC_CASE(8)
#undef SK_CC_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  sinkhorn_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, n, split,
                                                               out);
  return (int)cudaGetLastError();
}
