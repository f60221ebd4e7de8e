// Kernel set K6: the moment term of the style loss and its gradient,
//   L = sum_ab |P_ab - T_ab| / C^2 + sum_a |p_a - m_a| / C,
// P = (y - p)^T (y - p) / n the biased covariance and p the mean of the
// prediction's rows y (n, C), against the style target's mean m (C) and
// covariance T (C, C); and, with no target, a matrix's own (mean, cov).
//
// Replaces no Pallas kernel: the JAX package leaves the moments to XLA
// (strotss_tpu/ops/losses.py `moment_matching`). On the card the plain
// route (ops/kernels/moments.py) runs three float32 GEMMs on the CUDA
// cores, the covariance and autograd's two products for its backward, and
// about seven passes over C x C float32 matrices around them.
//
// Bound (H100 SXM: 495 TFLOP/s TF32 dense, 3.35 TB/s) at n = 1024, C =
// 2179. The mathematics needs n C^2 products of the symmetric covariance
// (its upper triangle) and 2 n C^2 of the gradient: 14.6 GFLOP, where
// the plain route does 29.2. (`moments_roofline_pct`, the benchmark's
// share for K6, counts 4 n C^2, 19.5 GFLOP, on purpose: the full products
// the loss defines, as `mfu_pct` counts the moments whatever computes
// them, priced at the bf16 peak.) In 3xTF32 (tc.cuh) the covariance takes three
// TF32 products a product and the gradient two (its sign operand is exact
// in TF32), 34.0 GFLOP of TF32 work: 0.069 ms. It reads the rows (8.9 MB)
// and the target (19 MB), writes the gradient (8.9 MB) and passes ~60 MB
// of prepared operands through device memory: ~0.03 ms. So it is bound by
// operations, and its design spends them where the mathematics does:
//
// 1. Preparation (`moments_prep_kernel`, one launch; a block of 32
//    channels): each column's mean, summed in a fixed order; the centred
//    values split into TF32 big and small parts (tc.cuh `tf32_split`) and
//    written channel-major, (2, cp, np), for the covariance, whose
//    products reduce over the rows (`wgmma` takes TF32 operands K-major
//    only); for the loss's backward also row-major, (2, np + 8, kq), with
//    the column sums of the centred rows as row np; for the loss the
//    mean's term: sign(p - m) and each block's sum of |p - m|.
// 2. Covariance (`moments_cov_kernel<STATS>`): the 128 x 192 output tiles
//    (I, J) that hold an entry on or above the diagonal, each by 3xTF32
//    `wgmma` (m64n192k8, both operands from TMA-fed shared memory, the ring
//    and pipeline of sinkhorn.cu's K4), every 128 rows' sums added into
//    f32 registers. In
//    the epilogue, for each (a, b) with a <= b: P_ab = sum / n; STATS writes
//    it to both (a, b) and (b, a), so the covariance is exactly symmetric;
//    the loss takes d1 = P_ab - T_ab and d2 = P_ab - T_ba, adds |d1| + |d2|
//    (|d1| on the diagonal) to the tile's partial sum and writes H_ab = H_ba
//    = sign(d1) + sign(d2) as int8. That is the plain loss exactly, and H =
//    S + S^T for S = sign(P - T), whatever symmetry T has; no C x C float32
//    matrix reaches device memory.
// 3. `moments_finish_kernel`: the partial sums in a fixed order, the loss.
// 4. Backward (`moments_bwd_kernel`, one launch):
//      dy = g ((y - p) H - (1/n) 1 (colsum H)) / (n C^2) + g sign(p - m) / (n C)
//    from dL/dP = S / C^2, the symmetric product's (S + S^T) and the
//    centring's mean term, which is zero in exact arithmetic and is kept
//    as the plain route computes it. It is computed transposed, (H (y -
//    p)^T)^T, so that H is wgmma's A operand: loaded by TMA as int8 and
//    widened into registers, exact in TF32; the rows' big and small parts
//    are B, 128 samples and the column sums' 8-row group (m64n136k8), two
//    TF32 products a k-step. The scalar is folded in the epilogue.
//
// No atomics: every sum has a fixed order, so results are the same bit for
// bit in every call. Launches go on the caller's stream with no host sync
// and write only buffers the wrapper allocates, so a CUDA graph captures
// them. Inputs of any n >= 1 and C >= 1: rows and channels past the input
// are zero in the prepared operands and masked in every epilogue.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"
#include "wgmma.cuh"

#define MO_T 128          // covariance: rows (channels a) of an output tile
#define MO_TN 192         // covariance: columns (channels b) of an output tile
#define MO_KS 16          // a stage: samples (covariance), channels (backward)
#define MO_PERIOD 8       // stages summed on the tensor cores, then in f32
#define MO_COV_STAGES 5   // covariance: the ring's stages
#define MO_BM 192         // backward: channels a block (three warpgroups)
#define MO_CPAD 384       // channels padded to a multiple of MO_T, MO_TN, MO_BM
#define MO_BN 128         // backward: samples a block; rows padded to it
#define MO_CS 8           // backward: the column sums' row group
#define MO_BWD_STAGES 8   // backward: the ring's stages
#define MO_PREP_COLS 32   // preparation: channels a block

static __host__ __device__ int mo_round(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float mo_sign(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// ---- preparation -----------------------------------------------------------

// One block of 32 x 32 threads a chunk of 32 channels (tx the channel, ty a
// lane of rows); cp / 32 blocks. ct (2, cp, np): the centred values' big,
// then small parts, channel-major. rm (2, np + MO_CS, kq), or null: the
// same row-major, row np the column sums' parts, rows past n and np zero.
// mean (c). With tmean: msign (c) = sign(mean - tmean), part[block] = the
// chunk's sum of |mean - tmean|.
__global__ void __launch_bounds__(1024)
moments_prep_kernel(const float* __restrict__ x, int n, int c, int np,
                    int cp, int kq, const float* __restrict__ tmean,
                    float* __restrict__ ct, float* __restrict__ rm,
                    float* __restrict__ mean, float* __restrict__ msign,
                    float* __restrict__ part) {
  __shared__ float red[32][33];
  __shared__ float tb[32][33], ts[32][33];
  __shared__ float cm[32];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = blockIdx.x * MO_PREP_COLS + tx;
  const bool in = col < c;
  // the column's sum: rows ty + 32 r in order, then the 32 lanes in order
  float s = 0.f;
  if (in)
    for (int i = ty; i < n; i += 32) s += x[(size_t)i * c + col];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int r = 0; r < 32; ++r) t += red[r][tx];
    const float m = in ? t / (float)n : 0.f;
    cm[tx] = m;
    if (in) mean[col] = m;
    if (tmean) {
      const float d = in ? m - tmean[col] : 0.f;
      if (in) msign[col] = mo_sign(d);
      float a = fabsf(d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (tx == 0) part[blockIdx.x] = a;
    }
  }
  __syncthreads();
  const float m = cm[tx];
  const size_t rm_half = (size_t)(np + MO_CS) * kq;
  const bool rm_col = rm != nullptr && col < kq;
  float* ct_small = ct + (size_t)cp * np;
  // the centred value of (row r0 + ty, channel col), then its parts at
  // (channel 32 blockIdx.x + ty, row r0 + tx) through shared memory
  float cs = 0.f;
  for (int r0 = 0; r0 < np; r0 += 32) {
    const int i = r0 + ty;
    const float v = (in && i < n) ? x[(size_t)i * c + col] - m : 0.f;
    cs += v;
    uint32_t big, small;
    tf32_split(v, big, small);
    if (rm_col) {
      rm[(size_t)i * kq + col] = __uint_as_float(big);
      rm[rm_half + (size_t)i * kq + col] = __uint_as_float(small);
    }
    tb[ty][tx] = __uint_as_float(big);
    ts[ty][tx] = __uint_as_float(small);
    __syncthreads();
    // channel blockIdx.x * 32 + ty, samples r0 + tx: 128-byte rows
    const size_t o = (size_t)(blockIdx.x * MO_PREP_COLS + ty) * np + r0 + tx;
    ct[o] = tb[tx][ty];
    ct_small[o] = ts[tx][ty];
    __syncthreads();
  }
  if (rm == nullptr) return;
  // the column sum of the centred values: the lanes' sums in order
  red[ty][tx] = cs;
  __syncthreads();
  if (!rm_col) return;
  if (ty == 0) {
    float t = 0.f;
    for (int r = 0; r < 32; ++r) t += red[r][tx];
    uint32_t big, small;
    tf32_split(t, big, small);
    rm[(size_t)np * kq + col] = __uint_as_float(big);
    rm[rm_half + (size_t)np * kq + col] = __uint_as_float(small);
  } else if (ty < MO_CS) {
    rm[(size_t)(np + ty) * kq + col] = 0.f;
    rm[rm_half + (size_t)(np + ty) * kq + col] = 0.f;
  }
}

// ---- covariance --------------------------------------------------------------

WGMMA_TF32_SS(96, "192", WG_R96, WG_F96, "96", "97", "98")

// Shared-memory plan: a stage holds 16 samples of the big, then the small
// parts of tile I's 128 channel rows, then of tile J's 192.
struct MoCov {
  static constexpr int PART_A = MO_T * MO_KS * 4;
  static constexpr int PART_B = MO_TN * MO_KS * 4;
  static constexpr int STAGE = 2 * (PART_A + PART_B);
  // stages, full and empty barriers, the warps' sums, alignment
  static constexpr int SMEM =
      MO_COV_STAGES * STAGE + 2 * MO_COV_STAGES * 8 + 8 * 4 + 1024;
};

// The first column tile that row tile I needs: the one that holds column
// 128 I, its first diagonal entry.
__host__ __device__ __forceinline__ int mo_jmin(int ti) {
  return ti * MO_T / MO_TN;
}

// The tiles of c channels: row tiles I of 128 rows, column tiles J of 192
// columns, those with an entry (a, b), a <= b, inside c x c: J from
// mo_jmin(I) on.
__host__ __device__ __forceinline__ int mo_tiles(int c) {
  const int tr = (c + MO_T - 1) / MO_T, tc = (c + MO_TN - 1) / MO_TN;
  int t = 0;
  for (int i = 0; i < tr; ++i) t += tc - mo_jmin(i);
  return t;
}

// Tile b of them, row by row (ops/kernels/moments.py `tile_of`).
__device__ __forceinline__ void mo_tile(int b, int c, int& ti, int& tj) {
  const int tc = (c + MO_TN - 1) / MO_TN;
  ti = 0;
  while (b >= tc - mo_jmin(ti)) {
    b -= tc - mo_jmin(ti);
    ++ti;
  }
  tj = mo_jmin(ti) + b;
}

// One block a tile (I, J) = blockIdx.x: rows 128 I.., columns 192 J.. of
// the upper triangle (2179 channels: 120 tiles, one wave on 132 SMs;
// square 128 x 128 tiles took 171 blocks, two waves, and 0.150 ms a loss
// on an H100 80GB HBM3, against 0.102 ms).
// ta, tb: TMA maps of ct as a 2D (2 cp, np) array, boxes of 16 samples x
// 128 and x 192 rows. 256 threads: two warpgroups of 64 rows of tile I
// each; thread 0 also issues the copies. STATS: cov (c, c); else target (c,
// c), h (cp, kq) or null, part[blockIdx.x].
template <bool STATS>
__global__ void __launch_bounds__(256, 1)
moments_cov_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, int n, int c,
                   int np, int cp, const float* __restrict__ target,
                   float* __restrict__ cov, int8_t* __restrict__ h, int kq,
                   float* __restrict__ part) {
  using P = MoCov;
  extern __shared__ uint8_t mo_raw[];
  // the swizzled tiles want 512-byte aligned bases; align to 1024
  uint8_t* smem = mo_raw + ((1024 - (smem_addr(mo_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + MO_COV_STAGES * P::STAGE);
  uint64_t* empty = full + MO_COV_STAGES;
  float* wsum = reinterpret_cast<float*>(empty + MO_COV_STAGES);

  int ti, tj;
  mo_tile(blockIdx.x, c, ti, tj);
  const int ksteps = np / MO_KS;

  // stage k into its slot (thread 0), once the slot is free
  auto issue = [&](int k) {
    if (k >= ksteps) return;
    const int slot = k % MO_COV_STAGES;
    mbar_wait(&empty[slot], ((k / MO_COV_STAGES) & 1) ^ 1);
    uint8_t* st = smem + slot * P::STAGE;
    mbar_expect_tx(&full[slot], P::STAGE);
    const int s0 = k * MO_KS;
    tma_load(st, &ta, &full[slot], s0, ti * MO_T);
    tma_load(st + P::PART_A, &ta, &full[slot], s0, cp + ti * MO_T);
    tma_load(st + 2 * P::PART_A, &tb, &full[slot], s0, tj * MO_TN);
    tma_load(st + 2 * P::PART_A + P::PART_B, &tb, &full[slot], s0,
             cp + tj * MO_TN);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < MO_COV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < MO_COV_STAGES - 1; ++k) issue(k);
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;  // 64 rows of tile I each
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[MO_TN / 2];
  float tot[MO_TN / 2];
#pragma unroll
  for (int i = 0; i < MO_TN / 2; ++i) tot[i] = 0.f;
  const uint32_t base = smem_addr(smem);
  // periods of stages summed on the tensor cores; no branch around an
  // access of the accumulators, which would serialize the wgmma
  for (int p0 = 0; p0 < ksteps; p0 += MO_PERIOD) {
    const int p1 = min(p0 + MO_PERIOD, ksteps);
    int held = -1;  // the slot the wgmma group in flight reads
    for (int ks = p0; ks < p1; ++ks) {
      const int slot = ks % MO_COV_STAGES;
      mbar_wait(&full[slot], (ks / MO_COV_STAGES) & 1);
      const uint32_t st = base + slot * P::STAGE;
      const uint32_t a_big = st + cw * 64 * MO_KS * 4;
      const uint32_t a_small = a_big + P::PART_A;
      const uint32_t b_big = st + 2 * P::PART_A;
      const uint32_t b_small = b_big + P::PART_B;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < MO_KS / 8; ++kk) {
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
      // the stage MO_COV_STAGES - 1 ahead, into the slot of stage ks - 1
      if (threadIdx.x == 0) issue(ks + MO_COV_STAGES - 1);
    }
    wg_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);
    // the period's sums into f32 registers
#pragma unroll
    for (int i = 0; i < MO_TN / 2; ++i) tot[i] += acc[i];
  }

  // epilogue: tot[4 j + 2 hh + e] is (row g + 8 hh, column 8 j + 2 t + e)
  // of the warp's 16 rows (lane 4 g + t)
  const int a_row = ti * MO_T + cw * 64 + warp * 16 + lane / 4;
  const int b_col = tj * MO_TN + 2 * (lane % 4);
  const float fn = (float)n;
  float sum = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = a_row + 8 * hh;
#pragma unroll
    for (int j = 0; j < MO_TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = b_col + 8 * j + e;
        if (a >= c || b >= c || b < a) continue;
        const float v = tot[4 * j + 2 * hh + e] / fn;
        if (STATS) {
          cov[(size_t)a * c + b] = v;
          cov[(size_t)b * c + a] = v;
        } else {
          const float d1 = v - target[(size_t)a * c + b];
          const float d2 = v - target[(size_t)b * c + a];
          sum += a == b ? fabsf(d1) : fabsf(d1) + fabsf(d2);
          if (h) {
            const int8_t s = (int8_t)(mo_sign(d1) + mo_sign(d2));
            h[(size_t)a * kq + b] = s;
            h[(size_t)b * kq + a] = s;
          }
        }
      }
  }
  if (!STATS) {
    // the tile's sum: a butterfly in each warp, then the 8 warps in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) wsum[threadIdx.x / 32] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += wsum[w];
      part[blockIdx.x] = t;
    }
  }
}

// loss = (sum of the tiles' partials) / cc + (sum of the preparation's) / cf,
// each summed in a fixed order; part: nprep, then ntiles partials.
__global__ void __launch_bounds__(256)
moments_finish_kernel(const float* __restrict__ part, int nprep, int ntiles,
                      float cc, float cf, float* __restrict__ loss) {
  __shared__ float sd[256], sm[256];
  const int t = threadIdx.x;
  float d = 0.f, m = 0.f;
  for (int i = t; i < ntiles; i += 256) d += part[nprep + i];
  for (int i = t; i < nprep; i += 256) m += part[i];
  sd[t] = d;
  sm[t] = m;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (t < s) {
      sd[t] += sd[t + s];
      sm[t] += sm[t + s];
    }
    __syncthreads();
  }
  if (t == 0) *loss = sd[0] / cc + sm[0] / cf;
}

// ---- backward ----------------------------------------------------------------

WGMMA_TF32_RS(68, "136", WG_R68, WG_F68, "%68, %69, %70, %71", "72", "73")

// Shared-memory plan: a stage holds 16 channels of H's 192 rows (int8),
// then of the big and of the small parts of the 128 samples' rows and the
// column sums' 8-row group.
struct MoBwd {
  static constexpr int H_BYTES = MO_BM * MO_KS;
  static constexpr int ROWS = MO_BN + MO_CS;
  static constexpr int PART = ROWS * MO_KS * 4;
  static constexpr int STAGE = H_BYTES + 2 * PART;
  static constexpr int SMEM = MO_BWD_STAGES * STAGE + 2 * MO_BWD_STAGES * 8 +
                              1024;
};

// One block (channels a0 = 192 blockIdx.x, samples i0 = 128 blockIdx.y);
// th: TMA map of h (cp, kq) int8, boxes of 16 channels x 192 rows; trm,
// tcs: of rm as a 2D (2 (np + MO_CS), kq) array, boxes of 16 channels x 128
// and x MO_CS rows. 384 threads, three warpgroups of 64 channels each that
// share each stage's rows: each byte of the rows' parts read from L2 serves
// 192 channels (the parts, 8 bytes a value, are read ceil(C / 192) times in
// all; 64-channel blocks read them 3 times as often, ~0.65 GB at 1024 x
// 2179, and took 0.21 ms on an H100 80GB HBM3, against 0.115 ms). Thread 0
// also issues the copies.
// dx (n, c) = g (scale ((H cx^T)^T - colsum H / n) + mscale msign).
__global__ void __launch_bounds__(384, 1)
moments_bwd_kernel(const __grid_constant__ CUtensorMap th,
                   const __grid_constant__ CUtensorMap trm,
                   const __grid_constant__ CUtensorMap tcs,
                   const float* __restrict__ msign,
                   const float* __restrict__ gup, int n, int c, int np,
                   int kq, float scale, float mscale,
                   float* __restrict__ dx) {
  using P = MoBwd;
  extern __shared__ uint8_t mo_raw[];
  uint8_t* smem = mo_raw + ((1024 - (smem_addr(mo_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + MO_BWD_STAGES * P::STAGE);
  uint64_t* empty = full + MO_BWD_STAGES;

  const int a0 = blockIdx.x * MO_BM, i0 = blockIdx.y * MO_BN;
  const int ksteps = kq / MO_KS;

  auto issue = [&](int k) {
    if (k >= ksteps) return;
    const int slot = k % MO_BWD_STAGES;
    mbar_wait(&empty[slot], ((k / MO_BWD_STAGES) & 1) ^ 1);
    uint8_t* st = smem + slot * P::STAGE;
    mbar_expect_tx(&full[slot], P::STAGE);
    const int b0 = k * MO_KS;
    uint8_t* big = st + P::H_BYTES;
    uint8_t* small = big + P::PART;
    tma_load(st, &th, &full[slot], b0, a0);
    tma_load(big, &trm, &full[slot], b0, i0);
    tma_load(big + MO_BN * MO_KS * 4, &tcs, &full[slot], b0, np);
    tma_load(small, &trm, &full[slot], b0, np + MO_CS + i0);
    tma_load(small + MO_BN * MO_KS * 4, &tcs, &full[slot], b0,
             2 * np + MO_CS);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < MO_BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < MO_BWD_STAGES - 1; ++k) issue(k);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  float acc[P::ROWS / 2];
  float tot[P::ROWS / 2];
#pragma unroll
  for (int i = 0; i < P::ROWS / 2; ++i) tot[i] = 0.f;
  const uint32_t base = smem_addr(smem);
  for (int p0 = 0; p0 < ksteps; p0 += MO_PERIOD) {
    const int p1 = min(p0 + MO_PERIOD, ksteps);
    for (int ks = p0; ks < p1; ++ks) {
      const int slot = ks % MO_BWD_STAGES;
      mbar_wait(&full[slot], (ks / MO_BWD_STAGES) & 1);
      // the warp's A fragments of H (mma.sync's m16n8k8 layout), widened
      // from int8: a[i] is row 16 warp + g + 8 (i & 1), channel 8 kk + t +
      // 4 (i >> 1) of the stage (warp 4 w + i of warpgroup w)
      const int8_t* hs =
          reinterpret_cast<const int8_t*>(smem + slot * P::STAGE);
      uint32_t fa[MO_KS / 8][4];
#pragma unroll
      for (int kk = 0; kk < MO_KS / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fa[kk][i] = __float_as_uint((float)hs[
              (warp * 16 + g8 + 8 * (i & 1)) * MO_KS + 8 * kk + t4 +
              4 * (i >> 1)]);
      const uint32_t b_big = base + slot * P::STAGE + P::H_BYTES;
      const uint32_t b_small = b_big + P::PART;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < MO_KS / 8; ++kk) {
        wgmma_tf32_rs(acc, fa[kk], desc_sw64(b_big + 32 * kk),
                      ks != p0 || kk != 0);
        wgmma_tf32_rs(acc, fa[kk], desc_sw64(b_small + 32 * kk), 1);
      }
      wg_commit();
      // the next stage's fragments overwrite these registers: the group
      // completes first
      wg_wait<0>();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (threadIdx.x == 0) issue(ks + MO_BWD_STAGES - 1);
    }
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < P::ROWS / 2; ++i) tot[i] += acc[i];
  }

  // epilogue: tot[4 j + 2 hh + e] is (channel a0 + 16 warp + g + 8 hh,
  // sample i0 + 8 j + 2 t + e); n8 block MO_BN / 8, column 0 (lanes with
  // t = 0) holds (colsum H)_a
  const float v0 = __shfl_sync(0xffffffffu, tot[4 * (MO_BN / 8)], lane & ~3);
  const float v8 =
      __shfl_sync(0xffffffffu, tot[4 * (MO_BN / 8) + 2], lane & ~3);
  const float gs = *gup;
  const float fn = (float)n;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int a = a0 + warp * 16 + g8 + 8 * hh;
    if (a >= c) continue;
    const float vn = (hh ? v8 : v0) / fn;
    const float ms = mscale * msign[a];
#pragma unroll
    for (int j = 0; j < MO_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + 8 * j + 2 * t4 + e;
        if (i < n)
          dx[(size_t)i * c + a] =
              gs * (scale * (tot[4 * j + 2 * hh + e] - vn) + ms);
      }
  }
}

// ---- C entries -----------------------------------------------------------------

// A 2D TMA map of `rows` rows of `inner` elements, `pitch` bytes apart:
// boxes of box_inner x box_rows.
static cudaError_t mo_map(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, int inner, int rows, int pitch,
                          int box_inner, int box_rows,
                          CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

static bool mo_cov_ready[2][MAX_DEVICES], mo_bwd_ready[MAX_DEVICES];
static int mo_setups = 0;

// Times a C entry set a kernel's shared-memory limit on a device.
extern "C" int moments_setups() { return mo_setups; }

// x (n, c) row-major. With target (c, c) and tmean (c): the loss into
// *loss (three launches), the backward's operands into rm and h where they
// are not null; without: mean (c) and cov (c, c) (two launches). Buffers,
// with np = n rounded up to 128, cp = c to 384 and kq = c to 16: ct 2 cp
// np floats; rm 2 (np + 8) kq floats; msign c floats; part cp / 32 +
// mo_tiles(c) floats; h cp kq bytes.
extern "C" int moments_fwd(const float* x, int n, int c, const float* tmean,
                           const float* target, float* ct, float* rm,
                           float* mean, float* msign, float* part,
                           float* cov, int8_t* h, float* loss,
                           cudaStream_t stream) {
  if (n < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const bool stats = target == nullptr;
  if (stats ? cov == nullptr
            : (tmean == nullptr || part == nullptr || loss == nullptr))
    return (int)cudaErrorInvalidValue;
  const int np = mo_round(n, MO_BN), cp = mo_round(c, MO_CPAD);
  const int kq = mo_round(c, MO_KS);
  const int nprep = cp / MO_PREP_COLS, tiles = mo_tiles(c);
  cudaError_t err = bind_current_device();
  if (err != cudaSuccess) return (int)err;
  moments_prep_kernel<<<nprep, 1024, 0, stream>>>(
      x, n, c, np, cp, kq, stats ? nullptr : tmean, ct, rm, mean, msign,
      part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ta, tb;
  err = mo_map(&ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ct, np, 2 * cp, np * 4,
               MO_KS, MO_T, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = mo_map(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ct, np, 2 * cp,
                 np * 4, MO_KS, MO_TN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  if (stats) {
    err = smem_limit_once(moments_cov_kernel<true>, MoCov::SMEM,
                          mo_cov_ready[1], &mo_setups);
    if (err != cudaSuccess) return (int)err;
    moments_cov_kernel<true><<<tiles, 256, MoCov::SMEM, stream>>>(
        ta, tb, n, c, np, cp, nullptr, cov, nullptr, kq, nullptr);
    return (int)cudaGetLastError();
  }
  err = smem_limit_once(moments_cov_kernel<false>, MoCov::SMEM,
                        mo_cov_ready[0], &mo_setups);
  if (err != cudaSuccess) return (int)err;
  moments_cov_kernel<false><<<tiles, 256, MoCov::SMEM, stream>>>(
      ta, tb, n, c, np, cp, target, nullptr, h, kq, part + nprep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_finish_kernel<<<1, 256, 0, stream>>>(
      part, nprep, tiles, (float)((double)c * c), (float)c, loss);
  return (int)cudaGetLastError();
}

// dx (n, c) from moments_fwd's h and rm for the loss of rows (n, c), its
// msign, and the upstream gradient g (one float on the card); one launch.
extern "C" int moments_bwd(const int8_t* h, const float* rm,
                           const float* msign, const float* g, int n, int c,
                           float* dx, cudaStream_t stream) {
  if (n < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const int np = mo_round(n, MO_BN), cp = mo_round(c, MO_CPAD);
  const int kq = mo_round(c, MO_KS);
  cudaError_t err = bind_current_device();
  if (err == cudaSuccess)
    err = smem_limit_once(moments_bwd_kernel, MoBwd::SMEM, mo_bwd_ready,
                          &mo_setups);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap th, trm, tcs;
  err = mo_map(&th, CU_TENSOR_MAP_DATA_TYPE_UINT8, h, kq, cp, kq, MO_KS,
               MO_BM, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = mo_map(&trm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rm, kq,
                 2 * (np + MO_CS), kq * 4, MO_KS, MO_BN,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = mo_map(&tcs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rm, kq,
                 2 * (np + MO_CS), kq * 4, MO_KS, MO_CS,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + MO_BM - 1) / MO_BM, np / MO_BN);
  moments_bwd_kernel<<<grid, 384, MoBwd::SMEM, stream>>>(
      th, trm, tcs, msign, g, n, c, np, kq,
      (float)(1.0 / ((double)n * c * c)), (float)(1.0 / ((double)n * c)), dx);
  return (int)cudaGetLastError();
}
