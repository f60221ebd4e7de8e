// Hypercolumn gathers (K5): the rows of a step's samples on every map of
// one or two hypercolumns in one launch, and the gradient of the sampled
// maps in two.
//
// Replaces no Pallas kernel: strotss_tpu/ops/sampling.py gathers through
// XLA (`bilinear_gather`, `nearest_gather`, `sample_hypercolumn`; its
// one-hot-matmul gate is a TPU measurement and is not ported). The port's
// plain route (strotss_torch/ops/sampling.py) issues about 36 small
// operations a bilinear map and 6 a nearest one, for each side, and autograd
// as many again in the backward, whose bf16 scatter-add sums in an order
// that changes from run to run. This file does the same work in one forward
// launch a call and two backward launches a call.
//
// Forward (`gather_fwd_kernel`). A map is an (h, w, C) view with any
// element strides (the VGG taps are NHWC views of NCHW tensors, block1's
// and the image are NHWC; a batch pair is an `unbind` view), float32 or
// bf16. Each block takes one map's 64-channel span and 16 samples; a thread
// owns one channel and walks 4 of the samples, so the row it writes is
// coalesced. The arithmetic is the plain route's, bit for bit: coordinates
// scaled as `coords * fac` in float32 (fac rounded to float32 by the
// wrapper, as torch rounds a Python scalar), corners floored and clipped
// independently as `bilinear_corners` does, weights (1-dx)(1-dy), (1-dx)dy,
// dx(1-dy), dx dy, and the blend ((t0 + t1) + t2) + t3 with t = f * w, every
// operation a rounded intrinsic (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`),
// which nvcc never contracts into an FMA. Maps at factor 1 with integer
// coordinates take the truncating nearest lookup, as in the plain route.
//
// Backward, deterministic, float32 sums rounded once to the map's type:
// - `gather_sort_kernel`, one block of 1024 threads a map: the map's keys
//   (pixel x * w + y, key index k = sample * corners + corner) in key order,
//   then a stable LSD radix sort by pixel, 8 bits a pass (3 passes at
//   384 x 512), each pass a histogram, a scan and a scatter in chunks of
//   1024 keys whose ranks come from `__match_any_sync` and per-warp counts.
//   The keys end ordered by (pixel, sample, corner) in scratch A, whatever
//   the sample count: there is no shared-memory limit on n.
// - `gather_acc_kernel`: a block owns 64 pixels (in x * w + y order) by 64
//   channels of one map; each warp takes an eighth of the pixels, finds
//   their keys with a 32-way search (one load a lane a round), walks them
//   in sorted order and sums g[sample] * weight in float32, a pixel at a
//   time (the weight recomputed from the coordinates by the forward's own
//   code); the block writes its whole tile, zeros included, through shared
//   memory in the order the gradient's layout makes coalesced. So no zero
//   fill of the gradient and no atomics: the result is the same in every
//   call.
// Both launches take a scratch whose size the shapes fix and no host
// synchronisation, so the pair can be captured in a CUDA graph.
//
// Bound on an H100 SXM (3.35 TB/s) at the 512 px scale (10 maps, 2179
// channels, n = 1024): the forward reads the 4 corner rows of 1024 samples
// in the bf16 maps of blocks 2-5, but no more of a map than the whole of it
// (blocks 4 and 5, 48 x 64 and 24 x 32 pixels, hold fewer than 4096 rows),
// and 1024 x 131 float32 values of the image and block1: 12.9 MB a side.
// It writes two 1024 x 2179 float32 row blocks (17.8 MB): 43.6 MB in all,
// 0.013 ms. The backward reads the rows' cotangent
// (8.9 MB) and writes the ten dense gradients, 151 MB (block1's two
// float32 taps 100.7 MB): 0.048 ms. Both are bound by bytes. The VGG taps'
// channel stride is h * w, so a corner's channels lie in separate sectors;
// the forward reads those sectors once each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

constexpr int MAX_MAPS = 32;  // maps a launch takes (two hypercolumns of 14)
constexpr int DESC_WORDS = 16;  // 64-bit words of a map's host descriptor
constexpr int FWD_CH = 64;      // channels of a forward block
constexpr int FWD_ROWS = 4;     // samples a forward block covers at once
constexpr int FWD_SAMPLES = 16;  // samples of a forward block
constexpr int SORT_THREADS = 1024;
constexpr int RADIX = 256;
constexpr int ACC_PIXELS = 64;  // pixels of a backward tile
constexpr int ACC_CH = 64;      // channels of a backward tile
constexpr int ACC_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

enum { F32 = 0, BF16 = 1 };

struct MapDesc {
  long long ptr;         // the map (forward) or its gradient (backward)
  long long sx, sy, sc;  // element strides of rows, columns and channels
  int h, w, c;
  float fac;    // coordinate factor, rounded to float32
  int dtype;    // F32 or BF16
  int nearest;  // 1: truncating nearest lookup, 0: bilinear
  int scaled;   // 1: coords * fac, 0: the coords as they are (fac == 1)
  int col;      // first column of the map in its rows
  int side;     // which rows: output (forward) or cotangent (backward) 0 or 1
  int row;      // floats between consecutive rows of that side
  int start;    // first block of the map in its launch
  int key_off;  // backward: first key of the map in the scratch
};

struct Table {
  MapDesc maps[MAX_MAPS];
  int nmaps;
};

namespace {

__device__ __forceinline__ int find_map(const Table& t, int block) {
  int m = 0;
  while (m + 1 < t.nmaps && block >= t.maps[m + 1].start) ++m;
  return m;
}

// torch.clamp(v, 0, hi).long() for a finite v
__device__ __forceinline__ int clip(float v, int hi) {
  return (int)fminf(fmaxf(v, 0.f), (float)hi);
}

__device__ __forceinline__ void scaled(const MapDesc& d, const float* coords,
                                       int s, float& gx, float& gy) {
  gx = coords[2 * s];
  gy = coords[2 * s + 1];
  if (d.scaled) {
    gx = __fmul_rn(gx, d.fac);
    gy = __fmul_rn(gy, d.fac);
  }
}

// `bilinear_corners`: rows x0, x1, columns y0, y1, weights in blend order
struct Corners {
  int x0, x1, y0, y1;
  float w0, w1, w2, w3;
};

__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  const float fx = floorf(gx), fy = floorf(gy);
  const float dx = __fsub_rn(gx, fx), dy = __fsub_rn(gy, fy);
  const float ox = __fsub_rn(1.f, dx), oy = __fsub_rn(1.f, dy);
  Corners r;
  r.x0 = clip(fx, h - 1);
  r.y0 = clip(fy, w - 1);
  r.x1 = clip(__fadd_rn(fx, 1.f), h - 1);
  r.y1 = clip(__fadd_rn(fy, 1.f), w - 1);
  r.w0 = __fmul_rn(ox, oy);
  r.w1 = __fmul_rn(ox, dy);
  r.w2 = __fmul_rn(dx, oy);
  r.w3 = __fmul_rn(dx, dy);
  return r;
}

// key k of map d: its pixel x * w + y and its weight (1 for a nearest map)
__device__ __forceinline__ int key_pixel(const MapDesc& d, const float* coords,
                                         int k, float* weight) {
  float gx, gy;
  if (d.nearest) {
    scaled(d, coords, k, gx, gy);
    if (weight) *weight = 1.f;
    return clip(gx, d.h - 1) * d.w + clip(gy, d.w - 1);
  }
  scaled(d, coords, k >> 2, gx, gy);
  const Corners r = corners(gx, gy, d.h, d.w);
  const int q = k & 3;
  if (weight) *weight = q == 0 ? r.w0 : q == 1 ? r.w1 : q == 2 ? r.w2 : r.w3;
  return (q < 2 ? r.x0 : r.x1) * d.w + ((q & 1) ? r.y1 : r.y0);
}

__device__ __forceinline__ float load(const MapDesc& d, int x, int y, int c) {
  const long long off = x * d.sx + y * d.sy + c * d.sc;
  if (d.dtype == BF16)
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(d.ptr)[off]);
  return reinterpret_cast<const float*>(d.ptr)[off];
}

__device__ __forceinline__ void store(const MapDesc& d, int p, int c,
                                      float v) {
  const int x = p / d.w, y = p - x * d.w;
  const long long off = x * d.sx + y * d.sy + c * d.sc;
  if (d.dtype == BF16)
    reinterpret_cast<__nv_bfloat16*>(d.ptr)[off] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(d.ptr)[off] = v;
}

__device__ __forceinline__ int sort_passes(int pixels) {
  const int bits = pixels > 1 ? 32 - __clz(pixels - 1) : 0;
  return (bits + 7) / 8;
}

// First index in [lo, hi) whose pixel is >= p, found by the 32 lanes of a
// warp together: each round probes 32 evenly spaced keys and keeps the
// stretch where the pixel reaches p, so 4096 keys take two rounds.
__device__ __forceinline__ int warp_lower_bound(const int2* keys, int lo,
                                                int hi, int p, int lane) {
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) / 32;
    const int at = lo + lane * stride;
    const unsigned ge = __ballot_sync(FULL, at >= hi || keys[at].x >= p);
    // a 33rd probe, at lo + 32 stride >= hi, would read as >= p
    const int f = ge ? __ffs(ge) - 1 : 32;
    if (f == 0) return lo;
    hi = min(lo + f * stride, hi);
    lo += (f - 1) * stride + 1;
  }
  const unsigned ge = __ballot_sync(FULL, lo + lane >= hi ||
                                              keys[lo + lane].x >= p);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

}  // namespace

// The kernels sit outside the anonymous namespace, so that their names in a
// profile read as they are written here.
__global__ void __launch_bounds__(FWD_CH* FWD_ROWS)
    gather_fwd_kernel(const __grid_constant__ Table t,
                      const float* __restrict__ coords, int n,
                      float* __restrict__ out0, float* __restrict__ out1) {
  const MapDesc& d = t.maps[find_map(t, blockIdx.x)];
  const int c = (blockIdx.x - d.start) * FWD_CH + threadIdx.x % FWD_CH;
  if (c >= d.c) return;
  float* out = (d.side ? out1 : out0) + d.col + c;
  const int end = min(n, (int)(blockIdx.y + 1) * FWD_SAMPLES);
  for (int s = blockIdx.y * FWD_SAMPLES + threadIdx.x / FWD_CH; s < end;
       s += FWD_ROWS) {
    float gx, gy;
    scaled(d, coords, s, gx, gy);
    float v;
    if (d.nearest) {
      v = load(d, clip(gx, d.h - 1), clip(gy, d.w - 1), c);
    } else {
      const Corners r = corners(gx, gy, d.h, d.w);
      const float t0 = __fmul_rn(load(d, r.x0, r.y0, c), r.w0);
      const float t1 = __fmul_rn(load(d, r.x0, r.y1, c), r.w1);
      const float t2 = __fmul_rn(load(d, r.x1, r.y0, c), r.w2);
      const float t3 = __fmul_rn(load(d, r.x1, r.y1, c), r.w3);
      v = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
    }
    out[(long long)s * d.row] = v;
  }
}

// Scratch buffers hold plain (not read-only) loads: a pass reads what the
// block's previous pass wrote.
__global__ void __launch_bounds__(SORT_THREADS)
    gather_sort_kernel(const __grid_constant__ Table t, const float* coords,
                       int n, int2* keys_a, int2* keys_b) {
  __shared__ int hist[RADIX];
  __shared__ int base[RADIX];
  __shared__ int wcount[SORT_THREADS / 32][RADIX];
  const MapDesc& d = t.maps[blockIdx.x];
  const int nk = d.nearest ? n : 4 * n;
  const int npass = sort_passes(d.h * d.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the last pass writes A
  int2* src = (npass & 1 ? keys_b : keys_a) + d.key_off;
  int2* dst = (npass & 1 ? keys_a : keys_b) + d.key_off;
  for (int k = tid; k < nk; k += SORT_THREADS)
    src[k] = make_int2(key_pixel(d, coords, k, nullptr), k);
  __syncthreads();
  for (int pass = 0; pass < npass; ++pass) {
    const int shift = 8 * pass;
    if (tid < RADIX) hist[tid] = 0;
    __syncthreads();
    for (int k = tid; k < nk; k += SORT_THREADS)
      atomicAdd(&hist[(src[k].x >> shift) & (RADIX - 1)], 1);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 256 counts, 8 a lane
      int v[RADIX / 32], sum = 0;
#pragma unroll
      for (int i = 0; i < RADIX / 32; ++i) {
        v[i] = hist[lane * (RADIX / 32) + i];
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += up;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < RADIX / 32; ++i) {
        base[lane * (RADIX / 32) + i] = run;
        run += v[i];
      }
    }
    for (int start = 0; start < nk; start += SORT_THREADS) {
      int* wc = &wcount[0][0];
      for (int i = tid; i < (SORT_THREADS / 32) * RADIX; i += SORT_THREADS)
        wc[i] = 0;
      __syncthreads();
      const int k = start + tid;
      const bool valid = k < nk;
      const int2 key = valid ? src[k] : make_int2(0, 0);
      // a lane past the end gets a digit of its own, matching no other
      const int dg = valid ? (key.x >> shift) & (RADIX - 1) : RADIX + lane;
      const unsigned peers = __match_any_sync(FULL, dg);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (valid && rank == 0) wcount[warp][dg] = __popc(peers);
      __syncthreads();
      if (tid < RADIX) {  // each digit's slots: earlier chunks, then warps
        int run = base[tid];
        for (int w = 0; w < SORT_THREADS / 32; ++w) {
          const int cnt = wcount[w][tid];
          wcount[w][tid] = run;
          run += cnt;
        }
        base[tid] = run;
      }
      __syncthreads();
      if (valid) dst[wcount[warp][dg] + rank] = key;
      __syncthreads();
    }
    int2* tmp = src;
    src = dst;
    dst = tmp;
  }
}

__global__ void __launch_bounds__(ACC_THREADS)
    gather_acc_kernel(const __grid_constant__ Table t,
                      const float* __restrict__ coords, int n,
                      const int2* __restrict__ keys,
                      const float* __restrict__ g0,
                      const float* __restrict__ g1) {
  __shared__ float acc[ACC_PIXELS][ACC_CH + 1];
  const MapDesc& d = t.maps[find_map(t, blockIdx.x)];
  const int tiles = (d.c + ACC_CH - 1) / ACC_CH;
  const int u = blockIdx.x - d.start;
  const int p0 = u / tiles * ACC_PIXELS, c0 = u % tiles * ACC_CH;
  const int np = min(ACC_PIXELS, d.h * d.w - p0), nc = min(ACC_CH, d.c - c0);
  const int2* mk = keys + d.key_off;
  const float* g = (d.side ? g1 : g0) + d.col + c0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nk = d.nearest ? n : 4 * n;
  for (int i = threadIdx.x; i < ACC_PIXELS * (ACC_CH + 1); i += ACC_THREADS)
    (&acc[0][0])[i] = 0.f;
  __syncthreads();
  // warp w owns a run of the tile's pixels and walks their keys in order;
  // a pixel's sum is stored when its last key has been added
  const int per = (np + ACC_THREADS / 32 - 1) / (ACC_THREADS / 32);
  const int wp0 = p0 + warp * per, wp1 = min(wp0 + per, p0 + np);
  if (wp0 < wp1) {
    const int a = warp_lower_bound(mk, 0, nk, wp0, lane);
    const int b = warp_lower_bound(mk, a, nk, wp1, lane);
    int cur = -1;
    float s0 = 0.f, s1 = 0.f;
    for (int j0 = a; j0 < b; j0 += 32) {
      // each lane brings one key's pixel, sample and weight; then all lanes
      // add them channel-wise in key order
      int pix = 0, smp = 0;
      float wt = 1.f;
      if (j0 + lane < b) {
        const int2 key = mk[j0 + lane];
        pix = key.x;
        key_pixel(d, coords, key.y, &wt);
        smp = d.nearest ? key.y : key.y >> 2;
      }
      const int cnt = min(32, b - j0);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) {
        const int pq = __shfl_sync(FULL, pix, q);
        const int sq = __shfl_sync(FULL, smp, q);
        const float wq = __shfl_sync(FULL, wt, q);
        if (pq != cur) {
          if (cur >= 0) {
            acc[cur - p0][lane] = s0;
            acc[cur - p0][lane + 32] = s1;
          }
          cur = pq;
          s0 = s1 = 0.f;
        }
        const float* gr = g + (long long)sq * d.row;
        if (lane < nc)
          s0 = __fadd_rn(s0, d.nearest ? gr[lane] : __fmul_rn(gr[lane], wq));
        if (lane + 32 < nc)
          s1 = __fadd_rn(s1, d.nearest ? gr[lane + 32]
                                       : __fmul_rn(gr[lane + 32], wq));
      }
    }
    if (cur >= 0) {
      acc[cur - p0][lane] = s0;
      acc[cur - p0][lane + 32] = s1;
    }
  }
  __syncthreads();
  const int total = np * nc;
  if (d.sc == 1) {  // channels adjacent in memory: threads along channels
    for (int idx = threadIdx.x; idx < total; idx += ACC_THREADS) {
      const int i = idx / nc, c = idx - i * nc;
      store(d, p0 + i, c0 + c, acc[i][c]);
    }
  } else {  // threads along pixels
    for (int idx = threadIdx.x; idx < total; idx += ACC_THREADS) {
      const int c = idx / np, i = idx - c * np;
      store(d, p0 + i, c0 + c, acc[i][c]);
    }
  }
}

// The host descriptor of map m: DESC_WORDS 64-bit words (see gather.py).
static int read_table(const long long* desc, int nmaps, Table* t) {
  if (nmaps < 0 || nmaps > MAX_MAPS) return (int)cudaErrorInvalidValue;
  t->nmaps = nmaps;
  for (int m = 0; m < nmaps; ++m) {
    const long long* v = desc + m * DESC_WORDS;
    MapDesc& d = t->maps[m];
    d.ptr = v[0];
    d.sx = v[1];
    d.sy = v[2];
    d.sc = v[3];
    d.h = (int)v[4];
    d.w = (int)v[5];
    d.c = (int)v[6];
    const uint32_t bits = (uint32_t)v[7];
    memcpy(&d.fac, &bits, sizeof(float));
    d.dtype = (int)v[8];
    d.nearest = (int)v[9];
    d.scaled = (int)v[10];
    d.col = (int)v[11];
    d.side = (int)v[12];
    d.row = (int)v[13];
    d.start = 0;
    d.key_off = 0;
  }
  return 0;
}

// Rows of `nmaps` maps at the (n, 2) float32 coords: map m's channels go to
// columns [col, col + C) of out0 or out1 (its side), whose rows are `row`
// floats apart.
extern "C" int gather_fwd(const long long* desc, int nmaps,
                          const float* coords, int n, float* out0,
                          float* out1, cudaStream_t stream) {
  Table t;
  int err = read_table(desc, nmaps, &t);
  if (err) return err;
  int blocks = 0;
  for (int m = 0; m < nmaps; ++m) {
    t.maps[m].start = blocks;
    blocks += (t.maps[m].c + FWD_CH - 1) / FWD_CH;
  }
  if (blocks == 0 || n == 0) return 0;
  const dim3 grid(blocks, (n + FWD_SAMPLES - 1) / FWD_SAMPLES);
  gather_fwd_kernel<<<grid, FWD_CH * FWD_ROWS, 0, stream>>>(t, coords, n,
                                                            out0, out1);
  return (int)cudaGetLastError();
}

// Dense gradients of `nmaps` maps (desc's pointers and strides are the
// gradients') from the rows' cotangents g0 and g1 (side). Scratch: two
// buffers of sum(keys) int2, keys = n a nearest map and 4 n a bilinear
// one, A first; A holds the sorted keys afterwards.
extern "C" int gather_bwd(const long long* desc, int nmaps,
                          const float* coords, int n, const float* g0,
                          const float* g1, void* scratch,
                          cudaStream_t stream) {
  Table t;
  int err = read_table(desc, nmaps, &t);
  if (err) return err;
  int blocks = 0, keys = 0;
  for (int m = 0; m < nmaps; ++m) {
    MapDesc& d = t.maps[m];
    d.start = blocks;
    d.key_off = keys;
    const int px = d.h * d.w;
    blocks += (px + ACC_PIXELS - 1) / ACC_PIXELS *
              ((d.c + ACC_CH - 1) / ACC_CH);
    keys += d.nearest ? n : 4 * n;
  }
  if (nmaps == 0 || blocks == 0) return 0;
  int2* a = static_cast<int2*>(scratch);
  gather_sort_kernel<<<nmaps, SORT_THREADS, 0, stream>>>(t, coords, n, a,
                                                          a + keys);
  err = (int)cudaGetLastError();
  if (err) return err;
  gather_acc_kernel<<<blocks, ACC_THREADS, 0, stream>>>(t, coords, n, a, g0,
                                                         g1);
  return (int)cudaGetLastError();
}
