// Tensor-core building blocks shared by remd.cu (K1), selfsim.cu (K2a,
// K2b) and sinkhorn.cu (K4: the split and the once-per-device kernel
// attribute): cp.async copies into shared memory, the TF32 split of a
// float32 value, the three-product step of mma.sync on TF32 fragments
// ("3xTF32"), and the stages of row-major (rows, C) matrices as 16-byte
// aligned row windows with the fragment reads from them (K1 and K2a).
//
// A float32 product computed this way: each operand v is split into TF32
// parts big = v rounded to TF32 and small = (v - big) rounded to TF32 (both
// to nearest, ties away from zero), and x.y is summed as big.big +
// big.small + small.big on the tensor cores; the dropped small.small term
// is ~2^-22 of a product. The tensor cores' f32 sums truncate, so a kernel
// sums one stage of k on them and adds each stage's sums into f32 registers
// on the CUDA cores. ops/kernels/remd.py states the rounding (`tf32_round`,
// `tf32_split`) and the fragment maps (`frag_a`, `frag_b`, `frag_c`) in
// Python for the CPU tests.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes, of which the first `src_bytes` are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// cp.async of 4 bytes, read if `src_bytes` is 4 and zero-filled if it is 0.
__device__ __forceinline__ void cp_async4z(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest `pending` groups have landed
template <int pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v rounded to TF32 (10 mantissa bits), nearest, ties away from zero; the
// low 13 bits of the result are 0. For finite v these are the bits of
// cvt.rna.tf32.f32, computed on the integer pipe: conversions issue 16
// results a clock per SM, and cvt made the whole kernel ~12% slower
// (tools/k1_ablation.py, `cvt_rounding`). ops/kernels/remd.py `tf32_round`
// is the same rounding in Python.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void tf32_split(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major); TF32 in, f32 sums
// (`mma_tf32_0`: c = a * b).
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32), lane
// 4g + t (ops/kernels/remd.py `frag_a`, `frag_b`, `frag_c`):
//   a[i]: row g + 8 (i & 1), column t + 4 (i >> 1);
//   b[i]: row t + 4 i, column g;
//   c[i]: row g + 8 (i >> 1), column 2t + (i & 1).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_0(float c[4], const uint32_t a[4],
                                           const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// One k8 step's A (2 x 16 x 8) and B (4 x 8 x 8) fragments of a warp (a
// 32 x 32 tile of the output), split.
struct TcFrag {
  uint32_t a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
};

// part (+)= the three TF32 products of one k8 step; `first` starts the sums
// from 0.
__device__ __forceinline__ void tc_mma(float part[2][4][4], const TcFrag& f,
                                       bool first) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      if (first)
        mma_tf32_0(part[mb][nb], f.a_big[mb], f.b_small[nb]);
      else
        mma_tf32(part[mb][nb], f.a_big[mb], f.b_small[nb]);
      mma_tf32(part[mb][nb], f.a_small[mb], f.b_big[nb]);
      mma_tf32(part[mb][nb], f.a_big[mb], f.b_big[nb]);
    }
}

// ---- stages of rows as 16-byte aligned windows (K1, K2a) -----------------
// A stage holds TC_KC channels of ROWS_A rows of a matrix a from row a0,
// then ROWS_B rows of a matrix b from row b0 (a0, b0 and the row counts
// multiples of 32; a and b row-major with C channels, 16-byte aligned),
// rows TC_LD floats apart. At C = 2179 a row starts 4-byte aligned only, so
// each row's slice comes as the 16-byte aligned window that holds it,
// channel k at column s + k, s = (row * C) % 4 (a ninth chunk where s > 0).
// In each 32-row slab the rows that share r % 4, and so their misalignment,
// are 8 consecutive shared-memory rows: every fragment read below lands on
// 32 banks (ops/kernels/remd.py `tc_smem_row`, `tc_shift`, `tc_chunks`).
#define TC_KC 32  // channels a stage
#define TC_LD 36  // floats between rows of a stage

// Shared-memory row of stage row r.
__device__ __forceinline__ int tc_smem_row(int r) {
  return (r & ~31) | ((r & 3) << 3) | ((r & 31) >> 2);
}

// Where a thread's share of each stage comes from; the same rows and chunks
// in every stage, so the offsets and checks are made once. Thread tid copies
// chunk tid % 8 of the stage rows tid / 8 + 32 q and, where r8 >= 0 names a
// misaligned row inside the matrix, chunk 8 of stage row r8. Offsets are in
// floats from a (or b): one loader serves any pair of matrices of the same
// shape (K2a loads x^ and y^ rows with one).
template <int ROWS_A, int ROWS_B>
struct TcLoader {
  long long ao, bo;  // chunk tid % 8 of row a0 + tid / 8 in a, b0 + tid / 8 in b
  long long o8;      // chunk 8 of stage row r8 (in a if a8)
  long long slab_c;  // 32 rows of C channels
  int dst, dst8;     // the chunks' offsets in a stage
  int ch, ch8;       // their first channels (negative: the row before's)
  int a_ok, b_ok;    // slabs whose row tid / 8 lies inside a, inside b
  bool ok8, a8;
};

// na, nb: the rows of a and b (rows from there on are zero-filled).
template <int ROWS_A, int ROWS_B>
__device__ __forceinline__ TcLoader<ROWS_A, ROWS_B> tc_loader(
    int a0, int na, int b0, int nb, int c, int r8) {
  TcLoader<ROWS_A, ROWS_B> L;
  const int tid = threadIdx.x;
  const int lr = tid / 8;
  // a0 and b0 are multiples of 32, so a row's misalignment is that of its
  // index in the stage
  const int s = (int)(((unsigned)lr * (unsigned)c) & 3u);
  L.ch = 4 * (tid % 8) - s;
  L.dst = tc_smem_row(lr) * TC_LD + 4 * (tid % 8);
  L.ao = (long long)(a0 + lr) * c + L.ch;
  L.bo = (long long)(b0 + lr) * c + L.ch;
  L.slab_c = (long long)32 * c;
  const int al = na - a0 - lr, bl = nb - b0 - lr;
  L.a_ok = al <= 0 ? 0 : (al + 31) / 32;
  L.b_ok = bl <= 0 ? 0 : (bl + 31) / 32;
  const int s8 = (int)(((unsigned)r8 * (unsigned)c) & 3u);
  L.ch8 = TC_KC - s8;
  L.dst8 = tc_smem_row(r8) * TC_LD + TC_KC;
  L.a8 = r8 < ROWS_A;
  const int gr = L.a8 ? a0 + r8 : b0 + r8 - ROWS_A;
  L.ok8 = r8 >= 0 && s8 > 0 && r8 < ROWS_A + ROWS_B && gr < (L.a8 ? na : nb);
  L.o8 = L.ok8 ? (long long)gr * c + L.ch8 : 0;
  return L;
}

// Bytes of a 16-byte chunk that lie inside the row: those of channels
// ch..ch+3 below c (the chunk that holds channel c - 1 is zero-filled past
// it, and chunks past it read nothing).
__device__ __forceinline__ int tc_chunk_bytes(int c, int ch) {
  const int rem = c - ch;
  return rem >= 4 ? 16 : (rem > 0 ? 4 * rem : 0);
}

// Channels [k0, k0 + TC_KC) of the stage's a rows and b rows into `st`,
// zero past C and past the matrices' last rows; chunk 8 only `with8`.
template <int ROWS_A, int ROWS_B>
__device__ __forceinline__ void tc_load_stage(
    float* st, const TcLoader<ROWS_A, ROWS_B>& L, const float* a,
    const float* b, int k0, int c, bool with8) {
  const int bytes = tc_chunk_bytes(c, k0 + L.ch);
#pragma unroll
  for (int q = 0; q < ROWS_A / 32; ++q) {
    const bool ok = q < L.a_ok && bytes > 0;
    cp_async16z(st + L.dst + q * 32 * TC_LD,
                ok ? a + L.ao + q * L.slab_c + k0 : a, ok ? bytes : 0);
  }
#pragma unroll
  for (int q = 0; q < ROWS_B / 32; ++q) {
    const bool ok = q < L.b_ok && bytes > 0;
    cp_async16z(st + L.dst + (ROWS_A + q * 32) * TC_LD,
                ok ? b + L.bo + q * L.slab_c + k0 : a, ok ? bytes : 0);
  }
  if (with8 && L.ok8) {
    const int bytes8 = tc_chunk_bytes(c, k0 + L.ch8);
    cp_async16z(st + L.dst8, bytes8 > 0 ? (L.a8 ? a : b) + L.o8 + k0 : a,
                bytes8);
  }
}

// A warp's 32 x 32 tile of a product of two stage row sets: rows r0 + 4 g +
// j and columns (B rows) r1 + 4 g + j, j = 0..3, g = 0..7 (r0, r1 multiples
// of 32): A fragment mb holds the rows with j = 2 mb (its rows 0..7) and
// j = 2 mb + 1 (rows 8..15), B fragment nb the columns with j = nb
// (ops/kernels/remd.py `tc_tile_rc`). So the 8 rows of one fragment read
// share r % 4, their shared-memory rows are consecutive and their columns
// start at the same offset: 32 lanes, 32 banks; that offset is the rows'
// misalignment, (j * C) % 4. tc_frag_offsets gives the thread's offsets of
// its rows j at channel t.
__device__ __forceinline__ void tc_frag_offsets(int r0, int r1, int c,
                                                int a_off[4], int b_off[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int sh = (int)(((unsigned)j * (unsigned)c) & 3u);
    a_off[j] = (r0 + j * 8 + g) * TC_LD + sh + t;
    b_off[j] = (r1 + j * 8 + g) * TC_LD + sh + t;
  }
}

// Reads a warp's fragments of k8 step kk of stage `st`, splits them, and,
// with NORMS, adds their squares to the row norms xs (A rows), ys (B rows).
template <bool NORMS>
__device__ __forceinline__ void tc_read_split(const float* st, int kk,
                                              const int a_off[4],
                                              const int b_off[4], TcFrag& f,
                                              float xs[2][2], float ys[4]) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = st[a_off[2 * mb + (i & 1)] + kk + (i >> 1) * 4];
      tf32_split(v, f.a_big[mb][i], f.a_small[mb][i]);
      if (NORMS) xs[mb][i & 1] = fmaf(v, v, xs[mb][i & 1]);
    }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = st[b_off[nb] + kk + i * 4];
      tf32_split(v, f.b_big[nb][i], f.b_small[nb][i]);
      if (NORMS) ys[nb] = fmaf(v, v, ys[nb]);
    }
}

#define MAX_DEVICES 64

// Runs `set` (which sets kernel attributes) on the current device once per
// device (`ready` holds MAX_DEVICES flags), not once per call; `setups`
// counts the devices set.
template <typename Set>
static cudaError_t smem_limit_once(Set set, bool* ready, int* setups) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = set();
    if (err != cudaSuccess) return err;
    ready[dev] = true;
    ++*setups;
  }
  return cudaSuccess;
}

// Lets `kernel` use `bytes` of dynamic shared memory on the current device,
// once per device.
template <typename Kernel>
static cudaError_t smem_limit_once(Kernel kernel, int bytes, bool* ready,
                                   int* setups) {
  return smem_limit_once(
      [=]() {
        return cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      },
      ready, setups);
}
