// Tensor-core building blocks shared by remd.cu (K1) and selfsim.cu (K2b):
// cp.async copies into shared memory, the TF32 split of a float32 value, and
// the three-product step of mma.sync on TF32 fragments ("3xTF32").
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

#define MAX_DEVICES 64

// Lets `kernel` use `bytes` of dynamic shared memory on the current device:
// once per device (`ready` holds MAX_DEVICES flags), not once per call;
// `setups` counts the devices set.
template <typename Kernel>
static cudaError_t smem_limit_once(Kernel kernel, int bytes, bool* ready,
                                   int* setups) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
    ++*setups;
  }
  return cudaSuccess;
}
