// Hopper building blocks shared by sinkhorn.cu (K4) and moments.cu (K6):
// mbarriers, TMA copies of 2D tiles into shared memory, the wgmma
// descriptor of a K-major tile of 16-float rows with 64-byte swizzle, the
// wgmma fences, and `wgmma.mma_async` on TF32 operands with f32 sums, A
// and B from shared memory (WGMMA_TF32_SS) or A from registers
// (WGMMA_TF32_RS). Each kernel instantiates the widths it uses.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint64_t* b,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
  return done;
}

// Spins until the phase of parity `parity` of barrier b has completed. A
// wait of more than ~2^34 clocks (several seconds; a whole pass at the
// path's largest shape takes well under one) can only be a fault: the
// kernel traps, and the launch reports an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  if (mbar_try_wait(b, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(b, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// TMA: the box at (channel k, row) of `map` into shared memory at dst,
// completing on barrier b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* b, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(b)), "r"(k), "r"(row) : "memory");
}

// wgmma descriptor of a K-major tile of 16-float rows with 64-byte
// swizzle, 8-row groups 512 bytes apart: the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_64B from a 512-byte aligned base. A k8 step inside
// the row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The accumulators of an m64nN wgmma as inline-asm operands: N / 2 floats
// a thread, %0 .. %(N/2 - 1).
#define WG_R68 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67"
#define WG_R96 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)
#define WG_F64 WG_F32(0), WG_F32(32)
#define WG_F68 WG_F64, WG_F4(64)
#define WG_F96 WG_F64, WG_F32(64)

// d (+)= A (64 x 8) B (N x 8)^T, both K-major TF32 in shared memory; f32
// sums; `accumulate` 0 starts from 0. d holds N / 2 floats a thread: for
// n8 block j, d[4j + e] is (row g, column 8j + 2t + e) and d[4j + 2 + e]
// row g + 8 of the warp's 16 rows (lane 4g + t). DA, DB, AC: the operand
// numbers of the two descriptors and the flag (NREG, NREG + 1, NREG + 2).
#define WGMMA_TF32_SS(NREG, N, REGS, OPS, DA, DB, AC)                      \
  __device__ __forceinline__ void wgmma_tf32(                             \
      float(&d)[NREG], uint64_t da, uint64_t db, int accumulate) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" AC ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" N                    \
                 "k8.f32.tf32.tf32 {" REGS "}, %" DA ", %" DB             \
                 ", p, 1, 1;\n}\n"                                        \
                 : OPS                                                    \
                 : "l"(da), "l"(db), "r"(accumulate));                    \
  }

// The same with A (64 x 8) from registers: a[i] is the TF32 value at row
// g + 8 (i & 1), column t + 4 (i >> 1) of the warp's 16 rows (mma.sync's
// m16n8k8 A fragment, tc.cuh). AREGS: the operand numbers of a[0..3]
// ("%NREG, ..."), DB, AC: of the descriptor and the flag.
#define WGMMA_TF32_RS(NREG, N, REGS, OPS, AREGS, DB, AC)                   \
  __device__ __forceinline__ void wgmma_tf32_rs(                          \
      float(&d)[NREG], const uint32_t(&a)[4], uint64_t db,                \
      int accumulate) {                                                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" AC ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" N                    \
                 "k8.f32.tf32.tf32 {" REGS "}, {" AREGS "}, %" DB         \
                 ", p, 1, 1;\n}\n"                                        \
                 : OPS                                                    \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                   "r"(accumulate));                                      \
  }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda).
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Makes the current device's primary context current in the calling thread.
// A thread in which PyTorch has not yet made one current (autograd's device
// threads, which run the backward passes) has none, and
// cuTensorMapEncodeTiled then refuses device addresses.
static cudaError_t bind_current_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}
