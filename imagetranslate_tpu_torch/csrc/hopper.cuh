// Hopper (sm_90a) building blocks shared by the port's TMA / wgmma kernels
// (flash_attention.cu, topk_project.cu, train_attention.cu): register
// reallocation, mbarriers, TMA tile loads, named barriers, wgmma descriptors
// and fences, row maxima and sums as trees, and the driver's
// cuTensorMapEncodeTiled reached through the runtime (so the link needs no
// -lcuda). Everything is in an anonymous namespace: each source that
// includes this header gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

// 2^x on the SFU, subnormal results flushed to zero.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A (c0, c1, c2, c3) box of a 4-D tensor map into shared memory; completes
// its bytes on `bar`.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A (c0, c1, c2) box of a 3-D tensor map into shared memory; completes its
// bytes on `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A (c0, c1) box of a 2-D tensor map into shared memory; completes its bytes
// on `bar`.
__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that a wgmma reads or writes asynchronously at this point of
// the program, so that the compiler moves no access to them across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// max and sum of N values (a power of two) as trees (v is overwritten).
template <int N>
__device__ __forceinline__ float tree_max(float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) v[j] = fmaxf(v[j], v[j + N / 2]);
  if constexpr (N == 2) return v[0];
  else return tree_max<N / 2>(*reinterpret_cast<float(*)[N / 2]>(&v));
}

template <int N>
__device__ __forceinline__ float tree_sum(float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) v[j] += v[j + N / 2];
  if constexpr (N == 2) return v[0];
  else return tree_sum<N / 2>(*reinterpret_cast<float(*)[N / 2]>(&v));
}

// The accumulator operands of a wgmma: d[0 .. n).
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(i) ACC4(i), ACC4(i + 4)
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC32(i) ACC16(i), ACC16(i + 16)
#define ACC64(i) ACC32(i), ACC32(i + 32)
#define OUT4(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define OUT16(i) OUT4(i), OUT4(i + 4), OUT4(i + 8), OUT4(i + 12)
#define OUT32(i) OUT16(i), OUT16(i + 16)
#define OUT64(i) OUT32(i), OUT32(i + 32)

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace
