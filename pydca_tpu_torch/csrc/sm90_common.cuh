// Helpers shared by the sm_90a kernels of this directory
// (identity_counts.cu, weighted_gram.cu; plm_passes.cu takes the last): the
// upper-triangle tile order, shared-memory addressing and stores, the
// async-proxy fence, the wgmma descriptor of a K-major operand in the
// 128-byte swizzle, the register fence of a wgmma accumulator, and the
// one-time opt-in to more than 48 KB of dynamic shared memory.
// ops/_build.py hashes this header with each source, so an edit here
// rebuilds every library.

#pragma once

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// upper-triangle tile (ti <= tj) of linear block t = tj*(tj+1)/2 + ti
__device__ __forceinline__ void tile_of(long long t, int& ti, int& tj) {
  long long j = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while (j * (j + 1) / 2 > t) --j;
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  tj = static_cast<int>(j);
  ti = static_cast<int>(t - j * (j + 1) / 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms of 1024 bytes (SBO), atoms 1024-aligned.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;            // LBO: unused for swizzled K-major
  d |= static_cast<uint64_t>(1024 >> 4) << 32;    // SBO
  d |= static_cast<uint64_t>(1) << 62;            // 128-byte swizzle
  return d;
}

// keeps the compiler from moving accumulator accesses across a wgmma fence
__device__ __forceinline__ void fence_acc(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Kernel's dynamic shared memory above 48 KB, allowed once per device.
template <auto Kernel, int Bytes>
cudaError_t allow_dynamic_smem() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev].load())) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bytes);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

}  // namespace
