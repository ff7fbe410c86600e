// Shared-memory staging and warp search for the sorted-input kernels of
// gather.cu (K6) and join.cu (K7).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// The block copies the bytes [src, src + len) to dst (16-byte aligned,
// len + 16 bytes) with 16-byte cp.async and a scalar head and tail of
// E-sized elements; src and len are multiples of sizeof(E).  Returns the offset in dst
// where src lands (src % 16).  The caller waits and syncs.
template <typename E>
__device__ __forceinline__ int stage_async(char* dst, const char* src,
                                           long long len) {
  const uintptr_t a0 = (uintptr_t)src, a1 = a0 + (uintptr_t)len;
  const uintptr_t base = a0 & ~(uintptr_t)15;
  uintptr_t v0 = (a0 + 15) & ~(uintptr_t)15, v1 = a1 & ~(uintptr_t)15;
  if (v0 > a1) v0 = a1;
  if (v1 < v0) v1 = v0;
  for (uintptr_t v = v0 + 16 * threadIdx.x; v < v1; v += 16 * blockDim.x)
    cp_async16(dst + (v - base), (const void*)v);
  const int nh = (int)((v0 - a0) / sizeof(E));
  const int nt = (int)((a1 - v1) / sizeof(E));
  const int t = threadIdx.x;
  if (t < nh)
    reinterpret_cast<E*>(dst + (a0 - base))[t] =
        reinterpret_cast<const E*>(a0)[t];
  else if (t - nh < nt)
    reinterpret_cast<E*>(dst + (v1 - base))[t - nh] =
        reinterpret_cast<const E*>(v1)[t - nh];
  return (int)(a0 - base);
}

// first p in [lo, hi) with a[p] >= q (hi if none) in the sorted a, found by
// one whole warp: each round its 32 lanes probe the ends of 32 equal parts
__device__ __forceinline__ long long warp_lower_bound(
    const int* __restrict__ a, long long lo, long long hi, long long q) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (lane + 1) * step - 1;
    const unsigned below =
        __ballot_sync(0xffffffffu, p < hi && (long long)a[p] < q);
    const long long k = __popc(below);
    const long long nhi = lo + (k + 1) * step - 1;
    lo += k * step;
    hi = nhi < hi ? nhi : hi;
  }
  const long long p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu,
                                   p < hi && (long long)a[p] < q));
}

}  // namespace
