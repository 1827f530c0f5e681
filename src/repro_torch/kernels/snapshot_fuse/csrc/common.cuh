// Shared pieces of the snapshot data-plane kernels (sm_90a).
//
// A guest page is 4096 bytes = 256 uint4 = 1024 little-endian uint32 lanes.
// The poly32 checksum of a page is sum_j lane_j * w_j (mod 2^32) with
// w_j = P^(1023-j), P = 0x01000193.  The sum is mod 2^32, so a parallel
// reduction in any order is bit-exact as long as every product and partial
// sum wraps in uint32 — which native uint32 arithmetic does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aq {

constexpr int kPageU4 = 256;  // uint4 per 4 KiB page

__device__ __forceinline__ uint32_t dot4(const uint4 v, const uint4 w) {
  return v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t warp_or(uint32_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x |= __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A 16-byte load that skips L1 (each byte is read once) and a 16-byte
// store marked streaming (evict first).
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void store_stream(void* p, const uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

}  // namespace aq

extern "C" const char* aq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
