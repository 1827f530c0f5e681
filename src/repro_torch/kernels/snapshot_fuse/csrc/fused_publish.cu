// Fused publish sweep for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/snapshot_fuse/kernel.py:94
// `fused_publish_pallas` (body `_publish_kernel`, kernel.py:38).  For each
// 4 KiB page of an (N, 4096) uint8 matrix it produces the zero flag, the
// poly32 checksum, and the hot/cold compaction of the non-zero pages in
// ascending page order (hot = non-zero and in the working set, cold =
// non-zero and not), plus the two counts.  The output equals
// repro_torch/kernels/snapshot_fuse/ref.py::fused_publish_ref bit for bit.
//
// Bound: the sweep must read the N*4096 page bytes once and write the
// non-zero pages once, plus ~10 bytes per page of flags, checksums and
// positions: about 2.3 GB for a 1.5 GiB image at 40% non-zero, 0.67 ms at
// 3.35 TB/s.  It is bound by bytes; the checksum is 2 int ops per 4 bytes.
//
// Design.  The TPU kernel carries the hot/cold counters across a
// sequential grid in SMEM.  CUDA blocks run in any order, so the
// compaction is split into three launches on one stream:
//   (A) classify: one warp per page reads it with 16-byte loads (8 per
//       lane, 512 contiguous bytes per warp instruction) and writes the
//       zero flag (OR reduction), the checksum (uint32 warp reduction) and
//       the page class (0 zero, 1 hot, 2 cold);
//   (B) scan: one block of 1024 threads walks the class array in tiles and
//       computes each page's destination row as an exclusive prefix count
//       of its class.  Hot and cold counts are scanned together, packed in
//       one 64-bit value (hot in the low half, cold in the high half);
//   (C) compact: one warp per non-zero page copies it to hot[pos] or
//       cold[pos].
// The host reads the two counts between (B) and (C) to size the outputs.
// (C) reads the non-zero pages a second time (+0.6 GB at the size above);
// a single pass with decoupled look-back would remove that re-read.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kLoadsPerLane = aq::kPageU4 / 32;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
publish_classify_kernel(const uint4* __restrict__ pages, const uint8_t* __restrict__ ws,
                        const uint4* __restrict__ weights, int64_t n,
                        uint8_t* __restrict__ zero, uint32_t* __restrict__ csum,
                        uint8_t* __restrict__ cls) {
  const int lane = threadIdx.x & 31;
  const int64_t page = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (page >= n) return;  // whole warp leaves together
  const uint4* src = pages + page * aq::kPageU4;
  uint4 v[kLoadsPerLane];
#pragma unroll
  for (int k = 0; k < kLoadsPerLane; ++k) v[k] = src[k * 32 + lane];
  uint32_t any = 0, acc = 0;
#pragma unroll
  for (int k = 0; k < kLoadsPerLane; ++k) {
    any |= v[k].x | v[k].y | v[k].z | v[k].w;
    acc += aq::dot4(v[k], __ldg(weights + k * 32 + lane));
  }
  any = aq::warp_or(any);
  acc = aq::warp_sum(acc);
  if (lane == 0) {
    const bool nz = any != 0;
    zero[page] = nz ? 0 : 1;
    csum[page] = acc;
    cls[page] = nz ? (ws[page] ? 1 : 2) : 0;
  }
}

__device__ __forceinline__ unsigned long long class_step(uint8_t c) {
  return c == 1 ? 1ull : (c == 2 ? (1ull << 32) : 0ull);
}

__device__ __forceinline__ unsigned long long warp_inclusive_scan(unsigned long long x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kScanThreads)
publish_scan_kernel(const uint8_t* __restrict__ cls, int64_t n, int32_t* __restrict__ pos,
                    int32_t* __restrict__ counts) {
  __shared__ unsigned long long warp_incl[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = static_cast<int64_t>(kScanThreads) * kScanItems;
  unsigned long long carry = 0;  // rows placed by earlier tiles: hot low, cold high
  for (int64_t base = 0; base < n; base += tile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kScanItems;
    uint8_t c[kScanItems];
    unsigned long long local = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      c[k] = (i0 + k < n) ? cls[i0 + k] : 0;
      local += class_step(c[k]);
    }
    const unsigned long long incl = warp_inclusive_scan(local, lane);
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_incl[lane] = warp_inclusive_scan(warp_incl[lane], lane);
    __syncthreads();
    unsigned long long run = carry + (warp > 0 ? warp_incl[warp - 1] : 0ull) + incl - local;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = i0 + k;
      if (i < n) {
        pos[i] = c[k] == 1 ? static_cast<int32_t>(run & 0xffffffffull)
                           : (c[k] == 2 ? static_cast<int32_t>(run >> 32) : -1);
      }
      run += class_step(c[k]);
    }
    carry += warp_incl[kScanThreads / 32 - 1];
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    counts[0] = static_cast<int32_t>(carry & 0xffffffffull);
    counts[1] = static_cast<int32_t>(carry >> 32);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
publish_compact_kernel(const uint4* __restrict__ pages, const uint8_t* __restrict__ cls,
                       const int32_t* __restrict__ pos, int64_t n, uint4* __restrict__ hot,
                       uint4* __restrict__ cold) {
  const int lane = threadIdx.x & 31;
  const int64_t page = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (page >= n) return;
  const uint8_t c = cls[page];
  if (c == 0) return;
  const uint4* src = pages + page * aq::kPageU4;
  uint4* dst = (c == 1 ? hot : cold) + static_cast<int64_t>(pos[page]) * aq::kPageU4;
  uint4 v[kLoadsPerLane];
#pragma unroll
  for (int k = 0; k < kLoadsPerLane; ++k) v[k] = src[k * 32 + lane];
#pragma unroll
  for (int k = 0; k < kLoadsPerLane; ++k) dst[k * 32 + lane] = v[k];
}

unsigned int page_blocks(int64_t n) {
  return static_cast<unsigned int>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// (A) + (B): classify every page, then scan the classes into destination
// rows and the counts [n_hot, n_cold].  pages: n*4096 bytes, 16-byte aligned.
extern "C" int aq_publish_classify(const void* pages, const void* ws, const void* weights,
                                   int64_t n, void* zero, void* csum, void* cls, void* pos,
                                   void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    publish_classify_kernel<<<page_blocks(n), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const uint4*>(pages), static_cast<const uint8_t*>(ws),
        static_cast<const uint4*>(weights), n, static_cast<uint8_t*>(zero),
        static_cast<uint32_t*>(csum), static_cast<uint8_t*>(cls));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  publish_scan_kernel<<<1, kScanThreads, 0, s>>>(static_cast<const uint8_t*>(cls), n,
                                                 static_cast<int32_t*>(pos),
                                                 static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// (C): copy each non-zero page to its row of hot or cold.
extern "C" int aq_publish_compact(const void* pages, const void* cls, const void* pos, int64_t n,
                                  void* hot, void* cold, void* stream) {
  if (n <= 0) return 0;
  publish_compact_kernel<<<page_blocks(n), kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pages), static_cast<const uint8_t*>(cls),
      static_cast<const int32_t*>(pos), n, static_cast<uint4*>(hot), static_cast<uint4*>(cold));
  return static_cast<int>(cudaGetLastError());
}
