// Row gather for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/page_gather/kernel.py:26
// `page_gather_pallas` (body `_gather_kernel`, kernel.py:20):
//     out[i] = rows[idx[i]],  i < m,
// for rows of any width that is a multiple of 16 bytes (any dtype: the
// kernel moves bytes).  It compacts a snapshot's hot and cold pages at
// publish and materializes dedup pages from a tier's page rows.
//
// Bound: each output row is read once and written once, plus 8 bytes of
// index: 2*m*row + 8m bytes.  For the hot set of the 1.5 GiB image (~21.7k
// pages) 0.053 ms at 3.35 TB/s, for its cold set (~136.9k pages) 0.335 ms.
//
// Design.  The TPU kernel scalar-prefetches the index list to drive its
// input BlockSpec.  Here one block of 128 threads copies one row: each
// thread issues both of its 16-byte loads of a 4 KiB row before either
// store, with read-only loads that do not allocate in L1 and streaming
// stores, so a block keeps the whole row in flight.  Other widths go in
// 4 KiB steps, the last one masked.  Measured on the card (PERF.md §6),
// this beats one warp a row with eight loads in flight a lane and a
// grid-stride loop, and `index_select`.  Byte offsets are 64-bit (a 3 GiB
// arena has rows past 2^31 bytes).

#include "../../snapshot_fuse/csrc/common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;                  // 16-byte words in flight a thread
constexpr int kChunk = kThreads * kUnroll;  // words a block moves per step: 4 KiB

__global__ void __launch_bounds__(kThreads)
page_gather_kernel(const uint4* __restrict__ rows, const int64_t* __restrict__ idx,
                   int64_t row_u4, uint4* __restrict__ out) {
  const int64_t i = blockIdx.x;
  const uint4* src = rows + __ldg(idx + i) * row_u4;
  uint4* dst = out + i * row_u4;
  for (int64_t j = threadIdx.x; j < row_u4; j += kChunk) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < row_u4) w[u] = aq::load_stream(src + j + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < row_u4) aq::store_stream(dst + j + u * kThreads, w[u]);
  }
}

}  // namespace

// rows: (N, row_bytes) bytes, out: (m, row_bytes) bytes, both 16-byte
// aligned with row_bytes a multiple of 16; idx: int64[m], each in [0, N).
extern "C" int aq_page_gather(const void* rows, const void* idx, int64_t m, int64_t row_bytes,
                              void* out, void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);  // one block a row
  page_gather_kernel<<<static_cast<unsigned int>(m), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const int64_t*>(idx), row_bytes / 16,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
