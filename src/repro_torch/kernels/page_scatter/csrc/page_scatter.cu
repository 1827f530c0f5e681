// Row scatter for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/page_scatter/kernel.py:25
// `page_scatter_pallas` (body `_scatter_kernel`, kernel.py:19):
//     dest[dst[i]] = compact[src[i]],  i < m,  in place,
// with src == NULL meaning src[i] = i.  Rows not named by dst keep their
// contents.  It installs restored pages into a guest image and writes new
// pages into a dedup store's tier; the src indices let a caller install a
// permutation of a chunk without materializing the permuted copy.
//
// Bound: 2*m*row bytes moved plus 16 bytes of indices per row.  One
// 256-page chunk moves 2 MiB: 0.63 us at 3.35 TB/s.  At that size a launch
// costs more than the transfer, so the restore path is launch-bound.
//
// Design.  The TPU kernel aliases (donates) dest and drives its output
// BlockSpec from scalar-prefetched indices.  Here dest is written in place;
// one block of 256 threads takes one compact row, loads its own indices and
// copies 16-byte words.  Callers pass unique dst rows (a duplicate would
// race).  Byte offsets are 64-bit.

#include "../../snapshot_fuse/csrc/common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
page_scatter_kernel(uint4* __restrict__ dest, const uint4* __restrict__ compact,
                    const int64_t* __restrict__ dst, const int64_t* __restrict__ src,
                    int64_t row_u4) {
  const int64_t i = blockIdx.x;
  const int64_t s = src != nullptr ? src[i] : i;
  const uint4* from = compact + s * row_u4;
  uint4* to = dest + dst[i] * row_u4;
  for (int64_t j = threadIdx.x; j < row_u4; j += kThreads) to[j] = from[j];
}

}  // namespace

// dest: (N, row_bytes), compact: (C, row_bytes), both 16-byte aligned with
// row_bytes a multiple of 16; dst: int64[m] in [0, N); src: int64[m] in
// [0, C) or NULL.
extern "C" int aq_page_scatter(void* dest, const void* compact, const void* dst, const void* src,
                               int64_t m, int64_t row_bytes, void* stream) {
  if (m <= 0) return 0;
  page_scatter_kernel<<<static_cast<unsigned int>(m), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(dest), static_cast<const uint4*>(compact),
      static_cast<const int64_t*>(dst), static_cast<const int64_t*>(src), row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
