// Zero-page detection for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/zero_detect/kernel.py:26
// `zero_detect_pallas` (body `_zero_detect_block`, kernel.py:19).  For each
// row of an (N, E) matrix it writes int32 1 when every element equals zero
// by VALUE and 0 otherwise, exactly as repro_torch/kernels/zero_detect/ref.py
// does.  Value semantics for floats (-0.0 is zero, NaN is not) come from a
// 16-byte mask applied to every word before the OR: the sign bit of each
// float element is cleared (0x7FFFFFFF for float32, 0x7FFF7FFF for 16-bit
// floats), and integer rows use all ones, a plain OR.
//
// Bound: the rows are read once and 4 bytes per row written: N*row + 4N
// bytes.  For the 1.5 GiB image (393,216 pages of 4 KiB) that is 1.61 GB,
// 0.481 ms at 3.35 TB/s.  It is bound by bytes: one AND and one OR per word.
//
// Design.  The TPU grid walks (block_pages, E) tiles in order; here one warp
// takes one row, each lane loads 16-byte words 512 contiguous bytes apart
// per warp instruction, and a warp OR-reduction gives the flag.  Blocks are
// independent, so the ragged last block masks its missing rows itself (the
// TPU wrapper padded them with non-zero filler instead).

#include "../../snapshot_fuse/csrc/common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zero_detect_kernel(const uint4* __restrict__ rows, int64_t n, int64_t row_u4, uint4 mask,
                   int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together
  const uint4* src = rows + row * row_u4;
  uint32_t any = 0;
#pragma unroll 8
  for (int64_t j = lane; j < row_u4; j += 32) {
    const uint4 v = src[j];
    any |= (v.x & mask.x) | (v.y & mask.y) | (v.z & mask.z) | (v.w & mask.w);
  }
  any = aq::warp_or(any);
  if (lane == 0) out[row] = any ? 0 : 1;
}

}  // namespace

// rows: n * row_bytes bytes, 16-byte aligned, row_bytes a multiple of 16;
// mask: the per-word value mask (m0..m3 for the four 32-bit words of each
// 16 bytes); out: int32[n].
extern "C" int aq_zero_detect(const void* rows, int64_t n, int64_t row_bytes, uint32_t m0,
                              uint32_t m1, uint32_t m2, uint32_t m3, void* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  zero_detect_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), n, row_bytes / 16, make_uint4(m0, m1, m2, m3),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
