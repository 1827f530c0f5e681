// Per-page poly32 checksum for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/page_checksum/kernel.py:22
// `page_checksum_pallas` (body `_checksum_block`, kernel.py:15).  For each
// row of E little-endian uint32 lanes it writes
//     h = sum_i lane_i * P^(E-1-i)  (mod 2^32),  P = 0x01000193,
// equal bit for bit to repro_torch/kernels/page_checksum/ref.py and to the
// checksum column of the fused publish sweep (the dedup store relies on the
// two agreeing: pages hashed here must hit pages the fused publish stored).
//
// Bound: the rows are read once and 4 bytes per row written, N*row + 4N
// bytes: 0.481 ms at 3.35 TB/s for the 1.5 GiB image, 0.027 ms for a
// 21.7k-page hot batch.  Two 32-bit integer operations per 4 bytes keep it
// bound by bytes.
//
// Design.  The weight vector is staged once per block in shared memory; one
// warp takes one row with 16-byte loads and folds each word into a uint32
// partial, and a warp reduction sums the partials.  Every product and sum
// wraps in uint32, so the reduction order does not change the result.

#include "../../snapshot_fuse/csrc/common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
page_checksum_kernel(const uint4* __restrict__ rows, const uint4* __restrict__ weights,
                     int64_t n, int64_t row_u4, uint32_t* __restrict__ out) {
  extern __shared__ uint4 w[];
  for (int64_t j = threadIdx.x; j < row_u4; j += blockDim.x) w[j] = weights[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // after the only barrier: safe to leave
  const uint4* src = rows + row * row_u4;
  uint32_t acc = 0;
#pragma unroll 8
  for (int64_t j = lane; j < row_u4; j += 32) acc += aq::dot4(src[j], w[j]);
  acc = aq::warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// rows: n * row_bytes bytes, 16-byte aligned, row_bytes a multiple of 16;
// weights: uint32[row_bytes / 4]; out: uint32[n].
extern "C" int aq_page_checksum(const void* rows, const void* weights, int64_t n,
                                int64_t row_bytes, void* out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = static_cast<size_t>(row_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        page_checksum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  page_checksum_kernel<<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const uint4*>(weights), n, row_bytes / 16,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
