// Fused restore (gather -> checksum -> scatter) for Hopper (sm_90a), bound
// to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/snapshot_fuse/kernel.py:146
// `fused_restore_pallas` (body `_restore_kernel`, kernel.py:137).  For each
// compact row i it copies chunk[src[i]] to dest[dst[i]] in place and writes
// the row's poly32 checksum to csum[i] (compact order).  When a
// guest-indexed table of publish-time checksums is given, each row is also
// verified against expected[dst[i]] on the device, and the number of rows
// that disagree is counted in n_bad; the host fetches the bad guest indices
// only when n_bad > 0.  Rows not named by dst keep their contents.
//
// Bound: one 256-page chunk moves 1 MiB in and 1 MiB out (plus 4 KiB of
// indices and checksums): 2.1 MB, 0.63 us at 3.35 TB/s.  At that size a
// launch costs more than the transfer, so the kernel is launch-bound; the
// fix (batching chunks, CUDA graphs) belongs to a later change.
//
// Design.  One block of 256 threads per row: the block reads its own src/dst
// (the Pallas scalar-prefetch index maps), each thread moves one 16-byte
// uint4 and folds it into a uint32 partial checksum, and the block reduces
// the partials with warp shuffles.  The checksum costs no extra traffic:
// it is computed from the registers that carry the row.  Callers pass
// unique dst (duplicates would race; the reference is last-write-wins).

#include "common.cuh"

namespace {

constexpr int kRowThreads = aq::kPageU4;  // one uint4 per thread

__global__ void __launch_bounds__(kRowThreads)
restore_kernel(uint4* __restrict__ dest, const uint4* __restrict__ chunk,
               const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
               const uint4* __restrict__ weights, const uint32_t* __restrict__ expected,
               uint32_t* __restrict__ csum, int32_t* __restrict__ n_bad) {
  __shared__ uint32_t partial[kRowThreads / 32];
  const int64_t i = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t s = src[i];
  const int64_t d = dst[i];
  const uint4 v = chunk[s * aq::kPageU4 + t];
  dest[d * aq::kPageU4 + t] = v;
  uint32_t acc = aq::warp_sum(aq::dot4(v, __ldg(weights + t)));
  if ((t & 31) == 0) partial[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    acc = aq::warp_sum(t < kRowThreads / 32 ? partial[t] : 0u);
    if (t == 0) {
      csum[i] = acc;
      if (expected != nullptr && expected[d] != acc) atomicAdd(n_bad, 1);
    }
  }
}

}  // namespace

// dest: (N, 4096) bytes, chunk: (C, 4096) bytes, src/dst: int64[m],
// weights: uint32[1024], expected: uint32 table indexed by guest page or
// NULL, csum: uint32[m], n_bad: int32[1] (zeroed here when expected is set).
extern "C" int aq_fused_restore(void* dest, const void* chunk, const void* src, const void* dst,
                                int64_t m, const void* weights, const void* expected, void* csum,
                                void* n_bad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (expected != nullptr) {
    const cudaError_t err = cudaMemsetAsync(n_bad, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m <= 0) return 0;
  restore_kernel<<<static_cast<unsigned int>(m), kRowThreads, 0, s>>>(
      static_cast<uint4*>(dest), static_cast<const uint4*>(chunk),
      static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst),
      static_cast<const uint4*>(weights), static_cast<const uint32_t*>(expected),
      static_cast<uint32_t*>(csum), static_cast<int32_t*>(n_bad));
  return static_cast<int>(cudaGetLastError());
}
