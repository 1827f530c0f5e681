// Row-list copy for Hopper (sm_90a): the machinery shared by the batched
// fused restore (fused_restore.cu, which also checksums and verifies each
// row) and the row scatter (page_scatter.cu).
//
// A launch moves M rows.  Row i is read from the byte address
//     src_base + (src ? src[i] : i) * src_stride
// and written to row dst[i] of dest (row_bytes wide).  The existing
// single-tensor wrappers pass the tensor's base pointer and row_bytes, so
// src holds row indices; the batched wrappers pass base 0 and stride 1, so
// src holds absolute addresses and one launch takes rows from any number of
// source tensors.  Rows wider than 4 KiB go in 4 KiB pieces.  Every address
// is 64-bit and 16-byte aligned (the wrappers check).
//
// Bound: bytes.  Each row is read once and written once (8 KiB a 4 KiB row),
// 16 bytes of row list a row; a verify-only launch reads its rows alone.
//
// Design: a persistent grid of warps, one warp a row (or 4 KiB piece): each
// lane issues its eight 16-byte loads (non-allocating) before any store
// (streaming), folding the checksum, where asked, from the registers that
// carry the row.  Mismatches are flagged per row (bad[i]) and added to n_bad
// once per warp, only when there are any.  A TMA ring in shared memory (1-D
// bulk loads and stores, an mbarrier a slot) was measured against it on the
// H100 and was slower at every walk shape (PERF.md); it is not kept.

#pragma once

#include "common.cuh"

namespace aq {

constexpr int kSlotBytes = 4096;         // one piece: a 4 KiB row or part of a wider one
constexpr int kRowThreads = 256;         // 8 warps a block
constexpr int kRowBlocksPerSm = 4;
constexpr int kRowUnroll = kSlotBytes / 16 / 32;   // 16-byte words a lane a row: 8

struct RowArgs {
  char* dest;                 // (N, row_bytes) or NULL: verify only
  const char* src_base;
  int64_t src_stride;
  const int64_t* src;         // int64[m] or NULL (src[i] = i)
  const int64_t* dst;         // int64[m]
  int64_t m;
  int64_t row_bytes;          // multiple of 16
  int64_t pieces;             // ceil(row_bytes / kSlotBytes)
  const uint4* weights;       // poly32 weights (checksumming launches)
  const uint32_t* expected;   // guest-indexed table or NULL
  uint32_t* csum;             // uint32[m] (checksumming launches)
  uint8_t* bad;               // uint8[m] when expected is set
  int32_t* n_bad;             // int32[1] when expected is set
};

struct Piece {
  int64_t row;
  int64_t off;                // byte offset inside the row
  uint32_t bytes;
};

__device__ __forceinline__ Piece piece_of(const RowArgs& a, int64_t u) {
  Piece p;
  p.row = u / a.pieces;
  p.off = (u - p.row * a.pieces) * kSlotBytes;
  const int64_t left = a.row_bytes - p.off;
  p.bytes = static_cast<uint32_t>(left < kSlotBytes ? left : kSlotBytes);
  return p;
}

__device__ __forceinline__ const char* source_of(const RowArgs& a, const Piece& p) {
  const int64_t s = a.src != nullptr ? __ldg(a.src + p.row) : p.row;
  return a.src_base + s * a.src_stride + p.off;
}

__device__ __forceinline__ char* dest_of(const RowArgs& a, const Piece& p) {
  return a.dest + __ldg(a.dst + p.row) * a.row_bytes + p.off;
}

// Record row i's checksum; returns 1 when it disagrees with the table.
__device__ __forceinline__ uint32_t record_sum(const RowArgs& a, int64_t i, uint32_t sum) {
  a.csum[i] = sum;
  if (a.expected == nullptr) return 0;
  const uint32_t b = a.expected[__ldg(a.dst + i)] != sum;
  a.bad[i] = static_cast<uint8_t>(b);
  return b;
}

// ------------------------------------------------------------ kernel

template <bool kSum>
__global__ void __launch_bounds__(kRowThreads) rows_kernel(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kRowThreads / 32);
  const int64_t units = a.m * a.pieces;
  uint4 w[kRowUnroll];
#pragma unroll
  for (int k = 0; k < kRowUnroll; ++k)
    w[k] = kSum ? __ldg(a.weights + lane + 32 * k) : make_uint4(0, 0, 0, 0);
  uint32_t my_bad = 0;
  for (int64_t u = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5); u < units; u += warps) {
    const Piece p = piece_of(a, u);
    const int n4 = static_cast<int>(p.bytes / 16);
    const uint4* from = reinterpret_cast<const uint4*>(source_of(a, p));
    uint4 v[kRowUnroll];
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k) v[k] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k)
      if (lane + 32 * k < n4) v[k] = load_stream(from + lane + 32 * k);
    if (kSum) {
#pragma unroll
      for (int k = 0; k < kRowUnroll; ++k) acc += dot4(v[k], w[k]);
    }
    if (a.dest != nullptr) {
      uint4* to = reinterpret_cast<uint4*>(dest_of(a, p));
#pragma unroll
      for (int k = 0; k < kRowUnroll; ++k)
        if (lane + 32 * k < n4) store_stream(to + lane + 32 * k, v[k]);
    }
    if (kSum) {
      acc = warp_sum(acc);
      if (lane == 0) my_bad += record_sum(a, p.row, acc);
    }
  }
  if (kSum && lane == 0 && my_bad) atomicAdd(a.n_bad, static_cast<int32_t>(my_bad));
}

// Launch the row-list copy on `stream` with one persistent grid.
template <bool kSum>
inline cudaError_t launch_rows(const RowArgs& a, cudaStream_t stream) {
  const int64_t units = a.m * a.pieces;
  if (units <= 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t need = (units + kRowThreads / 32 - 1) / (kRowThreads / 32);
  const int64_t cap = int64_t(sms) * kRowBlocksPerSm;
  rows_kernel<kSum><<<static_cast<unsigned int>(need < cap ? need : cap), kRowThreads, 0,
                          stream>>>(a);
  return cudaGetLastError();
}

}  // namespace aq
