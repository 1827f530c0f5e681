// Fused restore (gather -> checksum -> scatter) over a row list, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/snapshot_fuse/kernel.py:146
// `fused_restore_pallas` (body `_restore_kernel`, kernel.py:137).  For each
// row i of the list it copies the 4 KiB row at its source address to
// dest[dst[i]] in place and writes the row's poly32 checksum to csum[i].
// When a guest-indexed table of publish-time checksums is given, each row is
// also verified against expected[dst[i]] on the device: bad[i] flags the
// rows that disagree and n_bad counts them, so the host reads one counter
// and fetches the bad guest pages only when it is not 0.  With dest NULL the
// launch only checksums and verifies (the serving layer's pre-verify of a
// walk's source rows).  Rows not named by dst keep their contents.
//
// Bound: bytes, 8 KiB a row installed (4 KiB a row verified only) plus
// 16 bytes of row list and 4 of checksum.  One launch takes a whole restore
// walk (the serving layer queues every extent of a walk and flushes once),
// so the per-chunk launch cost of the earlier one-block-a-row kernel is paid
// once a walk instead of once an extent.
//
// Design: see row_copy.cuh (a persistent grid of warps, a warp a row with
// eight 16-byte loads in flight a lane).  The checksum costs no
// extra traffic: it is folded from the copy of the row already on chip, in
// native uint32 arithmetic, so its order does not matter.  Callers pass
// unique dst (duplicates would race; the reference is last-write-wins).

#include "row_copy.cuh"

// dest: (N, 4096) bytes or NULL (verify only); row i from
// src_base + (src ? src[i] : i) * src_stride; dst: int64[m]; weights:
// uint32[1024]; expected: uint32 table indexed by guest page or NULL; csum:
// uint32[m]; bad: uint8[m] and n_bad: int32[1] when expected is set (n_bad
// is zeroed here, once a launch).
extern "C" int aq_fused_restore_rows(void* dest, const void* src_base, int64_t src_stride,
                                     const void* src, const void* dst, int64_t m,
                                     const void* weights, const void* expected, void* csum,
                                     void* bad, void* n_bad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (expected != nullptr) {
    const cudaError_t err = cudaMemsetAsync(n_bad, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  aq::RowArgs a{static_cast<char*>(dest), static_cast<const char*>(src_base), src_stride,
                static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst), m,
                aq::kSlotBytes, 1, static_cast<const uint4*>(weights),
                static_cast<const uint32_t*>(expected), static_cast<uint32_t*>(csum),
                static_cast<uint8_t*>(bad), static_cast<int32_t*>(n_bad)};
  return static_cast<int>(aq::launch_rows<true>(a, s));
}
