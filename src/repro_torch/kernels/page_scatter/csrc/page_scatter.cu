// Row scatter over a row list, for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/page_scatter/kernel.py:25
// `page_scatter_pallas` (body `_scatter_kernel`, kernel.py:19):
//     dest[dst[i]] = row at src_base + (src ? src[i] : i) * src_stride,
// i < m, in place.  Rows not named by dst keep their contents.  It installs
// restored pages into a guest image (a whole restore walk in one launch,
// rows taken from every extent's buffer by address) and writes new pages
// into a dedup store's tier (one compact tensor, base + row index).
//
// Bound: bytes, 2 * m * row_bytes moved plus 16 bytes of row list a row:
// 0.33 ms for the ~136k-row store write at 3.35 TB/s.
//
// Design: see row_copy.cuh (a persistent grid of warps, a warp a row with
// eight 16-byte loads in flight a lane); rows of any width that
// is a multiple of 16 bytes go in 4 KiB pieces.  Callers pass unique dst
// rows (a duplicate would race).  Byte offsets are 64-bit.

#include "../../snapshot_fuse/csrc/row_copy.cuh"

// dest: (N, row_bytes), 16-byte aligned with row_bytes a multiple of 16;
// row i from src_base + (src ? src[i] : i) * src_stride (16-byte aligned);
// dst: int64[m] in [0, N).
extern "C" int aq_page_scatter_rows(void* dest, const void* src_base, int64_t src_stride,
                                    const void* src, const void* dst, int64_t m,
                                    int64_t row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16) return static_cast<int>(cudaErrorInvalidValue);
  aq::RowArgs a{static_cast<char*>(dest), static_cast<const char*>(src_base), src_stride,
                static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst), m,
                row_bytes, (row_bytes + aq::kSlotBytes - 1) / aq::kSlotBytes, nullptr,
                nullptr, nullptr, nullptr, nullptr};
  return static_cast<int>(aq::launch_rows<false>(a, static_cast<cudaStream_t>(stream)));
}
