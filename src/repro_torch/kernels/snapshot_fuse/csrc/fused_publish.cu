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
// non-zero pages once, plus 6 bytes per page of working-set flag, zero flag
// and checksum: about 2.26 GB for a 1.5 GiB image at 40% non-zero, 0.67 ms
// at 3.35 TB/s.  It is bound by bytes; the checksum is 2 int ops per 4 bytes.
//
// Design: one launch, one pass.  The TPU kernel carries the hot/cold
// counters across its sequential grid; CUDA blocks run in any order, so the
// running counts become a single-pass scan with decoupled look-back
// (Merrill & Garland 2016):
//   - A block of 32 warps takes a tile of 64 pages.  Its tile number comes
//     from an atomic counter, not from blockIdx, so a tile only ever waits
//     on tiles whose blocks have already started: the look-back always
//     makes progress.
//   - Warp w holds page w of the tile in registers (each lane eight 16-byte
//     loads, 512 contiguous bytes a warp instruction) and stages page 32 + w
//     in shared memory (cp.async, no registers held in flight): 256 KB of
//     loads in flight an SM, where 64 registers a thread leave room for one
//     page a warp.  The zero flag (OR) and the checksum (uint32 sum) of each
//     page are warp reductions.
//   - The page classes meet in shared memory; two ballots over each half
//     give every page its rank among the tile's hot and cold pages, in page
//     order, and the tile's two counts.
//   - Warp 0 publishes the tile's counts as its aggregate in a 64-bit status
//     word, then sums the statuses of the tiles before it, 32 at a time,
//     back to the nearest one that has published its inclusive prefix, and
//     publishes the tile's own.
//   - Every warp then stores its two pages at their rows, from registers and
//     from shared memory: hot rows at [0, n_hot), cold rows at [cold_base,
//     cold_base + n_cold) of one (N, 4096) output, cold_base = the working
//     set's size (the caller counts it before the launch).  Each page is
//     read once and the non-zero pages written once; nothing else goes
//     through device memory but the status words.
// Larger tiles mean fewer look-backs, which cost more than the occupancy
// that smaller blocks would add; the designs measured against this one are
// in PERF.md.  The status array and the tile counter are zeroed by this
// entry point before each launch (one memset on the same stream).  A row's
// byte offset is a 64-bit product throughout: rows pass 2^31 bytes from
// 524,288 pages.

#include "common.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kTilePages = 2 * kWarps;    // ops.py PUBLISH_TILE_PAGES
constexpr int kLoadsPerLane = aq::kPageU4 / 32;
constexpr int kStageBytes = kWarps * aq::kPageU4 * 16;   // the tile's second half

// Tile status word: hot count in bits 0-30, cold count in bits 31-61, flag
// in bits 62-63.  Counts of at most 2^31 - 1 pages in all (ops.py
// PUBLISH_MAX_PAGES) add without carrying from one field into the next.
constexpr int kColdShift = 31;
constexpr uint64_t kCountMask = (1ull << kColdShift) - 1;
constexpr uint64_t kFlagMask = 3ull << 62;
constexpr uint64_t kAggregate = 1ull << 62;   // the tile's own counts
constexpr uint64_t kPrefix = 2ull << 62;      // counts of tiles 0..this one
                                              // 0: not published yet

// A status word carries its whole payload, and nothing else is published
// through it, so relaxed GPU-scope accesses suffice: an aligned 64-bit
// access is single-copy atomic, and no other memory needs ordering against
// it.  (An acquire load would also invalidate L1 on every poll, and a
// release store wait for the thread's earlier accesses.)
__device__ __forceinline__ void publish_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t read_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The packed counts of every tile before `tile` (a whole warp).  Lane k
// reads the status of tile last - k (tiles before 0 count as an inclusive
// prefix of nothing); once none of the 32 is unpublished, the counts up to
// the newest inclusive prefix are added, or all 32 and the window steps
// back.
__device__ uint64_t look_back(const uint64_t* status, int64_t tile, int lane) {
  uint64_t excl = 0;
  for (int64_t last = tile - 1;; last -= 32) {
    const int64_t t = last - lane;
    uint64_t s;
    do {
      s = t >= 0 ? read_status(status + t) : kPrefix;
    } while (__any_sync(0xffffffffu, (s & kFlagMask) == 0));
    const unsigned found = __ballot_sync(0xffffffffu, (s & kFlagMask) == kPrefix);
    const int stop = found ? __ffs(found) - 1 : 31;
    uint64_t part = lane <= stop ? (s & ~kFlagMask) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    excl += part;
    if (found) return excl;
  }
}

__device__ __forceinline__ uint64_t pack(unsigned hot, unsigned cold) {
  return static_cast<uint64_t>(__popc(hot)) | (static_cast<uint64_t>(__popc(cold)) << kColdShift);
}

// A page's zero flag and checksum, from this lane's eight words.
struct PageSums {
  uint32_t any = 0, acc = 0;
  __device__ __forceinline__ void add(const uint4 x, const uint4* weights, int j, int lane) {
    any |= x.x | x.y | x.z | x.w;
    acc += aq::dot4(x, __ldg(weights + j * 32 + lane));
  }
  __device__ __forceinline__ void reduce() {
    any = aq::warp_or(any);
    acc = aq::warp_sum(acc);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
publish_kernel(const uint4* __restrict__ pages, const uint8_t* __restrict__ ws,
               const uint4* __restrict__ weights, int64_t n, int64_t tiles, int64_t cold_base,
               uint8_t* __restrict__ zero, uint32_t* __restrict__ csum, uint4* __restrict__ out,
               int32_t* __restrict__ counts, unsigned int* __restrict__ tile_counter,
               uint64_t* __restrict__ status) {
  extern __shared__ uint4 stage[];          // page 32 + w of the tile, warp w's slot
  __shared__ int64_t s_tile;
  __shared__ uint8_t s_cls[kTilePages];     // 0 zero or past the end, 1 hot, 2 cold
  __shared__ uint64_t s_base;               // packed counts of the tiles before
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4* slot = stage + warp * aq::kPageU4;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t pr = tile * kTilePages + warp;   // held in registers
  const int64_t ps = pr + kWarps;                // staged in shared memory
  const bool live_r = pr < n, live_s = ps < n;   // whole warp

  if (live_s) {
    const uint4* src = pages + ps * aq::kPageU4;
#pragma unroll
    for (int j = 0; j < kLoadsPerLane; ++j) {
      const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(slot + j * 32 + lane));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src + j * 32 + lane)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  uint4 v[kLoadsPerLane];
  PageSums r, s;
  uint8_t ws_r = 0, ws_s = 0;
  if (live_r) {
    const uint4* src = pages + pr * aq::kPageU4;
#pragma unroll
    for (int j = 0; j < kLoadsPerLane; ++j) v[j] = aq::load_stream(src + j * 32 + lane);
    ws_r = ws[pr];
  }
  if (live_s) ws_s = ws[ps];
  if (live_r) {
#pragma unroll
    for (int j = 0; j < kLoadsPerLane; ++j) r.add(v[j], weights, j, lane);
    r.reduce();
  }
  if (live_s) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // this lane's own words
#pragma unroll
    for (int j = 0; j < kLoadsPerLane; ++j) s.add(slot[j * 32 + lane], weights, j, lane);
    s.reduce();
  }
  if (lane == 0) {
    if (live_r) {
      zero[pr] = r.any == 0;
      csum[pr] = r.acc;
    }
    if (live_s) {
      zero[ps] = s.any == 0;
      csum[ps] = s.acc;
    }
    s_cls[warp] = r.any == 0 ? 0 : (ws_r ? 1 : 2);
    s_cls[kWarps + warp] = s.any == 0 ? 0 : (ws_s ? 1 : 2);
  }
  __syncthreads();

  // lane k holds the classes of pages k and 32 + k: ranks in page order
  const uint8_t c_lo = s_cls[lane], c_hi = s_cls[kWarps + lane];
  const unsigned hot_lo = __ballot_sync(0xffffffffu, c_lo == 1);
  const unsigned cold_lo = __ballot_sync(0xffffffffu, c_lo == 2);
  const unsigned hot_hi = __ballot_sync(0xffffffffu, c_hi == 1);
  const unsigned cold_hi = __ballot_sync(0xffffffffu, c_hi == 2);
  if (warp == 0) {
    const uint64_t agg = pack(hot_lo, cold_lo) + pack(hot_hi, cold_hi);
    uint64_t excl = 0;
    if (tile > 0) {
      if (lane == 0) publish_status(status + tile, kAggregate | agg);
      excl = look_back(status, tile, lane);
    }
    if (lane == 0) {
      publish_status(status + tile, kPrefix | (excl + agg));
      s_base = excl;
      if (tile == tiles - 1) {
        counts[0] = static_cast<int32_t>((excl + agg) & kCountMask);
        counts[1] = static_cast<int32_t>(((excl + agg) >> kColdShift) & kCountMask);
      }
    }
  }
  __syncthreads();

  // a page is stored when its class is hot or cold: live and non-zero
  const int64_t hot_row = static_cast<int64_t>(s_base & kCountMask);
  const int64_t cold_row = cold_base + static_cast<int64_t>((s_base >> kColdShift) & kCountMask);
  const unsigned below = (1u << warp) - 1;
  if (((hot_lo | cold_lo) >> warp) & 1) {
    const int64_t row = (hot_lo >> warp) & 1 ? hot_row + __popc(hot_lo & below)
                                              : cold_row + __popc(cold_lo & below);
    uint4* dst = out + row * aq::kPageU4;
#pragma unroll
    for (int j = 0; j < kLoadsPerLane; ++j) aq::store_stream(dst + j * 32 + lane, v[j]);
  }
  if (((hot_hi | cold_hi) >> warp) & 1) {
    const int64_t row = (hot_hi >> warp) & 1
                            ? hot_row + __popc(hot_lo) + __popc(hot_hi & below)
                            : cold_row + __popc(cold_lo) + __popc(cold_hi & below);
    uint4* dst = out + row * aq::kPageU4;
#pragma unroll
    for (int j = 0; j < kLoadsPerLane; ++j)
      aq::store_stream(dst + j * 32 + lane, slot[j * 32 + lane]);
  }
}

}  // namespace

extern "C" int aq_publish_tile_pages() { return kTilePages; }

// pages: n * 4096 bytes, 16-byte aligned; ws: uint8[n] (0/1); weights:
// uint32[1024]; cold_base: the number of working-set pages; outputs zero:
// uint8[n], csum: uint32[n], out: (n, 4096) bytes (hot rows from 0, cold
// rows from cold_base), counts: int32[2] = [n_hot, n_cold]; scratch:
// uint64[1 + ceil(n / tile_pages)] (tile counter, then a status word a
// tile), zeroed here.  tile_pages must equal the kernel's tile.
extern "C" int aq_fused_publish(const void* pages, const void* ws, const void* weights, int64_t n,
                                int64_t cold_base, int tile_pages, void* zero, void* csum,
                                void* out, void* counts, void* scratch, void* stream) {
  if (tile_pages != kTilePages || n < 0 || n > static_cast<int64_t>(kCountMask))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      publish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + kTilePages - 1) / kTilePages;
  uint64_t* words = static_cast<uint64_t*>(scratch);
  err = cudaMemsetAsync(words, 0, (1 + tiles) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  publish_kernel<<<static_cast<unsigned int>(tiles), kThreads, kStageBytes, s>>>(
      static_cast<const uint4*>(pages), static_cast<const uint8_t*>(ws),
      static_cast<const uint4*>(weights), n, tiles, cold_base, static_cast<uint8_t*>(zero),
      static_cast<uint32_t*>(csum), static_cast<uint4*>(out), static_cast<int32_t*>(counts),
      reinterpret_cast<unsigned int*>(words), words + 1);
  return static_cast<int>(cudaGetLastError());
}
