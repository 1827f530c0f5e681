// Flash attention for Hopper (sm_90a) on the tensor cores: TMA loads into a
// two-stage shared-memory ring, wgmma products, warp-specialised roles.
// Bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// `flash_attention_pallas` (body `_flash_kernel`, kernel.py:34) for the calls
// that `ops.route` sends here: bf16 q, k, v with Dk == Dv in {64, 128}, base
// pointers and the strides of dims 0..2 16-byte aligned, dim 3 contiguous.
// It computes what that kernel computes: scores (q . k) * scale in float32,
// the scale applied after the product; online softmax with the finite mask
// value -1e30; the causal mask suffix-aligned (key j is kept for query i when
// j <= i + Skv - Sq); query head h reads KV head h / (Hq / Hkv); l == 0 -> 1;
// the output rounded to bf16 to nearest even.  The softmax runs in base 2 on
// the scores times scale * log2(e) (one MUFU.EX2 an element instead of
// expf's range reduction); exp(s - m) = 2^(s log2e - m log2e), and the mask
// value -1e30 stands in those units.
//
// Bound: 2 * (Dk + Dv) operations per (query, key) pair.  At the Phi-4-mini
// prefill shape (B = 1, Hq = 24, Hkv = 8, S = 8192, D = 128, causal) that is
// 412 GFLOP, 0.42 ms at the 989 TFLOP/s bf16 tensor-core peak, against 134 MB
// (0.04 ms at 3.35 TB/s): bound by operations.
//
// Numerics.  The TPU kernel multiplies P by V with P in float32.  Rounding P
// to bf16 for the tensor cores (as FlashAttention does), or to TF32, misses
// one bf16 rounding of the float32 result, the limit the kernel is held to
// (tests/test_torch_flash_attention.py shows both).  So P is split,
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both products go into one
// float32 accumulator: P_hi + P_lo holds P to about 2^-17, V is bf16 and
// exact, and the products are exact in float32.  That costs 1.5x the
// tensor-core work of bf16 P.  The row sums l are taken from the float32 P.
//
// Design.  One block of three warpgroups per (128-query tile, batch * head),
// the longest causal tiles first:
// - warpgroup 0, the producer, gives its registers away (setmaxnreg) and one
//   thread issues TMA loads: the Q tile once, then K and V tiles of 128 keys
//   into a two-stage ring with full and empty mbarriers.  The tensor maps are
//   4-D views (D, S, H, B) over the caller's strides, so the model's
//   transposed (B, S, H, D) projections load without a copy; TMA zero-fills
//   rows past Sq and Skv.  Tiles wholly above the causal diagonal are never
//   loaded.
// - warpgroups 1 and 2, the consumers, own 64 query rows each.  Per key
//   tile: S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//   (K's [keys, D] tile is the K-major B operand); scale, mask (keys past
//   Skv, and the causal diagonal, only on tiles that need it) and the online
//   base-2 softmax in registers on the accumulator layout, the row max and sum
//   reduced over the four threads of a quad; O rescaled by alpha in float32;
//   then O += P_hi V + P_lo V by wgmma with P from registers (the S
//   accumulator fragment of 16 keys is the A fragment of one k16 step) and
//   V's [keys, Dv] tile as the MN-major (transposed) B operand.
// - Shared memory holds bf16 tiles of 128 rows x 64 columns, 128-byte
//   swizzled as TMA writes them and wgmma reads them: Q 128 x D, K and V two
//   stages each, 160 KB at D = 128, one block an SM.
// - Epilogue: O / l rounded to bf16, rows < Sq stored as 4-byte pairs;
//   given an `lse` pointer (training), each row's log-sum-exp
//   m ln2 + log(l) in natural units, float32, for csrc/flash_attention_bwd.cu.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int kBN = 128;           // keys per tile
constexpr int kBox = 64;           // bf16 columns of one 128-byte swizzled box
constexpr int kStages = 2;         // K and V ring depth
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBoxBytes = kBM * kBox * 2;  // 16 KB: one [128 rows][64 cols] bf16 box

// Error codes beyond CUDA's own, for aq_error_string.
constexpr int kErrNoEncode = 100000;  // cuTensorMapEncodeTiled not reachable
constexpr int kErrEncode = 100001;    // + CUresult: a tensor map was refused

template <int D>
struct __align__(1024) Smem {
  __nv_bfloat16 q[D / kBox][kBM * kBox];
  __nv_bfloat16 k[kStages][D / kBox][kBN * kBox];
  __nv_bfloat16 v[kStages][D / kBox][kBN * kBox];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

struct Params {
  __nv_bfloat16* o;  // contiguous (B, Hq, Sq, D)
  float* lse;        // contiguous (B, Hq, Sq), or null
  int hq, group, sq, skv;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait of more
// than 2^36 cycles (~40 s) traps, so a pipeline fault ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 36)) __trap();
  } while (!done);
}

// One 64 x 128 box of a 4-D tensor map at (c0, c1, c2, c3), completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile whose
// 1024-byte swizzle atoms start 1024-aligned: start address, leading and
// stride byte offsets in 16-byte units, layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that an asynchronous wgmma reads or writes: no access is
// moved across the point where this stands.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ----------------------------------------------- wgmma (bf16 in, float32 accumulator)

// d (m64 x n128, float32) {+}= A (m64 x k16, shared, K-major) * B (k16 x n128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (m64 x n128, float32) += A (m64 x k16, registers) * B (k16 x n128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64 x n64, float32) += A (m64 x k16, registers) * B (k16 x n64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, desc_v);
  } else {
    wgmma_rs_n64(o, a, desc_v);
  }
}

// hi = bf16(x), lo = bf16(x - hi) for two adjacent keys, packed as the A
// fragment holds them (the lower key in the low half).  x - hi is exact.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x in one MUFU.EX2 (relative error about 2^-22, far below the 2^-17 to
// which P_hi + P_lo holds P)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator layout of a wgmma m64nN float32 result, for thread `lane` of
// warp w of the warpgroup: register i holds row 16w + lane/4 + 8*((i/2)%2)
// and column 8*(i/4) + 2*(lane%4) + i%2.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kChunks = D / kBox;
  constexpr uint32_t kTileBytes = kChunks * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms start 1024-aligned
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + pad);

  const int bh = blockIdx.y;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest causal tiles first
  const int off = p.skv - p.sq;
  const int kend = p.causal ? min(q0 + kBM, p.sq) + off : p.skv;  // keys this tile's rows see
  const int n_tiles = (kend + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 2);  // one arrival per consumer warpgroup
      mbar_init(&sm.v_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) tma_load(sm.q[c], &tm_q, &sm.q_full, c * kBox, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        mbar_wait(&sm.k_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(sm.k[s][c], &tm_k, &sm.k_full[s], c * kBox, t * kBN, hk, b);
        mbar_wait(&sm.v_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(sm.v[s][c], &tm_v, &sm.v_full[s], c * kBox, t * kBN, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int lane = tid % 32;
    const int first_row = q0 + cw * 64;
    const int r0 = first_row + (tid / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
    const int r1 = r0 + 8;
    const int col = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(sm.q[0]) + cw * 64 * 128;  // 64 rows of 128 bytes a box

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // row max in log2 units, row sum
    const float scale_log2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
    mbar_wait(&sm.q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kBN;

      // S = Q K^T: k16 steps along D; a step inside a 128-byte row moves the
      // start address by 32 bytes, the next 64 columns are the next box
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      mbar_wait(&sm.k_full[s], ph);
      const uint32_t k_addr = smem_u32(sm.k[s][0]);
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_addr + step, 16, 1024), sw128_desc(k_addr + step, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      if (tid == 0) mbar_arrive(&sm.k_empty[s]);

      // scale (in log2 units: exp(s - m) = 2^(s log2e - m log2e)), mask,
      // online softmax
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (k0 + kBN > p.skv || (p.causal && k0 + kBN - 1 > first_row + off)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + (i / 4) * 8 + col + (i % 2);
          const int last = ((i / 2) % 2 ? r1 : r0) + off;  // last key the row sees when causal
          if (key >= p.skv || (p.causal && key > last)) sc[i] = kNegInf;
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if ((i / 2) % 2) {
          mx1 = fmaxf(mx1, sc[i]);
        } else {
          mx0 = fmaxf(mx0, sc[i]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if ((i / 2) % 2) {
          sc[i] = exp2_approx(sc[i] - mn1);
          sum1 += sc[i];
        } else {
          sc[i] = exp2_approx(sc[i] - mn0);
          sum0 += sc[i];
        }
      }
      l0 = a0 * l0 + quad_sum(sum0);
      l1 = a1 * l1 + quad_sum(sum1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i / 2) % 2 ? a1 : a0;

      // P = P_hi + P_lo; the 8 registers of 16 keys are one k16 A fragment
      uint32_t phi[kBN / 16][4], plo[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_pair(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], phi[kk][j], plo[kk][j]);

      // O += P_hi V + P_lo V: k16 steps along the keys are 16 rows = 2 KB
      mbar_wait(&sm.v_full[s], ph);
      const uint32_t v_addr = smem_u32(sm.v[s][0]);
      pin(o);
      pin(phi);
      pin(plo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t desc = sw128_desc(v_addr + kk * 16 * 128, kBoxBytes, 1024);
        wgmma_pv<D>(o, phi[kk], desc);
        wgmma_pv<D>(o, plo[kk], desc);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(phi);
      pin(plo);
      if (tid == 0) mbar_arrive(&sm.v_empty[s]);
    }

    // epilogue: O / l in bf16, rows < Sq; the log-sum-exp when asked, from
    // the row max in log2 units: m ln2 + log(l)
    const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
    __nv_bfloat16* out = p.o + static_cast<int64_t>(bh) * p.sq * D;
    if (p.lse != nullptr && lane % 4 == 0) {
      float* lse = p.lse + static_cast<int64_t>(bh) * p.sq;
      if (r0 < p.sq) lse[r0] = m0 * 0.6931471805599453f + logf(l0);
      if (r1 < p.sq) lse[r1] = m1 * 0.6931471805599453f + logf(l1);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + col;
      if (r0 < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r0) * D + c) =
            __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (r1 < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r1) * D + c) =
            __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library needs no -lcuda.
EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor viewed as (D, S, H, B) with element strides ss, sh, sb of S,
// H and B (D contiguous), read in boxes of 64 columns x 128 rows, 128-byte
// swizzled; rows past S read as zeros.
int make_map(CUtensorMap* map, const void* base, int64_t d, int64_t s, int64_t h, int64_t b,
             int64_t ss, int64_t sh, int64_t sb) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, kBN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int64_t b, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((p.sq + kBM - 1) / kBM),
                  static_cast<unsigned int>(b * p.hq));
  flash_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* aq_error_string(int code) {
  if (code == kErrNoEncode) return "cuTensorMapEncodeTiled is not reachable from the runtime";
  if (code >= kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is code - 100001)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all bf16, with element strides
// (sb, sh, ss) of dims 0..2 that are multiples of 8 and dim 3 contiguous,
// bases 16-byte aligned; o: a contiguous (B, Hq, Sq, D) bf16 output; lse:
// null, or a contiguous float32 (B, Hq, Sq) output of the rows' log-sum-exp.
// Requires D in {64, 128}, Skv >= 1, Hq % Hkv == 0, B * Hq < 65536 and
// Sq <= Skv when causal (ops.route and the wrapper check).  Returns the CUDA
// error, or kErrNoEncode / kErrEncode + CUresult.
extern "C" int aq_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int64_t b, int64_t hq, int64_t hkv, int64_t sq,
                                       int64_t skv, int64_t d, int64_t q_sb, int64_t q_sh,
                                       int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                       int64_t v_sb, int64_t v_sh, int64_t v_ss, float scale,
                                       int causal, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if ((d != 64 && d != 128) || skv <= 0 || hkv <= 0 || hq % hkv != 0 || b * hq >= 65536 ||
      sq >= (1 << 30) || skv >= (1 << 30) || (causal && sq > skv))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, d, sq, hq, b, q_ss, q_sh, q_sb);
  if (rc == 0) rc = make_map(&tk, k, d, skv, hkv, b, k_ss, k_sh, k_sb);
  if (rc == 0) rc = make_map(&tv, v, d, skv, hkv, b, v_ss, v_sh, v_sb);
  if (rc != 0) return rc;
  const Params p{static_cast<__nv_bfloat16*>(o), lse, static_cast<int>(hq),
                 static_cast<int>(hq / hkv), static_cast<int>(sq), static_cast<int>(skv), scale,
                 causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(tq, tk, tv, p, b, s) : launch<128>(tq, tk, tv, p, b, s);
}
