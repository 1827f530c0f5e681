// Flash attention for Hopper (sm_90a) on the tensor cores: TMA loads into a
// two-stage shared-memory ring, wgmma products, warp-specialised roles.
// Bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// `flash_attention_pallas` (body `_flash_kernel`, kernel.py:34) for the calls
// that `ops.route` sends here: bf16 q, k, v with (Dk, Dv) one of (64, 64),
// (128, 128) and MLA's (192, 128), base pointers and the strides of dims 0..2
// 16-byte aligned, dim 3 contiguous.
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
// (0.04 ms at 3.35 TB/s): bound by operations.  At MLA's shape (B = 1,
// Hq = Hkv = 128, S = 4096, Dk = 192, Dv = 128, causal) 687 GFLOP, 0.695 ms;
// the kernel issues 2 Dk + 4 Dv = 896 operations a pair (the split P below),
// 962 GFLOP there.
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
// the longest causal tiles first within each head.  Blocks start in the
// order of their linear index, x fastest, and the tile index is blockIdx.x,
// so a wave holds few heads and their K and V tiles stay in L2:
// - warpgroup 0, the producer, gives its registers away (setmaxnreg) and one
//   thread issues TMA loads: the Q tile once, then K and V tiles of 128 keys
//   into a two-stage ring with full and empty mbarriers.  The tensor maps are
//   4-D views (D, S, H, B) over the caller's strides, so the model's
//   transposed (B, S, H, D) projections load without a copy; TMA zero-fills
//   rows past Sq and Skv.  Tiles wholly above the causal diagonal are never
//   loaded.
// - warpgroups 1 and 2, the consumers, own 64 query rows each.  Per key
//   tile: S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//   (K's [keys, Dk] tile is the K-major B operand); scale, mask (keys past
//   Skv, and the causal diagonal, only on tiles that need it) and the online
//   base-2 softmax in registers on the accumulator layout, the row max and sum
//   reduced over the four threads of a quad; O rescaled by alpha in float32;
//   then O += P_hi V + P_lo V by wgmma with P from registers (the S
//   accumulator fragment of 16 keys is the A fragment of one k16 step) and
//   V's [keys, Dv] tile as the MN-major (transposed) B operand.
// - Shared memory holds bf16 tiles of 128 rows x 64 columns, 128-byte
//   swizzled as TMA writes them and wgmma reads them: Q 128 x Dk, K (Dk wide)
//   and V (Dv wide) two stages each, 160 KB at D = 128 and 208 KB at (192,
//   128), one block an SM.  Dk only adds k16 steps to S = Q K^T: a consumer
//   thread holds O (Dv / 2 floats), S and P_hi / P_lo at every width.
// - Epilogue: O / l rounded to bf16, rows < Sq stored as 4-byte pairs;
//   given an `lse` pointer (training), each row's log-sum-exp
//   m ln2 + log(l) in natural units, float32, for the backward kernels.

#include "sm90_common.cuh"

namespace {

using namespace aq_sm90;

constexpr int kBM = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int kBN = 128;           // keys per tile
constexpr int kStages = 2;         // K and V ring depth
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBoxBytes = kBM * kBox * 2;  // 16 KB: one [128 rows][64 cols] bf16 box

template <int DK, int DV>
struct __align__(1024) Smem {
  __nv_bfloat16 q[DK / kBox][kBM * kBox];
  __nv_bfloat16 k[kStages][DK / kBox][kBN * kBox];
  __nv_bfloat16 v[kStages][DV / kBox][kBN * kBox];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

struct Params {
  __nv_bfloat16* o;  // contiguous (B, Hq, Sq, Dv)
  float* lse;        // contiguous (B, Hq, Sq), or null
  int hq, group, sq, skv;
  float scale;
  int causal;
};

// hi = bf16(x), lo = bf16(x - hi) for two adjacent keys, packed as the A
// fragment holds them (the lower key in the low half).  x - hi is exact.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator layout of a wgmma m64nN float32 result, for thread `lane` of
// warp w of the warpgroup: register i holds row 16w + lane/4 + 8*((i/2)%2)
// and column 8*(i/4) + 2*(lane%4) + i%2.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kKChunks = DK / kBox, kVChunks = DV / kBox;
  constexpr uint32_t kKTileBytes = kKChunks * kBoxBytes;  // a Q or K tile
  constexpr uint32_t kVTileBytes = kVChunks * kBoxBytes;  // a V tile
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms start 1024-aligned
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<DK, DV>& sm = *reinterpret_cast<Smem<DK, DV>*>(smem_raw + pad);

  const int bh = blockIdx.y, tile = gridDim.x - 1 - blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = tile * kBM;  // longest causal tiles first
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
      mbar_expect_tx(&sm.q_full, kKTileBytes);
#pragma unroll
      for (int c = 0; c < kKChunks; ++c) tma_load(sm.q[c], &tm_q, &sm.q_full, c * kBox, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        mbar_wait(&sm.k_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.k_full[s], kKTileBytes);
#pragma unroll
        for (int c = 0; c < kKChunks; ++c)
          tma_load(sm.k[s][c], &tm_k, &sm.k_full[s], c * kBox, t * kBN, hk, b);
        mbar_wait(&sm.v_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.v_full[s], kVTileBytes);
#pragma unroll
        for (int c = 0; c < kVChunks; ++c)
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

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // row max in log2 units, row sum
    const float scale_log2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
    mbar_wait(&sm.q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kBN;

      // S = Q K^T: k16 steps along Dk; a step inside a 128-byte row moves the
      // start address by 32 bytes, the next 64 columns are the next box
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      mbar_wait(&sm.k_full[s], ph);
      const uint32_t k_addr = smem_u32(sm.k[s][0]);
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
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
      for (int i = 0; i < DV / 2; ++i) o[i] *= (i / 2) % 2 ? a1 : a0;

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
        wgmma_rs<DV>(o, phi[kk], desc);
        wgmma_rs<DV>(o, plo[kk], desc);
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
    __nv_bfloat16* out = p.o + static_cast<int64_t>(bh) * p.sq * DV;
    if (p.lse != nullptr && lane % 4 == 0) {
      float* lse = p.lse + static_cast<int64_t>(bh) * p.sq;
      if (r0 < p.sq) lse[r0] = m0 * 0.6931471805599453f + logf(l0);
      if (r1 < p.sq) lse[r1] = m1 * 0.6931471805599453f + logf(l1);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int c = j * 8 + col;
      if (r0 < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r0) * DV + c) =
            __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (r1 < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r1) * DV + c) =
            __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// ------------------------------------------------------------------- host

template <int DK, int DV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int64_t b, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<DK, DV>) + 1024;  // + room to align the base to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int tiles = static_cast<unsigned int>((p.sq + kBM - 1) / kBM);
  const unsigned int heads = static_cast<unsigned int>(b * p.hq);
  const dim3 grid(tiles, heads);
  flash_sm90_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* aq_error_string(int code) { return aq_sm90::error_string(code); }

// q (B, Hq, Sq, Dk), k (B, Hkv, Skv, Dk) and v (B, Hkv, Skv, Dv), all bf16,
// with element strides (sb, sh, ss) of dims 0..2 that are multiples of 8 and
// dim 3 contiguous, bases 16-byte aligned; o: a contiguous (B, Hq, Sq, Dv)
// bf16 output; lse: null, or a contiguous float32 (B, Hq, Sq) output of the
// rows' log-sum-exp.  Requires (Dk, Dv) in {(64, 64), (128, 128), (192, 128)},
// Skv >= 1, Hq % Hkv == 0, B * Hq < 65536 and Sq <= Skv when causal
// (ops.route and the wrapper check).  Returns the CUDA error, or
// kErrNoEncode / kErrEncode + CUresult.
extern "C" int aq_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int64_t b, int64_t hq, int64_t hkv, int64_t sq,
                                       int64_t skv, int64_t dk, int64_t dv, int64_t q_sb,
                                       int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                       int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                       float scale, int causal, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  const bool widths = (dk == 64 && dv == 64) || (dk == 128 && dv == 128) ||
                      (dk == 192 && dv == 128);
  if (!widths || skv <= 0 || hkv <= 0 || hq % hkv != 0 || b * hq >= 65536 ||
      sq >= (1 << 30) || skv >= (1 << 30) || (causal && sq > skv))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, dk, sq, hq, b, q_ss, q_sh, q_sb, kBN);
  if (rc == 0) rc = make_map(&tk, k, dk, skv, hkv, b, k_ss, k_sh, k_sb, kBN);
  if (rc == 0) rc = make_map(&tv, v, dv, skv, hkv, b, v_ss, v_sh, v_sb, kBN);
  if (rc != 0) return rc;
  const Params p{static_cast<__nv_bfloat16*>(o), lse, static_cast<int>(hq),
                 static_cast<int>(hq / hkv), static_cast<int>(sq), static_cast<int>(skv), scale,
                 causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk == 64) return launch<64, 64>(tq, tk, tv, p, b, s);
  if (dk == 128) return launch<128, 128>(tq, tk, tv, p, b, s);
  return launch<192, 128>(tq, tk, tv, p, b, s);
}
