// The backward of grouped-query flash attention on Hopper's tensor cores
// (sm_90a): TMA loads into shared-memory rings, wgmma products,
// warp-specialised roles.  Bound to Python with ctypes.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// `flash_attention_pallas` has no backward: the JAX package differentiates
// its reference attention.  This is the backward of the port's forward
// kernels for the calls that `ops.bwd_route` sends here: bf16 q, k, v and
// dO with (Dk, Dv) one of (64, 64), (128, 128) and MLA's (192, 128), base
// pointers and the strides of dims 0..2 16-byte aligned, dim 3 contiguous.  Every other call takes
// csrc/flash_attention_bwd.cu (SIMT float32), which computes the same
// function.  With S = q k^T * scale,
//   P  = exp(S - lse)            (0 where the causal mask drops a key)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// and the query heads of a GQA group add into their KV head's dK and dV.  The
// mask is the forward's: causal suffix-aligned (key j is kept for query i when
// j <= i + Skv - Sq), rows past Sq dropped.
//
// Bound: 5 products per (query, key) pair the mask keeps, of 2 * Dk
// operations (S, dQ, dK) or 2 * Dv (dP, dV).  At the training shape (B = 1,
// Hq = 24, Hkv = 8, S = 4096, D = 128, causal) that is 10 * 128 * 24 * 4096
// * 4097 / 2 = 258 GFLOP, 0.2606 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against about 126 MB read and written (0.04 ms at 3.35 TB/s): bound by
// operations.  At MLA's (B = 1, Hq = Hkv = 128, S = 2048, Dk = 192, Dv = 128,
// causal) 447 GFLOP, 0.452 ms.
//
// What the design issues.  Two kernels and no float atomics, so two launches
// on the same inputs give the same bits: the dK/dV kernel computes S^T, dP^T,
// dV and dK (4 products), the dQ kernel S, dP again and dQ (3): 7 products
// where 5 would do.  Tiles on the causal diagonal are computed whole and
// masked; tiles wholly above it are skipped.  At the training shape that is
// 209.4 GFLOP in the dK/dV kernel and 157.0 in the dQ kernel, 366.4 GFLOP
// issued, 0.3705 ms at the peak (619 GFLOP at MLA's shape, counting the
// pairs the mask keeps).  FlashAttention-3 issues 5 and adds dQ across key
// tiles with float32 atomics, whose order changes from run to run; the
// two-kernel split buys determinism with the 2 extra products.
//
// Numerics.  Scores, softmax and every accumulator are float32; P and dS are
// rounded to bf16 for the dV, dK and dQ products, as FlashAttention-2 and -3
// do (tests/test_torch_flash_attention.py holds that rounding within the
// limit, 2^-6 max|want| + 1e-4 per gradient, against autograd through the
// float32 reference).  P is 2^(S * scale * log2(e) - lse * log2(e)) by one
// MUFU.EX2; lse comes from the forward in natural units and the prologue
// converts it once per row.
//
// Design.
// 1. prep_kernel (a warp a row): D = rowsum(dO * O) in float32 and
//    lse2 = lse * log2(e), into a float32 scratch whose rows are padded to a
//    multiple of 128 per (batch, head): padded rows get lse2 = +inf and D = 0,
//    so P is 0 there and rows past Sq add nothing, whatever the zero-filled
//    q and dO tiles give.
// 2. dkdv_kernel: a block per (128-key tile, batch * KV head), the first key
//    tiles (the ones most queries see) launched first.  TMA loads the K and V
//    tiles once, then for each query head of the group, in head order, and
//    each 64-query tile that the mask lets see the block's keys, the Q and dO
//    tiles and their rows of lse2 and D (bulk copies) into a ring with a
//    full mbarrier a slot: 64-query tiles two deep at Dk <= 128, 32-query
//    tiles four deep at Dk = 192 (below).  Each of the two warpgroups owns 64
//    keys: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (m64n32k16) with
//    both operands in shared memory (K-major); P^T and dS^T in registers on
//    the accumulator layout; then dV += P^T dO and dK += dS^T Q by wgmma with
//    A from registers (the accumulator fragment of 16 queries is the A
//    fragment of one k16 step) and the [queries, Dv] and [queries, Dk] tiles
//    of dO and Q as MN-major B operands (N = Dv, N = Dk: m64n192k16 at
//    MLA's width).  dK and dV stay in float32 registers for the whole block
//    and are written once, scaled and rounded to bf16.
// 3. dq_kernel: a block per (128-query tile, batch * query head), the longest
//    causal tiles first.  TMA loads the Q and dO tiles once and 64-key tiles
//    of K and V into a two-stage ring; each warpgroup owns 64 rows: S = Q K^T,
//    dP = dO V^T (m64n64k16, shared operands), dS in registers, dQ += dS K
//    with K's [keys, Dk] tile as the MN-major B operand.  dQ stays in
//    registers and is written once.
// Roles.  A block is the two computing warpgroups and nothing else.  Thread
// 0 fills both ring slots; afterwards the warpgroup that is second to be done
// with a slot refills it at once with the step two ahead (a counter a slot in
// shared memory says which is second), so no thread ever waits for the other
// warpgroup and each load has a whole step to land.  A producer warpgroup
// that gives its registers away (setmaxnreg), as the forward has, does not
// fit the dK/dV kernel: its threads hold dK and dV (128 registers) beside S^T
// and dP^T (64), and ptxas budgets every thread of a 384-thread block at 168
// registers whatever setmaxnreg says later, so that version spilled and
// serialised its wgmma; a 256-thread block may use 255, and this one spills
// nothing.  At Dk = 192 dK (96 floats) and dV (64) leave less room still: a
// 64-query stage would add S^T and dP^T at 32 registers each and the bf16
// P^T and dS^T fragments at 16 each, 256 live before an address; 32-query
// stages halve those, 208 (224 at D = 128; the dQ kernel, dQ 96 + S 32 +
// dP 32 + dS 16, keeps its 64-key tiles).  Blocks start in the order of
// their linear index, x fastest, so the tile index is blockIdx.y: the longest
// blocks start first across all heads (PERF.md).
// Tensor maps are 4-D views (D, S, H, B) over the caller's strides, read in
// boxes of 128-byte swizzled bf16 columns (sm90_common.cuh) as many rows as
// a dK/dV stage, so the model's transposed projections and autograd's dO
// load without a copy.  Shared memory: 129 KB (dK/dV) and 128 KB (dQ) at
// D = 128, 161 KB and 160 KB at (192, 128); one block an SM.

#include "sm90_common.cuh"

namespace {

using namespace aq_sm90;

constexpr int kThreads = 256;  // two consumer warpgroups; thread 0 also issues the loads
constexpr int kKeys = 128;     // dK/dV: keys per block
constexpr int kRows = 128;     // dQ: query rows per block
constexpr int kKTile = 64;     // dQ: keys per ring stage
constexpr int kStages = 2;     // dQ: ring depth
constexpr int kRowPad = 128;   // scratch rows per (batch, head) are a multiple of this
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV: queries per ring stage, and the ring's depth (the same bytes in
// flight at both widths); every TMA box is q_tile(Dk) rows
__host__ __device__ constexpr int q_tile(int dk) { return dk > 128 ? 32 : 64; }
__host__ __device__ constexpr int q_stages(int dk) { return dk > 128 ? 4 : 2; }

struct Params {
  const __nv_bfloat16* o;  // contiguous (B, Hq, Sq, Dv)
  const __nv_bfloat16* g;  // dO, element strides g_sb, g_sh, g_ss, dim 3 contiguous
  const float* lse;        // contiguous (B, Hq, Sq), natural units
  float* lse2;             // (B * Hq, sq_pad) scratch: lse * log2(e), +inf past Sq
  float* delta;            // (B * Hq, sq_pad) scratch: rowsum(dO * O), 0 past Sq
  __nv_bfloat16* dq;       // contiguous (B, Hq, Sq, Dk)
  __nv_bfloat16* dk;       // contiguous (B, Hkv, Skv, Dk)
  __nv_bfloat16* dv;       // contiguous (B, Hkv, Skv, Dv)
  int64_t g_sb, g_sh, g_ss;
  int hq, hkv, group, sq, skv, sq_pad, dv_width;
  float scale;
  int causal;
};

// Tiles are [rows][64 columns] boxes of bf16, one after another along Dk
// (q, k) or Dv (v, g: dO).
template <int DK, int DV>
struct __align__(1024) SmemKV {
  __nv_bfloat16 k[DK / kBox][kKeys * kBox];
  __nv_bfloat16 v[DV / kBox][kKeys * kBox];
  __nv_bfloat16 q[q_stages(DK)][DK / kBox][q_tile(DK) * kBox];
  __nv_bfloat16 g[q_stages(DK)][DV / kBox][q_tile(DK) * kBox];
  float lse2[q_stages(DK)][q_tile(DK)];
  float delta[q_stages(DK)][q_tile(DK)];
  uint64_t kv_full;
  uint64_t full[q_stages(DK)];
  int released[q_stages(DK)];  // warpgroups done with the slot's current tile
};

template <int DK, int DV>
struct __align__(1024) SmemQ {
  __nv_bfloat16 q[DK / kBox][kRows * kBox];
  __nv_bfloat16 g[DV / kBox][kRows * kBox];
  __nv_bfloat16 k[kStages][DK / kBox][kKTile * kBox];
  __nv_bfloat16 v[kStages][DV / kBox][kKTile * kBox];
  uint64_t qg_full;
  uint64_t full[kStages];
  int released[kStages];  // warpgroups done with the slot's current tile
};

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // x0 in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// `rows` rows of a [rows][W] tile at row r0 of (b, h): one box per BOX rows
// (the map's box) and 64 columns, completing on `bar`.
template <int W, int BOX>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int rows, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int h, int b) {
#pragma unroll
  for (int c = 0; c < W / kBox; ++c)
    for (int r = 0; r < rows; r += BOX)
      tma_load(dst + (c * rows + r) * kBox, map, bar, c * kBox, r0 + r, h, b);
}

template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* first, uint64_t* full, int* released) {
  mbar_init(first, 1);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&full[s], 1);
    released[s] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Called by one thread of each warpgroup once its warpgroup is done with
// slot s (its wgmma groups complete, every value read from the slot used):
// true for the second of the two, which then refills the slot.
__device__ __forceinline__ bool last_to_release(int* released, int s) {
  __threadfence_block();
  if (atomicAdd(&released[s], 1) == 0) return false;
  released[s] = 0;
  return true;
}

// -------------------------------------------------------------- 1. prologue

__global__ void __launch_bounds__(256) prep_kernel(const Params p, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t bh = row / p.sq_pad;
  const int i = static_cast<int>(row % p.sq_pad);
  if (i >= p.sq) {
    if (lane == 0) {
      p.lse2[row] = __int_as_float(0x7f800000);  // +inf: P = 2^(s - inf) = 0
      p.delta[row] = 0.f;
    }
    return;
  }
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const __nv_bfloat16* o = p.o + (bh * p.sq + i) * p.dv_width;
  const __nv_bfloat16* g = p.g + b * p.g_sb + h * p.g_sh + i * p.g_ss;
  float s = 0.f;
  for (int c = lane; c < p.dv_width; c += 32)
    s = fmaf(__bfloat162float(o[c]), __bfloat162float(g[c]), s);
#pragma unroll
  for (int w = 16; w; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    p.delta[row] = s;
    p.lse2[row] = p.lse[bh * p.sq + i] * kLog2e;
  }
}

// ---------------------------------------------------------------- 2. dK, dV

// Accumulator layout of a wgmma m64nN float32 result, for thread `lane` of
// warp w of the warpgroup: register i holds row 16w + lane/4 + 8*((i/2)%2)
// and column 8*(i/4) + 2*(lane%4) + i%2.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
            const Params p) {
  constexpr int kQTile = q_tile(DK), kQStages = q_stages(DK);
  constexpr uint32_t kKChunk = kKeys * kBox * 2;   // bytes between 64-column boxes of K, V
  constexpr uint32_t kQChunk = kQTile * kBox * 2;  // ... of a Q or dO tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  SmemKV<DK, DV>& sm = *reinterpret_cast<SmemKV<DK, DV>*>(smem_raw + pad);

  const int bh = blockIdx.x;  // batch * KV head
  const int b = bh / p.hkv, hk = bh % p.hkv;
  // blocks start in the order of their linear index, x fastest: the first
  // key tiles, which most queries see, start first
  const int k0 = blockIdx.y * kKeys;
  const int off = p.skv - p.sq;
  const int qt0 = p.causal ? max(0, k0 - off) / kQTile : 0;  // first query tile that sees k0
  const int per_head = (p.sq + kQTile - 1) / kQTile - qt0;
  const int n_steps = p.group * per_head;

  if (threadIdx.x == 0) init_ring<kQStages>(&sm.kv_full, sm.full, sm.released);
  __syncthreads();

  // Loads step u into slot u % kQStages: thread 0 the first kQStages steps,
  // then the warpgroup that releases step u - kQStages last.
  const auto issue = [&](int u) {
    const int s = u % kQStages;
    const int h = hk * p.group + u / per_head;
    const int q0 = (qt0 + u % per_head) * kQTile;
    mbar_expect_tx(&sm.full[s], (DK + DV) / kBox * kQChunk + 2 * kQTile * 4);
    load_tile<DK, kQTile>(sm.q[s][0], kQTile, &tm_q, &sm.full[s], q0, h, b);
    load_tile<DV, kQTile>(sm.g[s][0], kQTile, &tm_g, &sm.full[s], q0, h, b);
    const int64_t row = static_cast<int64_t>(b * p.hq + h) * p.sq_pad + q0;
    bulk_load(sm.lse2[s], p.lse2 + row, kQTile * 4, &sm.full[s]);
    bulk_load(sm.delta[s], p.delta + row, kQTile * 4, &sm.full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.kv_full, (DK + DV) / kBox * kKChunk);
    load_tile<DK, kQTile>(sm.k[0], kKeys, &tm_k, &sm.kv_full, k0, hk, b);
    load_tile<DV, kQTile>(sm.v[0], kKeys, &tm_v, &sm.kv_full, k0, hk, b);
    for (int u = 0; u < kQStages && u < n_steps; ++u) issue(u);
  }

  // two warpgroups of 64 keys each
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wg_key = k0 + cw * 64;                       // this warpgroup's first key
  const int key0 = wg_key + (tid / 32) * 16 + lane / 4;  // this thread's keys key0, key0 + 8
  const int key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  const uint32_t k_addr = smem_u32(sm.k[0]) + cw * 64 * 128;  // 64 rows of 128 bytes a box
  const uint32_t v_addr = smem_u32(sm.v[0]) + cw * 64 * 128;
  const float scale_log2 = p.scale * kLog2e;

  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
  mbar_wait(&sm.kv_full, 0);

  for (int t = 0; t < n_steps; ++t) {
    const int s = t % kQStages;
    const int q0 = (qt0 + t % per_head) * kQTile;
    mbar_wait(&sm.full[s], (t / kQStages) & 1);
    // a tile wholly above the diagonal for this warpgroup's keys adds nothing
    if (!p.causal || q0 + kQTile - 1 + p.skv - p.sq >= wg_key) {
      const uint32_t q_addr = smem_u32(sm.q[s][0]);
      const uint32_t g_addr = smem_u32(sm.g[s][0]);
      // K's and V's descriptors do not change from step to step; hidden
      // from the compiler, they are rebuilt each step (a few integer ops)
      // instead of holding 32 registers across the loop
      uint32_t ka = k_addr, va = v_addr;
      asm volatile("" : "+r"(ka), "+r"(va));

      // S^T = K Q^T along Dk, dP^T = V dO^T along Dv: k16 steps; a step
      // inside a 128-byte row moves the start address by 32 bytes, the next
      // 64 columns are the next box
      float st[kQTile / 2], dpt[kQTile / 2];
#pragma unroll
      for (int i = 0; i < kQTile / 2; ++i) st[i] = dpt[i] = 0.f;
      pin(st);
      pin(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss<kQTile>(st, sw128_desc(ka + (kk / 4) * kKChunk + (kk % 4) * 32, 16, 1024),
                         sw128_desc(q_addr + (kk / 4) * kQChunk + (kk % 4) * 32, 16, 1024),
                         kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<kQTile>(dpt, sw128_desc(va + (kk / 4) * kKChunk + (kk % 4) * 32, 16, 1024),
                         sw128_desc(g_addr + (kk / 4) * kQChunk + (kk % 4) * 32, 16, 1024),
                         kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      // P^T = 2^(S^T scale log2e - lse2), 0 where masked; dS^T = P^T (dP^T - D).
      // Rows (keys) past Skv are computed but never stored.
      const bool edge = p.causal && wg_key + 63 > q0 + p.skv - p.sq;
      uint32_t pf[kQTile / 16][4], sf[kQTile / 16][4];
#pragma unroll
      for (int i = 0; i < kQTile / 2; i += 2) {
        const int qi = 8 * (i / 4) + col;  // this pair's queries qi, qi + 1 of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[s][qi]);
        const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][qi]);
        float p0 = exp2_approx(st[i] * scale_log2 - l2.x);
        float p1 = exp2_approx(st[i + 1] * scale_log2 - l2.y);
        if (edge) {
          const int key = (i / 2) % 2 ? key1 : key0;
          const int last = q0 + qi + p.skv - p.sq;  // the last key query qi sees
          if (key > last) p0 = 0.f;
          if (key > last + 1) p1 = 0.f;
        }
        pf[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
        sf[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dpt[i] - dl.x), p1 * (dpt[i + 1] - dl.y));
      }

      // dV += P^T dO, dK += dS^T Q: k16 steps along the queries are 16 rows = 2 KB
      pin(dk);
      pin(dv);
      pin(pf);
      pin(sf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        wgmma_rs<DV>(dv, pf[kk], sw128_desc(g_addr + kk * 16 * 128, kQChunk, 1024));
        wgmma_rs<DK>(dk, sf[kk], sw128_desc(q_addr + kk * 16 * 128, kQChunk, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dk);
      pin(dv);
      pin(pf);
      pin(sf);
    }
    if (tid == 0 && last_to_release(sm.released, s) && t + kQStages < n_steps)
      issue(t + kQStages);
  }

  // epilogue: dK * scale and dV in bf16, keys < Skv, as 4-byte pairs
  __nv_bfloat16* dk_out = p.dk + static_cast<int64_t>(bh) * p.skv * DK;
  __nv_bfloat16* dv_out = p.dv + static_cast<int64_t>(bh) * p.skv * DV;
#pragma unroll
  for (int j = 0; j < DK / 8; ++j) {
    const int64_t c = j * 8 + col;
    if (key0 < p.skv)
      *reinterpret_cast<__nv_bfloat162*>(dk_out + static_cast<int64_t>(key0) * DK + c) =
          __floats2bfloat162_rn(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
    if (key1 < p.skv)
      *reinterpret_cast<__nv_bfloat162*>(dk_out + static_cast<int64_t>(key1) * DK + c) =
          __floats2bfloat162_rn(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
  }
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int64_t c = j * 8 + col;
    if (key0 < p.skv)
      *reinterpret_cast<__nv_bfloat162*>(dv_out + static_cast<int64_t>(key0) * DV + c) =
          __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
    if (key1 < p.skv)
      *reinterpret_cast<__nv_bfloat162*>(dv_out + static_cast<int64_t>(key1) * DV + c) =
          __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
  }
}

// -------------------------------------------------------------------- 3. dQ

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
          const Params p) {
  constexpr int kBoxRows = q_tile(DK);             // the maps' box
  constexpr uint32_t kQChunk = kRows * kBox * 2;   // bytes between 64-column boxes of Q, dO
  constexpr uint32_t kKChunk = kKTile * kBox * 2;  // ... of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  SmemQ<DK, DV>& sm = *reinterpret_cast<SmemQ<DK, DV>*>(smem_raw + pad);

  const int bh = blockIdx.x;  // batch * query head
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest causal tiles start first
  const int off = p.skv - p.sq;
  const int kend = p.causal ? min(q0 + kRows, p.sq) + off : p.skv;  // keys this tile's rows see
  const int n_tiles = (kend + kKTile - 1) / kKTile;

  if (threadIdx.x == 0) init_ring<kStages>(&sm.qg_full, sm.full, sm.released);
  __syncthreads();

  // Loads key tile u into slot u % kStages: thread 0 the first kStages
  // tiles, then the warpgroup that releases tile u - kStages last.
  const auto issue = [&](int u) {
    const int s = u % kStages;
    mbar_expect_tx(&sm.full[s], (DK + DV) / kBox * kKChunk);
    load_tile<DK, kBoxRows>(sm.k[s][0], kKTile, &tm_k, &sm.full[s], u * kKTile, hk, b);
    load_tile<DV, kBoxRows>(sm.v[s][0], kKTile, &tm_v, &sm.full[s], u * kKTile, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.qg_full, (DK + DV) / kBox * kQChunk);
    load_tile<DK, kBoxRows>(sm.q[0], kRows, &tm_q, &sm.qg_full, q0, h, b);
    load_tile<DV, kBoxRows>(sm.g[0], kRows, &tm_g, &sm.qg_full, q0, h, b);
    for (int u = 0; u < kStages && u < n_tiles; ++u) issue(u);
  }

  // two warpgroups of 64 query rows each
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wg_row = q0 + cw * 64;
  const int wg_last = min(wg_row + 63, p.sq - 1);
  const int r0 = wg_row + (tid / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
  const int r1 = r0 + 8;
  const int col = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sm.q[0]) + cw * 64 * 128;
  const uint32_t g_addr = smem_u32(sm.g[0]) + cw * 64 * 128;
  const float scale_log2 = p.scale * kLog2e;
  const int64_t srow = static_cast<int64_t>(bh) * p.sq_pad;  // r0, r1 < sq_pad
  const float l0 = p.lse2[srow + r0], l1 = p.lse2[srow + r1];
  const float d0 = p.delta[srow + r0], d1 = p.delta[srow + r1];

  float dq[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dq[i] = 0.f;
  mbar_wait(&sm.qg_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int kt0 = t * kKTile;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    // a tile no row of this warpgroup sees adds nothing
    if (!p.causal || kt0 <= wg_last + off) {
      const uint32_t k_addr = smem_u32(sm.k[s][0]);
      const uint32_t v_addr = smem_u32(sm.v[s][0]);

      // S = Q K^T along Dk, dP = dO V^T along Dv
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      pin(sc);
      pin(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(sc, sw128_desc(q_addr + (kk / 4) * kQChunk + (kk % 4) * 32, 16, 1024),
                     sw128_desc(k_addr + (kk / 4) * kKChunk + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n64(dp, sw128_desc(g_addr + (kk / 4) * kQChunk + (kk % 4) * 32, 16, 1024),
                     sw128_desc(v_addr + (kk / 4) * kKChunk + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      // P and dS = P (dP - D), 0 where masked (keys past Skv, the diagonal)
      const bool edge = kt0 + kKTile > p.skv || (p.causal && kt0 + kKTile - 1 > wg_row + off);
      uint32_t sf[kKTile / 16][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool lower = (i / 2) % 2;  // row r1
        const float l2 = lower ? l1 : l0, dl = lower ? d1 : d0;
        float p0 = exp2_approx(sc[i] * scale_log2 - l2);
        float p1 = exp2_approx(sc[i + 1] * scale_log2 - l2);
        if (edge) {
          const int key = kt0 + 8 * (i / 4) + col;  // this pair's keys key, key + 1
          const int last = p.causal ? (lower ? r1 : r0) + off : p.skv - 1;
          const int lim = min(last, p.skv - 1);   // the last key the row sees
          if (key > lim) p0 = 0.f;
          if (key + 1 > lim) p1 = 0.f;
        }
        sf[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dp[i] - dl), p1 * (dp[i + 1] - dl));
      }

      // dQ += dS K: k16 steps along the keys are 16 rows = 2 KB
      pin(dq);
      pin(sf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk)
        wgmma_rs<DK>(dq, sf[kk], sw128_desc(k_addr + kk * 16 * 128, kKChunk, 1024));
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      pin(sf);
    }
    if (tid == 0 && last_to_release(sm.released, s) && t + kStages < n_tiles)
      issue(t + kStages);
  }

  // epilogue: dQ * scale in bf16, rows < Sq
  __nv_bfloat16* out = p.dq + static_cast<int64_t>(bh) * p.sq * DK;
#pragma unroll
  for (int j = 0; j < DK / 8; ++j) {
    const int c = j * 8 + col;
    if (r0 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r0) * DK + c) =
          __floats2bfloat162_rn(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    if (r1 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r1) * DK + c) =
          __floats2bfloat162_rn(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
  }
}

// ------------------------------------------------------------------- host

struct Maps {
  CUtensorMap q, k, v, g;
};

template <int DK, int DV>
int launch(const Maps& m, const Params& p, int64_t b, cudaStream_t stream) {
  const int64_t rows = b * p.hq * p.sq_pad;
  prep_kernel<<<static_cast<unsigned int>((rows + 7) / 8), 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = sizeof(SmemKV<DK, DV>) + 1024;  // + room to align the base to 1024
  err = cudaFuncSetAttribute(dkdv_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned int>(b * p.hkv),
                     static_cast<unsigned int>((p.skv + kKeys - 1) / kKeys));
  dkdv_kernel<DK, DV><<<grid_kv, kThreads, smem_kv, stream>>>(m.q, m.k, m.v, m.g, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = sizeof(SmemQ<DK, DV>) + 1024;
  err = cudaFuncSetAttribute(dq_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned int>(b * p.hq),
                    static_cast<unsigned int>((p.sq + kRows - 1) / kRows));
  dq_kernel<DK, DV><<<grid_q, kThreads, smem_q, stream>>>(m.q, m.k, m.v, m.g, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* aq_error_string(int code) { return aq_sm90::error_string(code); }

// q (B, Hq, Sq, Dk), k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv) and dout
// (B, Hq, Sq, Dv), all bf16, with element strides (sb, sh, ss) of dims 0..2
// that are multiples of 8 and dim 3 contiguous, bases 16-byte aligned; o:
// the forward's output, contiguous bf16; lse: its float32 log-sum-exp (B, Hq,
// Sq), contiguous; aux: float32 scratch of 2 * B * Hq * Sq_pad elements,
// Sq_pad = Sq rounded up to a multiple of 128 (kernel.BWD_SM90_ROW_PAD),
// 16-byte aligned; dq, dk (Dk wide), dv (Dv wide): contiguous bf16 outputs.
// Requires (dim_k, dim_v) = (Dk, Dv) in {(64, 64), (128, 128), (192, 128)}, Skv >= 1,
// Hq % Hkv == 0, B * Hq < 65536, Sq and Skv at most 65535 tiles of 128, and
// Sq <= Skv when causal (ops.bwd_route and the wrapper check all but the tile
// counts).  Launches the prologue, the dK/dV kernel and the dQ kernel in
// order on `stream`.  Returns the first CUDA error, or kErrNoEncode /
// kErrEncode + CUresult.
extern "C" int aq_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* aux, void* dq, void* dk, void* dv, int64_t b, int64_t hq,
    int64_t hkv, int64_t sq, int64_t skv, int64_t dim_k, int64_t dim_v, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t g_sb, int64_t g_sh, int64_t g_ss, float scale, int causal,
    void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  const bool widths = (dim_k == 64 && dim_v == 64) || (dim_k == 128 && dim_v == 128) ||
                      (dim_k == 192 && dim_v == 128);
  if (!widths || skv <= 0 || hkv <= 0 || hq % hkv != 0 || b * hq >= 65536 ||
      sq > 65535 * kRows || skv > 65535 * kKeys || (causal && sq > skv))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  const int box = q_tile(static_cast<int>(dim_k));
  int rc = make_map(&m.q, q, dim_k, sq, hq, b, q_ss, q_sh, q_sb, box);
  if (rc == 0) rc = make_map(&m.k, k, dim_k, skv, hkv, b, k_ss, k_sh, k_sb, box);
  if (rc == 0) rc = make_map(&m.v, v, dim_v, skv, hkv, b, v_ss, v_sh, v_sb, box);
  if (rc == 0) rc = make_map(&m.g, dout, dim_v, sq, hq, b, g_ss, g_sh, g_sb, box);
  if (rc != 0) return rc;
  const int64_t sq_pad = (sq + kRowPad - 1) / kRowPad * kRowPad;
  const Params p{static_cast<const __nv_bfloat16*>(o),
                 static_cast<const __nv_bfloat16*>(dout),
                 lse,
                 aux,
                 aux + b * hq * sq_pad,
                 static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 g_sb,
                 g_sh,
                 g_ss,
                 static_cast<int>(hq),
                 static_cast<int>(hkv),
                 static_cast<int>(hq / hkv),
                 static_cast<int>(sq),
                 static_cast<int>(skv),
                 static_cast<int>(sq_pad),
                 static_cast<int>(dim_v),
                 scale,
                 causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim_k == 64) return launch<64, 64>(m, p, b, s);
  if (dim_k == 128) return launch<128, 128>(m, p, b, s);
  return launch<192, 128>(m, p, b, s);
}
