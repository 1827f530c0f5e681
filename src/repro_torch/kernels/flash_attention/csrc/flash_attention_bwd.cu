// The backward of grouped-query flash attention for Hopper (sm_90a), bound to
// Python with ctypes.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// `flash_attention_pallas` has no backward: the JAX package differentiates
// its reference attention.  This is the backward of the port's forward
// kernels (csrc/flash_attention.cu, csrc/flash_attention_sm90.cu), which
// write each row's float32 log-sum-exp `lse` when training.  The algorithm is
// FlashAttention-2's: the probabilities are recomputed tile by tile from q, k
// and lse, so no (Sq, Skv) matrix is ever held.  With S = q k^T * scale,
//   P  = exp(S - lse)            (0 where the mask drops a key)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// and the query heads of a GQA group add into their KV head's dK and dV.  Q
// and K have Dk columns, V, O and dO Dv (they differ for MLA: Dk = 192,
// Dv = 128 at DeepSeek-V3's width), so dQ and dK are Dk wide and dV is Dv
// wide; each is at most 256.  The
// mask is the forward's: causal suffix-aligned (key j is kept for query i when
// j <= i + Skv - Sq), keys past Skv and rows past Sq dropped.
//
// Three kernels, launched in order by one entry point:
// 1. delta: D = rowsum(dO * O) in float32, a warp a row.
// 2. dK/dV: a block per (key tile, batch * KV head).  It loops over the query
//    heads of its group and over the query tiles that the causal mask lets
//    see its keys, and keeps its tile's dK and dV in float32 registers; each
//    output element is written once.
// 3. dQ: a block per (query tile, batch * query head), looping over the key
//    tiles its rows see (the longest causal tiles first), dQ in registers.
// No float atomics: every sum runs in a fixed order, so two launches on the
// same inputs give the same bits.  The price is that kernel 3 recomputes S and
// dP, which kernel 2 also computes: 7 tile products where 5 would do.
//
// Bound: 5 products per (query, key) pair the mask keeps, of 2 * Dk
// operations (S, dQ, dK) or 2 * Dv (dP, dV).  At the dense training shape
// (B = 1, Hq = 24, Hkv = 8, S = 4096, Dk = Dv = 128, causal, bf16) that is
// 10 * 128 * 24 * 4096 * 4097 / 2 = 258 GFLOP, 0.26 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 5 x 25 MB of q, k, v, O, dO read and 50 MB
// of dq, dk, dv written (0.04 ms at 3.35 TB/s): bound by operations.  At
// MLA's (B = 1, Hq = Hkv = 128, S = 2048, Dk = 192, Dv = 128, causal, bf16):
// (6 * 192 + 4 * 128) * 128 * 2048 * 2049 / 2 = 447 GFLOP, 0.45 ms.
//
// Design (simple and right first, not fast).  Float32 FMAs on the CUDA cores
// for both dtypes: bf16 inputs are upcast as they are staged.  256 threads a
// block as a 16 x 16 grid.  Tiles are staged in shared memory as float32,
// d-major ([d][row], rows padded by one float so that a thread column walking
// d and a thread row walking rows hit distinct banks); each thread owns a
// (rows/16) x (cols/16) piece of a score tile, strided by 16, and a
// (rows/16) x (Dk/16 or Dv/16) piece of its block's gradients.  The score
// loops run over the columns both widths share, then over the wider one's
// rest.  Tiles of 64 keys and 64 queries up to Dk, Dv <= 128 (167 KB of shared
// memory at 128, one block an SM) and for MLA's Dk <= 192, Dv <= 128 (196 KB),
// 32 up to 256.  wgmma, TMA and a ring of tiles are the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // contiguous (B, Hq, Sq, Dv)
  const void* dout;  // (B, Hq, Sq, Dv), strided
  const float* lse;  // contiguous (B, Hq, Sq)
  float* delta;      // contiguous (B, Hq, Sq) scratch
  void* dq_out;      // contiguous (B, Hq, Sq, Dk)
  void* dk_out;      // contiguous (B, Hkv, Skv, Dk)
  void* dv_out;      // contiguous (B, Hkv, Skv, Dv)
  int64_t hq, hkv, sq, skv, dk, dv;
  int64_t q_sb, q_sh, q_ss;  // element strides of dims 0..2 (dim 3 is contiguous)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t g_sb, g_sh, g_ss;  // dout's
  float scale;
  int causal;
};

// ---------------------------------------------------------------- 1. delta

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args a, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t i = row % a.sq, bh = row / a.sq;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const T* o = static_cast<const T*>(a.o) + row * a.dv;
  const T* g = static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sh + i * a.g_ss;
  float s = 0.f;
  for (int64_t c = lane; c < a.dv; c += 32) s = fmaf(to_f32(o[c]), to_f32(g[c]), s);
#pragma unroll
  for (int w = 16; w; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) a.delta[row] = s;
}

// Rows [r0, r0 + ROWS) of a (rows, d) tile with element stride `ss` between
// rows into `dst` as float32, d-major with row length `ld`; zeros past `n`
// rows and past `d` columns (up to DMAX).
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void stage_t(float* dst, int ld, const T* src, int64_t ss, int64_t r0,
                                        int64_t n, int d) {
  for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    const bool in = r0 + r < n && c < d;
    dst[c * ld + r] = in ? to_f32(src[(r0 + r) * ss + c]) : 0.f;
  }
}

// ---------------------------------------------------------------- 2. dK, dV

template <int BK, int BQ, int DK, int DV>
constexpr size_t dkdv_smem_floats() {
  return (DK + DV) * (BK + 1) + (DK + DV) * (BQ + 1) + 2 * BK * (BQ + 1) + 2 * BQ;
}

template <typename T, int BK, int BQ, int DK, int DV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  constexpr int RK = BK / 16, RQ = BQ / 16, RCK = DK / 16, RCV = DV / 16;
  constexpr int LK = BK + 1, LQ = BQ + 1;
  extern __shared__ float smem[];
  float* sKt = smem;                 // [DK][LK]
  float* sVt = sKt + DK * LK;        // [DV][LK]
  float* sQt = sVt + DV * LK;        // [DK][LQ]
  float* sGt = sQt + DK * LQ;        // dO, [DV][LQ]
  float* sP = sGt + DV * LQ;         // [BK][LQ]
  float* sS = sP + BK * LQ;          // dS, [BK][LQ]
  float* sL = sS + BK * LQ;          // lse of the tile's rows
  float* sD = sL + BQ;               // delta of the tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int dk = static_cast<int>(a.dk), dv = static_cast<int>(a.dv);
  const int dmin = dk < dv ? dk : dv;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.hkv, hk = bh % a.hkv;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BK;  // the long causal tiles first
  const int64_t group = a.hq / a.hkv;
  const int64_t off = a.skv - a.sq;
  int64_t q_first = 0;  // the first query tile that sees key k0
  if (a.causal && k0 - off > 0) q_first = (k0 - off) / BQ * BQ;

  stage_t<T, BK, DK>(sKt, LK, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_ss,
                     k0, a.skv, dk);
  stage_t<T, BK, DV>(sVt, LK, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_ss,
                     k0, a.skv, dv);

  float gk[RK][RCK], gv[RK][RCV];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int c = 0; c < RCK; ++c) gk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < RCV; ++c) gv[i][c] = 0.f;
  }

  for (int64_t g = 0; g < group; ++g) {
    const int64_t h = hk * group + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* gp = static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sh;
    const int64_t row_base = (b * a.hq + h) * a.sq;
    for (int64_t q0 = q_first; q0 < a.sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_t<T, BQ, DK>(sQt, LQ, qp, a.q_ss, q0, a.sq, dk);
      stage_t<T, BQ, DV>(sGt, LQ, gp, a.g_ss, q0, a.sq, dv);
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = q0 + r < a.sq;
        sL[r] = in ? a.lse[row_base + q0 + r] : 0.f;
        sD[r] = in ? a.delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T (over Dk) and dP^T (over Dv): keys ty + 16 i, queries tx + 16 j
      float s[RK][RQ], dp[RK][RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < dmin; ++c) {
        float kr[RK], vr[RK], qr[RQ], gr[RQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kr[i] = sKt[c * LK + ty + 16 * i];
          vr[i] = sVt[c * LK + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          qr[j] = sQt[c * LQ + tx + 16 * j];
          gr[j] = sGt[c * LQ + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < RQ; ++j) {
            s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], gr[j], dp[i][j]);
          }
      }
      for (int c = dmin; c < dk; ++c) {  // Dk's columns past Dv
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float kr = sKt[c * LK + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < RQ; ++j) s[i][j] = fmaf(kr, sQt[c * LQ + tx + 16 * j], s[i][j]);
        }
      }
      for (int c = dmin; c < dv; ++c) {  // Dv's columns past Dk
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float vr = sVt[c * LK + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < RQ; ++j) dp[i][j] = fmaf(vr, sGt[c * LQ + tx + 16 * j], dp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int64_t key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int qi = tx + 16 * j;
          const int64_t row = q0 + qi;
          const bool keep = key < a.skv && row < a.sq && (!a.causal || key <= row + off);
          const float p = keep ? expf(s[i][j] * a.scale - sL[qi]) : 0.f;
          sP[(ty + 16 * i) * LQ + qi] = p;
          sS[(ty + 16 * i) * LQ + qi] = p * (dp[i][j] - sD[qi]);
        }
      }
      __syncthreads();

      // dV += P^T dO (Dv columns), dK += dS^T Q (Dk columns): keys ty + 16 i,
      // columns tx + 16 c
#pragma unroll 2
      for (int qi = 0; qi < BQ; ++qi) {
        float pr[RK], sr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = sP[(ty + 16 * i) * LQ + qi];
          sr[i] = sS[(ty + 16 * i) * LQ + qi];
        }
#pragma unroll
        for (int c = 0; c < RCV; ++c) {
          const float gval = sGt[(tx + 16 * c) * LQ + qi];
#pragma unroll
          for (int i = 0; i < RK; ++i) gv[i][c] = fmaf(pr[i], gval, gv[i][c]);
        }
#pragma unroll
        for (int c = 0; c < RCK; ++c) {
          const float qval = sQt[(tx + 16 * c) * LQ + qi];
#pragma unroll
          for (int i = 0; i < RK; ++i) gk[i][c] = fmaf(sr[i], qval, gk[i][c]);
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk_out) + bh * a.skv * a.dk;
  T* dvp = static_cast<T*>(a.dv_out) + bh * a.skv * a.dv;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int64_t key = k0 + ty + 16 * i;
    if (key >= a.skv) continue;
#pragma unroll
    for (int c = 0; c < RCK; ++c) {
      const int col = tx + 16 * c;
      if (col < dk) dkp[key * a.dk + col] = from_f32<T>(gk[i][c] * a.scale);
    }
#pragma unroll
    for (int c = 0; c < RCV; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) dvp[key * a.dv + col] = from_f32<T>(gv[i][c]);
    }
  }
}

// ---------------------------------------------------------------- 3. dQ

template <int BQ, int BK, int DK, int DV>
constexpr size_t dq_smem_floats() {
  return (DK + DV) * (BQ + 1) + (DK + DV) * (BK + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int BQ, int BK, int DK, int DV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RC = DK / 16;
  constexpr int LQ = BQ + 1, LK = BK + 1;
  extern __shared__ float smem[];
  float* sQt = smem;                 // [DK][LQ]
  float* sGt = sQt + DK * LQ;        // dO, [DV][LQ]
  float* sKt = sGt + DV * LQ;        // [DK][LK]
  float* sVt = sKt + DK * LK;        // [DV][LK]
  float* sS = sVt + DV * LK;         // dS, [BQ][LK]
  float* sL = sS + BQ * LK;
  float* sD = sL + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int dk = static_cast<int>(a.dk), dv = static_cast<int>(a.dv);
  const int dmin = dk < dv ? dk : dv;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t hk = h / (a.hq / a.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;  // long tiles first
  const int64_t off = a.skv - a.sq;
  const int64_t last_row = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  const int64_t kend = a.causal && last_row + off + 1 < a.skv ? last_row + off + 1 : a.skv;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int64_t row_base = bh * a.sq;

  stage_t<T, BQ, DK>(sQt, LQ, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                     a.sq, dk);
  stage_t<T, BQ, DV>(sGt, LQ, static_cast<const T*>(a.dout) + b * a.g_sb + h * a.g_sh, a.g_ss,
                     q0, a.sq, dv);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool in = q0 + r < a.sq;
    sL[r] = in ? a.lse[row_base + q0 + r] : 0.f;
    sD[r] = in ? a.delta[row_base + q0 + r] : 0.f;
  }

  float acc[RQ][RC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;

  for (int64_t k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO staged)
    stage_t<T, BK, DK>(sKt, LK, kp, a.k_ss, k0, a.skv, dk);
    stage_t<T, BK, DV>(sVt, LK, vp, a.v_ss, k0, a.skv, dv);
    __syncthreads();

    // S (over Dk) and dP (over Dv): queries ty + 16 i, keys tx + 16 j
    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < dmin; ++c) {
      float qr[RQ], gr[RQ], kr[RK], vr[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qr[i] = sQt[c * LQ + ty + 16 * i];
        gr[i] = sGt[c * LQ + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kr[j] = sKt[c * LK + tx + 16 * j];
        vr[j] = sVt[c * LK + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
          dp[i][j] = fmaf(gr[i], vr[j], dp[i][j]);
        }
    }
    for (int c = dmin; c < dk; ++c) {  // Dk's columns past Dv
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qr = sQt[c * LQ + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qr, sKt[c * LK + tx + 16 * j], s[i][j]);
      }
    }
    for (int c = dmin; c < dv; ++c) {  // Dv's columns past Dk
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float gr = sGt[c * LQ + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RK; ++j) dp[i][j] = fmaf(gr, sVt[c * LK + tx + 16 * j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = ty + 16 * i;
      const int64_t row = q0 + qi;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int64_t key = k0 + tx + 16 * j;
        const bool keep = key < a.skv && row < a.sq && (!a.causal || key <= row + off);
        const float p = keep ? expf(s[i][j] * a.scale - sL[qi]) : 0.f;
        sS[qi * LK + tx + 16 * j] = p * (dp[i][j] - sD[qi]);
      }
    }
    __syncthreads();

    // dQ += dS K (Dk columns): queries ty + 16 i, columns tx + 16 c
#pragma unroll 2
    for (int kj = 0; kj < BK; ++kj) {
      float sr[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sr[i] = sS[(ty + 16 * i) * LK + kj];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float kval = sKt[(tx + 16 * c) * LK + kj];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(sr[i], kval, acc[i][c]);
      }
    }
  }

  T* dqp = static_cast<T*>(a.dq_out) + bh * a.sq * a.dk;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + 16 * c;
      if (col < dk) dqp[row * a.dk + col] = from_f32<T>(acc[i][c] * a.scale);
    }
  }
}

// ------------------------------------------------------------------- host

template <typename T, int BT, int DK, int DV>
int launch(const Args& a, int64_t b, cudaStream_t stream) {
  const int64_t rows = b * a.hq * a.sq;
  const int64_t row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  delta_kernel<T><<<static_cast<unsigned int>(row_blocks), kThreads, 0, stream>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv = dkdv_smem_floats<BT, BT, DK, DV>() * sizeof(float);
  err = cudaFuncSetAttribute(dkdv_kernel<T, BT, BT, DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned int>((a.skv + BT - 1) / BT),
                     static_cast<unsigned int>(b * a.hkv));
  dkdv_kernel<T, BT, BT, DK, DV><<<grid_kv, kThreads, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = dq_smem_floats<BT, BT, DK, DV>() * sizeof(float);
  err = cudaFuncSetAttribute(dq_kernel<T, BT, BT, DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned int>((a.sq + BT - 1) / BT),
                    static_cast<unsigned int>(b * a.hq));
  dq_kernel<T, BT, BT, DK, DV><<<grid_q, kThreads, smem_q, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int64_t b, cudaStream_t stream) {
  if (a.dk <= 64 && a.dv <= 64) return launch<T, 64, 64, 64>(a, b, stream);
  if (a.dk <= 128 && a.dv <= 128) return launch<T, 64, 128, 128>(a, b, stream);
  if (a.dk <= 192 && a.dv <= 128) return launch<T, 64, 192, 128>(a, b, stream);  // MLA
  return launch<T, 32, 256, 256>(a, b, stream);
}

}  // namespace

extern "C" const char* aq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, Sq, Dk), k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv), dout (B, Hq,
// Sq, Dv): element strides (sb, sh, ss) of dims 0..2, dim 3 contiguous; o: the
// forward's output (B, Hq, Sq, Dv), contiguous; lse: its float32 log-sum-exp
// (B, Hq, Sq), contiguous; delta: float32 (B, Hq, Sq) scratch; dq, dk, dv:
// contiguous outputs.  dtype 0 = float32, 1 = bfloat16 (every tensor but lse
// and delta).  Requires 1 <= dk, dv <= 256, skv >= 1, hq % hkv == 0,
// b * hq < 65536 and sq <= skv when causal (the wrapper checks).  Returns the first CUDA error.
extern "C" int aq_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* delta, void* dq,
                                      void* dk_out, void* dv_out, int64_t b, int64_t hq,
                                      int64_t hkv, int64_t sq, int64_t skv, int64_t dk, int64_t dv,
                                      int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                      int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                      int64_t v_ss, int64_t g_sb, int64_t g_sh, int64_t g_ss,
                                      float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (dk < 1 || dk > 256 || dv < 1 || dv > 256 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      b * hq >= 65536 || (causal && sq > skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk_out, dv_out, hq, hkv, sq, skv, dk, dv,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb, g_sh, g_ss,
               scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, b, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
