// Blocked online-softmax (flash) attention with GQA for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// `flash_attention_pallas` (body `_flash_kernel`, kernel.py:34).  It computes
// what that kernel computes: q (B, Hq, Sq, Dk), k (B, Hkv, Skv, Dk),
// v (B, Hkv, Skv, Dv) -> o (B, Hq, Sq, Dv) in q's dtype; q, k and v upcast to
// float32 and the scores, softmax and sums kept in float32; query head h reads
// KV head h / (Hq / Hkv); causal masking suffix-aligned (key j is kept for
// query i when j <= i + Skv - Sq); the finite mask value -1e30; l == 0 -> 1 at
// the end.  Dk and Dv may differ (MLA), each at most 256.
//
// Bound: 2 * B * Hq * Dk * (keys each query sees) multiply-adds for the
// scores and as many with Dv for the sums, plus the inputs read once and the
// output written once.  At the Phi-4-mini prefill shape (B = 1, Hq = 24,
// Hkv = 8, S = 8192, D = 128, causal, bf16) that is 4*24*128*8192*8193/2 =
// 412 GFLOP against 134 MB: 0.42 ms at the 989 TFLOP/s bf16 tensor-core peak
// and 0.04 ms at 3.35 TB/s, so it is bound by operations.
//
// Design (simple and right first, not fast).  The TPU grid's sequential kv
// axis becomes a loop inside the block: one block of 128 threads per (64-query
// tile, batch * head), walking 64-key tiles up to the last one the tile's
// causal diagonal reaches (tiles wholly above it are never loaded).  The query
// tile and each key tile are staged in shared memory as float32, transposed
// (d-major) so that a thread reads four query rows or four keys with one
// 16-byte load.  Each thread owns 4 query rows x 8 keys of the score tile and
// 4 rows x Dv/8 columns of the float32 accumulator in registers; the 8 threads
// of a row group hold one row's running max and sum and reduce them with warp
// shuffles.  K and V share one shared buffer (V is loaded after the scores),
// so two blocks fit on an SM at D = 128.  The products run on the CUDA cores
// in float32, which is what the float32 semantics ask for but leaves the
// tensor cores idle: wgmma, TMA and warp specialisation are the redesign.
// Ragged Sq and Skv are masked here (rows past Sq load zeros and are not
// written; keys past Skv score -1e30 and load zero values).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kLd = kBQ + 4;       // row length of the transposed tiles (kBQ == kBK)
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

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
  void* o;
  int64_t hq, hkv, sq, skv, dk, dv;
  int64_t q_sb, q_sh, q_ss;  // element strides of dims 0..2 (dim 3 is contiguous)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  float scale;
  int causal;
};

__device__ __forceinline__ float group_max(float x) {  // over the 8 lanes of a row group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Shared memory (floats): sQt [dk][kLd] | sKV: max(dk * kLd, kBK * DVMAX) | sPt [kBK][kLd].
template <int DVMAX>
size_t smem_bytes(int64_t dk) {
  const int64_t kv = dk * kLd > kBK * DVMAX ? dk * kLd : kBK * DVMAX;
  return static_cast<size_t>(dk * kLd + kv + kBK * kLd) * sizeof(float);
}

// DVMAX: Dv rounded up to 64, 128 or 256; the accumulator holds 4 x DVMAX/8
// floats per thread, and the columns past Dv stay zero.
template <typename T, int DVMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int kCols = DVMAX / 32;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);
  float* sKV = sQt + a.dk * kLd;
  const int64_t kv_floats = a.dk * kLd > kBK * DVMAX ? a.dk * kLd : kBK * DVMAX;
  float* sPt = sKV + kv_floats;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column lane
  const int ty = tid >> 3;  // row group: rows ty*4 .. ty*4+3
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t hk = h / (a.hq / a.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;  // long tiles first
  const int64_t kv_offset = a.skv - a.sq;
  const int64_t diag_end = q0 + kBQ + kv_offset;  // one past the last key the tile's rows see
  const int64_t kend = a.causal && diag_end < a.skv ? diag_end : a.skv;
  const int n_tiles = static_cast<int>((kend + kBK - 1) / kBK);

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // Staging: warp w takes rows w, w+4, ...; its lanes take consecutive d of
  // a row (coalesced reads), stored d-major.
  const int lane = tid & 31, warp = tid >> 5;
  const int dk = static_cast<int>(a.dk), dv = static_cast<int>(a.dv);
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const bool in = q0 + r < a.sq;
    const T* src = q + (q0 + r) * a.q_ss;
    for (int d = lane; d < dk; d += 32) sQt[d * kLd + r] = in ? to_f32(src[d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols * 4; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = static_cast<int64_t>(t) * kBK;
    __syncthreads();  // the previous tile's readers are done with sKV and sPt
    for (int j = warp; j < kBK; j += kThreads / 32) {
      const bool in = k0 + j < a.skv;
      const T* src = k + (k0 + j) * a.k_ss;
      for (int d = lane; d < dk; d += 32) sKV[d * kLd + j] = in ? to_f32(src[d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, keys tx*4+j (j < 4) and 32+tx*4+(j-4)
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dk; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(sQt + d * kLd + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(sKV + d * kLd + tx * 4);
      const float4 kb = *reinterpret_cast<const float4*>(sKV + d * kLd + 32 + tx * 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }
    __syncthreads();  // everyone is done with K before V overwrites it

    for (int j = warp; j < kBK; j += kThreads / 32) {
      const bool in = k0 + j < a.skv;
      const T* src = v + (k0 + j) * a.v_ss;
      for (int c = lane; c < DVMAX; c += 32)
        sKV[j * DVMAX + c] = in && c < dv ? to_f32(src[c]) : 0.f;
    }

    // mask, online softmax, P (transposed) to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i + kv_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t key = k0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + (j - 4));
        const bool keep = key < a.skv && (!a.causal || key <= qpos);
        s[i][j] = keep ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = j < 4 ? tx * 4 + j : 32 + tx * 4 + (j - 4);
      *reinterpret_cast<float4*>(sPt + key * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V: columns tx*4 + 32*c .. +3
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(sPt + j * kLd + ty * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vb = *reinterpret_cast<const float4*>(sKV + j * DVMAX + c * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c * 4 + 0] = fmaf(pr[i], vb.x, acc[i][c * 4 + 0]);
          acc[i][c * 4 + 1] = fmaf(pr[i], vb.y, acc[i][c * 4 + 1]);
          acc[i][c * 4 + 2] = fmaf(pr[i], vb.z, acc[i][c * 4 + 2]);
          acc[i][c * 4 + 3] = fmaf(pr[i], vb.w, acc[i][c * 4 + 3]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o) + (bh * a.sq) * a.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= a.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 32 + tx * 4 + e;
        if (col < dv) o[row * dv + col] = from_f32<T>(acc[i][c * 4 + e] / li);
      }
  }
}

template <typename T, int DVMAX>
int launch(const Args& a, int64_t b, cudaStream_t stream) {
  const size_t smem = smem_bytes<DVMAX>(a.dk);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DVMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((a.sq + kBQ - 1) / kBQ),
                  static_cast<unsigned int>(b * a.hq));
  flash_kernel<T, DVMAX><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dv(const Args& a, int64_t b, cudaStream_t stream) {
  if (a.dv <= 64) return launch<T, 64>(a, b, stream);
  if (a.dv <= 128) return launch<T, 128>(a, b, stream);
  return launch<T, 256>(a, b, stream);
}

}  // namespace

extern "C" const char* aq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: element strides (sb, sh, ss) of dims 0..2, dim 3 contiguous; o: a
// contiguous (b, hq, sq, dv) output.  dtype 0 = float32, 1 = bfloat16 (all
// four tensors).  Requires 1 <= dk, dv <= 256, hq % hkv == 0, b * hq < 65536,
// and sq <= skv when causal (the wrapper checks).  Returns the CUDA error.
extern "C" int aq_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int64_t b, int64_t hq, int64_t hkv, int64_t sq, int64_t skv,
                                  int64_t dk, int64_t dv, int64_t q_sb, int64_t q_sh,
                                  int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                  int64_t v_sb, int64_t v_sh, int64_t v_ss, float scale,
                                  int causal, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (dk < 1 || dk > 256 || dv < 1 || dv > 256 || hkv <= 0 || hq % hkv != 0 ||
      b * hq >= 65536 || (causal && sq > skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, hq, hkv, sq, skv, dk, dv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
               v_sb, v_sh, v_ss, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dv<float>(a, b, s);
  if (dtype == 1) return dispatch_dv<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
