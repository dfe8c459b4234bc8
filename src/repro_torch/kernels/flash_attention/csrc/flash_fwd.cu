// Flash-attention forward for Hopper (sm_90a): GQA, causal or sliding
// window, online softmax, returns out and the f32 log-sum-exp.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:95, body _fa_kernel at :34).  Same function, not the same
// blocking: the TPU kernel walks the KV axis as a sequential grid dimension
// with its accumulators in VMEM scratch; here one block owns (b, q-head,
// tile of 64 queries) and walks the KV tiles in a loop, with the running
// max, sum and output accumulator in registers.
//
// What bounds it.  At the serving path's shape (B 4, Hq 32, Hkv 4,
// T = S = 512, D 128, causal, bf16) the work is about 8.6 GFLOP, 8.7 us at
// the card's 989 TFLOP/s bf16 tensor rate, and the bytes that must move
// (q, k, v read once, out and lse written once) are about 38 MB, 11 us at
// 3.35 TB/s: on the card's peaks the function is bound by memory.  This
// first version does its arithmetic on f32 FMAs, not tensor cores, so it is
// bound instead by FMA issue and shared-memory reads (the 67 TFLOP/s f32
// peak gives at least ~145 us for the ~9.7 GFLOP of its live tiles).
//
// What the design does about it.  The (T, S) score matrix never reaches
// device memory: a 64x64 score tile lives in registers (4x4 per thread) and
// its probabilities in shared memory for the P.V product.  Each K/V tile is
// read from device memory once per block and serves 64 queries.  KV tiles
// that the causal or window mask fully hides are never loaded, which halves
// the causal work.  mma/wgmma, TMA and pipelining come in later versions.
//
// Numerics follow the reference: q is scaled in f32 before Q.K^T, scores
// and softmax statistics are f32, masked scores are -1e30.  A row with no
// allowed key gets zeros and lse = -inf (the reference's answer there
// depends on its tile size).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per KV tile
constexpr int NTHREADS = 256;   // 16 x 16 threads, 4x4 score micro-tile each
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr size_t smem_bytes(int d) {
  // Q and K tiles with a padded row stride (d + 1: conflict-free column
  // reads), the V tile, and the probability tile with stride BK + 1
  return sizeof(float) *
         (size_t(BQ) * (d + 1) + size_t(BK) * (d + 1) + size_t(BK) * d +
          size_t(BQ) * (BK + 1));
}

// reduce over the 16 lanes that share one score row
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Hq, int Hkv, int Tq, int S,
                 float scale, int causal, int has_window, int window) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP, pre-scaled
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // score columns tx + 16 j, output cols tx + 16 c
  const int ty = tid >> 4;      // rows 4 ty .. 4 ty + 3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;    // bottom-right alignment

  const T* qb = q + (size_t(b) * Hq + h) * size_t(Tq) * D;
  const T* kb = k + (size_t(b) * Hkv + hk) * size_t(S) * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * size_t(S) * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < Tq) x = to_f32(qb[size_t(q0 + r) * D + c]) * scale;
    Qs[r * DP + c] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the keys any real query row of this block may see
  const int qpos_lo = q0 + offset;
  const int qpos_hi = min(q0 + BQ, Tq) - 1 + offset;
  int k_end = S;
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, qpos_lo - window + 1);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();            // last tile's K, V, P reads are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < S) {
        kx = to_f32(kb[size_t(k0 + r) * D + c]);
        vx = to_f32(vb[size_t(k0 + r) * D + c]);
      }
      Ks[r * DP + c] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + offset;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos) &&
                (!has_window || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + (size_t(b) * Hq + h) * size_t(Tq) * D;
  float* lb = lse + (size_t(b) * Hq + h) * size_t(Tq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_out(ob + size_t(r) * D + tx + 16 * c, any ? acc[i][c] / l[i] : 0.f);
    if (tx == 0) lb[r] = any ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Hq, int Hkv, int Tq, int S,
                   float scale, int causal, int has_window, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      Hq, Hkv, Tq, S, scale, causal, has_window, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Hq, int Hkv, int Tq,
                       int S, float scale, int causal, int has_window,
                       int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                           causal, has_window, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                           causal, has_window, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                            causal, has_window, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, Hq, T, D), k/v (B, Hkv, S, D),
// out (B, Hq, T, D), lse (B, Hq, T) f32, all contiguous.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Hq, int Hkv, int Tq,
                         int S, int D, float scale, int causal, int has_window,
                         int window, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Tq <= 0 || S < 0 || Hq % Hkv != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(D, q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                          causal, has_window, window, st);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, Hq, Hkv, Tq, S,
                                  scale, causal, has_window, window, st);
  else
    e = cudaErrorInvalidValue;
  return int(e);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
