// RWKV-6 (Finch) time-mix recurrence for Hopper (sm_90a): K6.
//
// Replaces rwkv6_pallas (src/repro/kernels/rwkv6/kernel.py:86; body
// _rwkv6_kernel :38).  Per (batch, head), with the f32 state S (Dk x Dv):
//
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j],  w_t = exp(max(lw_t, -30))
//
// The Pallas kernel walks chunks of C tokens and forms the pairwise
// (C, C, D) decay tensor in VMEM (1 MiB at C = D = 64), which no SM's
// 228 KB of shared memory holds.  This kernel runs the recurrence of
// ref.py instead, which computes the same function without the blocks:
// one block per (b, h), one thread per value column j holding its column
// of S (D f32) in registers.  The block stages CT tokens at a time of r,
// k, v, w = exp(max(lw, -30)) and u * k through shared memory (coalesced
// row loads), synchronises once per stage, and each thread then steps
// through the stage's tokens reading the staged rows as broadcasts.  No
// atomics: the result is deterministic.  T = 1 (a decode step) is one
// stage of one token from the carried state.
//
// What bounds it.  Bytes: r/k/v and o in the compute type, lw in f32, s0
// and sT in f32, each read or written once (at rwkv6-7b's prefill, B 4,
// H 64, T 512, D 64, bf16: 109.1 MB, 0.0326 ms at 3.35 TB/s).  The work,
// 5 FLOP per state element per token, runs on CUDA cores in f32 (2.68
// GFLOP there, 0.040 ms at 67 TFLOP/s).  In practice the staged rows bound
// it: every thread reads r, k, w and u * k from shared memory for each
// state element it updates, 16 bytes an update against the 128 bytes a
// clock an SM delivers.  Four partial sums break the dot product's
// dependency chain.  Splitting a column over four threads (as many
// shared-memory reads) or giving each thread a 16 x 4 tile of S (a
// quarter of them) ran slower (PERF.md): with 256 blocks and 512
// dependent steps each, the per-token latency then dominates.  bf16
// calls of many tokens (prefill) run the chunked form on the tensor cores
// instead (rwkv6_sm90.cu, routed by ops.py); this file takes f32 inputs
// and short calls, a decode step's single token among them.
//
// Numerics: f32 throughout (expf, no fast math), as the reference; the
// sums run in another order than the chunked plain version.
#include "../../csrc/convert.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG_W_MIN = -30.0f;   // kernel.py:35
constexpr int CT = 16;                 // tokens staged per barrier

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ o, float* __restrict__ sT, int H, int n_tok) {
  __shared__ __align__(16) float r_s[CT][D];
  __shared__ __align__(16) float k_s[CT][D];
  __shared__ __align__(16) float w_s[CT][D];
  __shared__ __align__(16) float uk_s[CT][D];
  __shared__ float v_s[CT][D];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int64_t seq = int64_t(bh) * n_tok * D;      // (b, h) row of r/k/v/o
  const int64_t st = int64_t(bh) * D * D;           // (b, h) state
  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s0[st + i * D + j];
  const float uj = u[h * D + j];
  for (int t0 = 0; t0 < n_tok; t0 += CT) {
    const int n = min(CT, n_tok - t0);
    for (int t = 0; t < n; ++t) {
      const int64_t off = seq + int64_t(t0 + t) * D + j;
      const float kk = to_f32(k[off]);
      r_s[t][j] = to_f32(r[off]);
      k_s[t][j] = kk;
      v_s[t][j] = to_f32(v[off]);
      w_s[t][j] = expf(fmaxf(lw[off], LOG_W_MIN));
      uk_s[t][j] = uj * kk;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&r_s[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[t][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&w_s[t][i]);
        const float4 uk = *reinterpret_cast<const float4*>(&uk_s[t][i]);
        acc[0] = fmaf(rr.x, fmaf(uk.x, vj, S[i]), acc[0]);
        acc[1] = fmaf(rr.y, fmaf(uk.y, vj, S[i + 1]), acc[1]);
        acc[2] = fmaf(rr.z, fmaf(uk.z, vj, S[i + 2]), acc[2]);
        acc[3] = fmaf(rr.w, fmaf(uk.w, vj, S[i + 3]), acc[3]);
        S[i] = fmaf(ww.x, S[i], kk.x * vj);
        S[i + 1] = fmaf(ww.y, S[i + 1], kk.y * vj);
        S[i + 2] = fmaf(ww.z, S[i + 2], kk.z * vj);
        S[i + 3] = fmaf(ww.w, S[i + 3], kk.w * vj);
      }
      o[seq + int64_t(t0 + t) * D + j] =
          from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncthreads();      // the next stage overwrites the staged rows
  }
#pragma unroll
  for (int i = 0; i < D; ++i) sT[st + i * D + j] = S[i];
}

template <typename T, int D>
cudaError_t run(const void* r, const void* k, const void* v, const void* lw,
                const void* u, const void* s0, void* o, void* sT, int B,
                int H, int n_tok, cudaStream_t stream) {
  rwkv6_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(sT), H, n_tok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* s0, void* o,
                  void* sT, int B, int H, int n_tok, int D,
                  cudaStream_t stream) {
  switch (D) {
    case 16: return run<T, 16>(r, k, v, lw, u, s0, o, sT, B, H, n_tok, stream);
    case 32: return run<T, 32>(r, k, v, lw, u, s0, o, sT, B, H, n_tok, stream);
    case 64: return run<T, 64>(r, k, v, lw, u, s0, o, sT, B, H, n_tok, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v/o: (B, H, T, D) of dtype (0 = float32, 1 = bfloat16); lw: (B, H,
// T, D) f32; u: (H, D) f32; s0, sT: (B, H, D, D) f32; all contiguous.  D
// in {16, 32, 64}.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int rwkv6_fwd(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, const void* s0,
                         void* o, void* sT, int B, int H, int T, int D,
                         int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(run_d<float>(r, k, v, lw, u, s0, o, sT, B, H, T, D, st));
    case 1:
      return int(run_d<__nv_bfloat16>(r, k, v, lw, u, s0, o, sT, B, H, T, D,
                                      st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
