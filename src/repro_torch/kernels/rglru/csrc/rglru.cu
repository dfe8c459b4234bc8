// RG-LRU diagonal recurrence for Hopper (sm_90a): K7 for calls below
// ops.SM90_MIN_T tokens (a decode step), and for widths TMA cannot
// address; longer calls (prefill) go to rglru_sm90.cu, which takes the
// same f32 steps.
//
// Replaces rglru_pallas (src/repro/kernels/rglru/kernel.py:58; body
// _rglru_kernel :29).  Per channel, in f32:
//
//   h_t = exp(log_a_t) * h_{t-1} + g_t,   h_0 = h0 (or 0)
//
// The Pallas kernel lays channels across lanes and computes each chunk of
// C tokens in closed form through a pairwise (C, C, bd) tensor in VMEM
// (64 x 64 x 512 x 4 B = 8 MiB a block), which no SM's 228 KB holds.  The
// recurrence is diagonal, so each channel is an independent scan: one
// thread per (b, channel) walks the tokens, neighbouring threads on
// neighbouring channels, so every load and store of a warp is one
// coalesced 128-byte (f32) or 64-byte (bf16) row.  The carried h stays in
// a register; the initial state enters in f32, as rglru_ref and the
// reference's XLA path take it (the Pallas kernel folds it into g's dtype:
// ROADMAP §3).  T = 1 from the carried state is a decode step.
//
// What bounds it.  Bytes: log_a f32 and g read once, h written once in
// g's type, h0 and h_final f32 (at recurrentgemma-9b's prefill, B 4,
// T 512, D 4096, bf16 g: 67.2 MB, 0.0201 ms at 3.35 TB/s); the work, one
// exp and one FMA per element, is far below.  At that shape there are
// only 16,384 channels, 4 warps an SM, and each thread's steps depend on
// the last, so a thread that loads one token at a time waits out the
// memory latency 512 times.  The loads do not depend on h: each thread
// keeps two register buffers of U = 32 tokens of log_a and g, and issues
// the next batch's loads before it steps through this one, so 32 to 64
// tokens' loads are in flight per thread at any time.  Blocks of 64
// threads spread a small batch over more SMs.  No atomics: the result is
// deterministic, and a run split at a batch boundary or anywhere else
// takes the same f32 steps as one shot.
#include "../../csrc/convert.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 64;    // channels a block
constexpr int U = 32;           // tokens a batch of loads

// issue the loads of U tokens starting at `off` (channel-strided)
template <typename T>
__device__ __forceinline__ void load(const float* __restrict__ log_a,
                                     const T* __restrict__ g, int64_t off,
                                     int64_t D, float (&la)[U],
                                     float (&gg)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    la[u] = log_a[off + u * D];
    gg[u] = to_f32(g[off + u * D]);
  }
}

// the U dependent steps of a loaded batch, h written as it goes
template <typename T>
__device__ __forceinline__ float step(const float (&la)[U],
                                      const float (&gg)[U], float hc,
                                      T* __restrict__ h, int64_t off,
                                      int64_t D) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    hc = fmaf(expf(la[u]), hc, gg[u]);
    h[off + u * D] = from_f32<T>(hc);
  }
  return hc;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
rglru_kernel(const float* __restrict__ log_a, const T* __restrict__ g,
             const float* __restrict__ h0, T* __restrict__ h,
             float* __restrict__ h_final, int n_tok, int D) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= D) return;
  const int64_t base = int64_t(b) * n_tok * D + c;   // token 0, channel c
  const int64_t dd = D;
  float hc = h0 != nullptr ? h0[int64_t(b) * D + c] : 0.f;
  // whole batches, two register buffers: the next batch's loads are in
  // flight while this one's steps run
  const int nb = n_tok / U;
  float la0[U], g0[U], la1[U], g1[U];
  if (nb > 0) load(log_a, g, base, dd, la0, g0);
  for (int k = 0; k < nb; k += 2) {
    const int64_t off = base + int64_t(k) * U * dd;
    if (k + 1 < nb) load(log_a, g, off + U * dd, dd, la1, g1);
    hc = step(la0, g0, hc, h, off, dd);
    if (k + 1 == nb) break;
    if (k + 2 < nb) load(log_a, g, off + 2 * U * dd, dd, la0, g0);
    hc = step(la1, g1, hc, h, off + U * dd, dd);
  }
  for (int t = nb * U; t < n_tok; ++t) {
    const int64_t off = base + int64_t(t) * dd;
    hc = fmaf(expf(log_a[off]), hc, to_f32(g[off]));
    h[off] = from_f32<T>(hc);
  }
  h_final[int64_t(b) * D + c] = hc;
}

template <typename T>
cudaError_t run(const void* log_a, const void* g, const void* h0, void* h,
                void* h_final, int B, int n_tok, int D, cudaStream_t stream) {
  dim3 grid((D + NTHREADS - 1) / NTHREADS, B);
  rglru_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const float*>(log_a), static_cast<const T*>(g),
      static_cast<const float*>(h0), static_cast<T*>(h),
      static_cast<float*>(h_final), n_tok, D);
  return cudaGetLastError();
}

}  // namespace

// log_a: (B, T, D) f32; g, h: (B, T, D) of dtype (0 = float32,
// 1 = bfloat16); h0: (B, D) f32 or null (zeros); h_final: (B, D) f32; all
// contiguous.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int rglru_fwd(const void* log_a, const void* g, const void* h0,
                         void* h, void* h_final, int B, int T, int D,
                         int dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(run<float>(log_a, g, h0, h, h_final, B, T, D, st));
    case 1:
      return int(run<__nv_bfloat16>(log_a, g, h0, h, h_final, B, T, D, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
