// RG-LRU backward for Hopper (sm_90a): the gradients of K7's scan.
//
// Replaces the reference's analytic reverse scan _rglru_bwd
// (src/repro/kernels/rglru/ops.py:54-86), the backward of rglru_pallas
// (src/repro/kernels/rglru/kernel.py:58).  Per channel, in f32, from the
// cotangents dh (B, T, D) and dh_last (B, D) of (h, h_final):
//
//   lam_t = dh_t + a_{t+1} * lam_{t+1},  lam_{T-1} = dh_{T-1} + dh_last
//   dg_t = lam_t,  dlog_a_t = lam_t * h_{t-1} * a_t,  dh0 = a_0 * lam_0
//
// with a_t = exp(log_a_t) and h_{t-1} read from the forward's saved h (in
// g's dtype, so rounded to bf16 in the model, as the reference's
// residuals), h_{-1} = h0 (or 0).  The reference runs the reverse scan as
// an associative scan; this kernel takes the layout of rglru.cu: one
// thread per (b, channel) walks the tokens backwards, neighbouring threads
// on neighbouring channels, so every load and store of a warp is one
// coalesced row.  The loads do not depend on the chain: each thread keeps
// two register buffers of U tokens of log_a, dh and h_{t-1}, and issues the
// next (earlier) batch's loads before it steps through this one.  The steps
// are rglru.cuh's, each operation rounded on its own, so rglru_bwd_sm90.cu
// (the TMA design, which ops.py routes long calls to) gives the same bits.
// No atomics: the result is deterministic.
//
// What bounds it.  Bytes: log_a f32, h and dh in g's type read once, dg
// written in g's type, dlog_a in f32, h0, dh_last and dh0 f32 (at
// recurrentgemma-9b's training shape, B 1, T 4096, D 4096, bf16: 235 MB,
// 0.070 ms at 3.35 TB/s); the work, one exp and three multiplies an
// element, is far below.
#include "rglru.cuh"

namespace {

constexpr int NTHREADS = 64;    // channels a block
constexpr int U = 16;           // tokens a batch of loads

// the loads of the U tokens [t0, t0 + U) of one channel: log_a, dh and
// h_{t-1} (h0v before token 0)
template <typename T>
__device__ __forceinline__ void load(const float* __restrict__ log_a,
                                     const T* __restrict__ h,
                                     const T* __restrict__ dh, int64_t base,
                                     int t0, int64_t D, float h0v,
                                     float (&la)[U], float (&dd)[U],
                                     float (&hp)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t off = base + int64_t(t0 + u) * D;
    la[u] = log_a[off];
    dd[u] = to_f32(dh[off]);
    hp[u] = t0 + u > 0 ? to_f32(h[off - D]) : h0v;
  }
}

// the U dependent steps of a loaded batch, last token first; returns the
// carry a_t * lam_t of the batch's first token
template <typename T>
__device__ __forceinline__ float step(const float (&la)[U],
                                      const float (&dd)[U],
                                      const float (&hp)[U], float carry,
                                      T* __restrict__ dg,
                                      float* __restrict__ dla, int64_t base,
                                      int t0, int64_t D) {
#pragma unroll
  for (int u = U - 1; u >= 0; --u) {
    const int64_t off = base + int64_t(t0 + u) * D;
    const float lam = bwd_lam(dd[u], carry);
    const float a = expf(la[u]);
    dg[off] = from_f32<T>(lam);
    dla[off] = bwd_dlog_a(lam, hp[u], a);
    carry = bwd_carry(a, lam);
  }
  return carry;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
rglru_bwd_kernel(const float* __restrict__ log_a, const T* __restrict__ h,
                 const float* __restrict__ h0, const T* __restrict__ dh,
                 const float* __restrict__ dh_last, float* __restrict__ dla,
                 T* __restrict__ dg, float* __restrict__ dh0, int n_tok,
                 int D) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= D) return;
  const int64_t base = int64_t(b) * n_tok * D + c;   // token 0, channel c
  const int64_t dd = D;
  const float h0v = h0 != nullptr ? h0[int64_t(b) * D + c] : 0.f;
  float carry = dh_last != nullptr ? dh_last[int64_t(b) * D + c] : 0.f;
  // whole batches from the end, two register buffers: the next (earlier)
  // batch's loads are in flight while this one's steps run; the first
  // n_tok % U tokens follow one at a time
  const int nb = n_tok / U;
  const int head = n_tok - nb * U;
  float la0[U], d0[U], p0[U], la1[U], d1[U], p1[U];
  if (nb > 0) load(log_a, h, dh, base, n_tok - U, dd, h0v, la0, d0, p0);
  for (int k = 0; k < nb; k += 2) {
    const int t0 = n_tok - (k + 1) * U;
    if (k + 1 < nb) load(log_a, h, dh, base, t0 - U, dd, h0v, la1, d1, p1);
    carry = step(la0, d0, p0, carry, dg, dla, base, t0, dd);
    if (k + 1 == nb) break;
    if (k + 2 < nb)
      load(log_a, h, dh, base, t0 - 2 * U, dd, h0v, la0, d0, p0);
    carry = step(la1, d1, p1, carry, dg, dla, base, t0 - U, dd);
  }
  for (int t = head - 1; t >= 0; --t) {
    const int64_t off = base + int64_t(t) * dd;
    const float lam = bwd_lam(to_f32(dh[off]), carry);
    const float a = expf(log_a[off]);
    const float hp = t > 0 ? to_f32(h[off - dd]) : h0v;
    dg[off] = from_f32<T>(lam);
    dla[off] = bwd_dlog_a(lam, hp, a);
    carry = bwd_carry(a, lam);
  }
  if (dh0 != nullptr) dh0[int64_t(b) * D + c] = carry;
}

template <typename T>
cudaError_t run(const void* log_a, const void* h, const void* h0,
                const void* dh, const void* dh_last, void* dla, void* dg,
                void* dh0, int B, int n_tok, int D, cudaStream_t stream) {
  dim3 grid((D + NTHREADS - 1) / NTHREADS, B);
  rglru_bwd_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const float*>(log_a), static_cast<const T*>(h),
      static_cast<const float*>(h0), static_cast<const T*>(dh),
      static_cast<const float*>(dh_last), static_cast<float*>(dla),
      static_cast<T*>(dg), static_cast<float*>(dh0), n_tok, D);
  return cudaGetLastError();
}

}  // namespace

// log_a, dlog_a: (B, T, D) f32; h, dh, dg: (B, T, D) of dtype (0 =
// float32, 1 = bfloat16); h0, dh_last, dh0: (B, D) f32 or null (h0 and
// dh_last zeros; dh0 not written); all contiguous.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int rglru_bwd(const void* log_a, const void* h, const void* h0,
                         const void* dh, const void* dh_last, void* dlog_a,
                         void* dg, void* dh0, int B, int T, int D, int dtype,
                         void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(run<float>(log_a, h, h0, dh, dh_last, dlog_a, dg, dh0, B, T,
                            D, st));
    case 1:
      return int(run<__nv_bfloat16>(log_a, h, h0, dh, dh_last, dlog_a, dg,
                                    dh0, B, T, D, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rglru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
