// RWKV-6 backward for Hopper (sm_90a): the gradients of K6's recurrence.
//
// Replaces the reference's _rwkv6_bwd (src/repro/kernels/rwkv6/ops.py:
// 90-96), the backward of rwkv6_pallas (kernel.py:86), which JAX runs as
// the vjp of the chunked XLA form _xla_chunked (ops.py:23-67).  Per
// (batch, head), with S_t the f32 state (Dk x Dv) after token t, S_{-1} =
// s0, w_t = exp(lw_t) (lw as given: the vjp of _xla_chunked has no clamp),
// and G_t the cotangent of S_t (G_{T-1} = dsT):
//
//   dr_t[i]  = sum_j S_{t-1}[i][j] do_t[j] + u[i] k_t[i] (v_t . do_t)
//   dk_t[i]  = sum_j G_t[i][j] v_t[j]      + r_t[i] u[i] (v_t . do_t)
//   dv_t[j]  = sum_i k_t[i] G_t[i][j]      + (sum_i r_t[i] u[i] k_t[i]) do_t[j]
//   dlw_t[i] = w_t[i] sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]    = sum over b and t of r_t[i] k_t[i] (v_t . do_t)
//   G_{t-1}  = diag(w_t) G_t + r_t^T do_t,   ds0 = G_{-1}
//
// dlw needs S_{t-1} and G_t together: S runs forwards, G backwards.  S_{t-1}
// is never recovered from S_t by dividing by w (exp(-30) and below
// underflow).  Instead one block per (b, h):
//   1. walks the tokens forwards and stores the state before each chunk of
//      C tokens into `bound` (B, H, T/C, D, D) f32;
//   2. walks the chunks backwards: it recomputes the chunk's states from its
//      bound, writing each S_{t-1} into its own window `win` (C, D, D) f32
//      in device memory (mostly served from L2) and dr_t beside it, then
//      steps the chunk's tokens backwards with G, reading S_{t-1} back.
// Each state row lives in the registers of NJ = 4 threads (D / 4 columns
// each); the sums over j reduce over those 4 lanes by shuffles in a fixed
// order.  The chunk's r, k, w, v and do sit in shared memory, read as
// broadcasts.  dv sums over i, across the rows: a second kernel walks the
// tokens backwards with G by columns (one thread per column j, as
// rwkv6.cu's forward holds S), so dv_t[j] is a sum in one thread.  du is
// written per (b, h) and summed over b in order by a third kernel.  No
// atomics anywhere: two runs are bit-equal.
//
// What bounds it.  The function moves r, k, v, do and dr, dk, dv in the
// compute type, lw and dlw in f32, s0, dsT and ds0 (B, H, D, D) f32: at
// rwkv6-7b's training shape (B 1, H 64, T 4096, D 64, bf16) 369 MB, 0.110
// ms at 3.35 TB/s.  Its arithmetic, the six D x D products of a token
// (recomputing S, dr, dk, dv, dlw, G), is 1.29e10 f32 FLOP, 0.193 ms at
// 67 TFLOP/s: bound by operations.  This first design runs on CUDA cores
// and writes and reads every S_{t-1} once (16 KB a token and head, 4.3 GB
// each way at that shape), which bounds it far above both.
#include "../../csrc/convert.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;     // tokens a chunk (boundary states, window)
constexpr int NJ = 4;     // threads a state row

// the n tokens from c0 of a (b, h) row of `src` into a (C, D) f32 tile
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t seq, int c0, int n) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x)
    dst[e] = to_f32(src[seq + int64_t(c0) * D + e]);
}

template <int D>
__device__ __forceinline__ void stage_w(float* dst,
                                        const float* __restrict__ lw,
                                        int64_t seq, int c0, int n) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x)
    dst[e] = expf(lw[seq + int64_t(c0) * D + e]);
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// phases 1 and 2: dr, dk, dlw, du (per b, h), ds0.  Block (b, h), D * NJ
// threads: thread (i, q) holds columns [q * CJ, (q + 1) * CJ) of row i.
template <typename T, int D>
__global__ void __launch_bounds__(D * NJ)
rows_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            const T* __restrict__ dO, const float* __restrict__ dsT,
            T* __restrict__ dr, T* __restrict__ dk, float* __restrict__ dlw,
            float* __restrict__ du_part, float* __restrict__ ds0,
            float* __restrict__ bound, float* __restrict__ win, int H,
            int n_tok) {
  constexpr int CJ = D / NJ;
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;                 // (C, D) each
  float* k_s = r_s + C * D;
  float* w_s = k_s + C * D;
  float* v_s = w_s + C * D;
  float* do_s = v_s + C * D;
  float* vdo_s = do_s + C * D;     // (C,)
  const int i = threadIdx.x / NJ;
  const int j0 = (threadIdx.x % NJ) * CJ;
  const bool lead = threadIdx.x % NJ == 0;
  const int bh = blockIdx.x;
  const int64_t seq = int64_t(bh) * n_tok * D;      // (b, h) row of r/k/v
  const int64_t st = int64_t(bh) * D * D;           // (b, h) state
  const int row = i * D + j0;                       // this thread's elements
  const int nc = (n_tok + C - 1) / C;
  float* bnd = bound + int64_t(bh) * nc * D * D;
  float* wn = win + int64_t(bh) * C * D * D;

  // 1. forwards: the state before each chunk
  float S[CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) S[c] = s0 != nullptr ? s0[st + row + c] : 0.f;
  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * C, n = min(C, n_tok - c0);
#pragma unroll
    for (int c = 0; c < CJ; c += 4)
      *reinterpret_cast<float4*>(&bnd[int64_t(ci) * D * D + row + c]) =
          make_float4(S[c], S[c + 1], S[c + 2], S[c + 3]);
    if (ci + 1 == nc) break;
    __syncthreads();          // the last chunk's reads are done
    stage<T, D>(k_s, k, seq, c0, n);
    stage<T, D>(v_s, v, seq, c0, n);
    stage_w<D>(w_s, lw, seq, c0, n);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float kk = k_s[t * D + i], ww = w_s[t * D + i];
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        S[c] = fmaf(ww, S[c], kk * v_s[t * D + j0 + c]);
    }
  }

  // 2. backwards over the chunks
  const float ui = u[(bh % H) * D + i];
  float G[CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) G[c] = dsT != nullptr ? dsT[st + row + c] : 0.f;
  float du_acc = 0.f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * C, n = min(C, n_tok - c0);
    __syncthreads();          // the last chunk's reads are done
    stage<T, D>(r_s, r, seq, c0, n);
    stage<T, D>(k_s, k, seq, c0, n);
    stage<T, D>(v_s, v, seq, c0, n);
    stage<T, D>(do_s, dO, seq, c0, n);
    stage_w<D>(w_s, lw, seq, c0, n);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < D; ++j) acc = fmaf(v_s[t * D + j], do_s[t * D + j],
                                             acc);
      vdo_s[t] = acc;
    }
    __syncthreads();

    // 2a. the chunk's states forwards from its bound, into the window; dr
#pragma unroll
    for (int c = 0; c < CJ; c += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(&bnd[int64_t(ci) * D * D + row + c]);
      S[c] = x.x; S[c + 1] = x.y; S[c + 2] = x.z; S[c + 3] = x.w;
    }
    for (int t = 0; t < n; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CJ; c += 4) {
        *reinterpret_cast<float4*>(&wn[int64_t(t) * D * D + row + c]) =
            make_float4(S[c], S[c + 1], S[c + 2], S[c + 3]);
        const float4 d4 =
            *reinterpret_cast<const float4*>(&do_s[t * D + j0 + c]);
        acc = fmaf(S[c], d4.x, acc);
        acc = fmaf(S[c + 1], d4.y, acc);
        acc = fmaf(S[c + 2], d4.z, acc);
        acc = fmaf(S[c + 3], d4.w, acc);
      }
      acc = row_sum(acc);
      const float kk = k_s[t * D + i], ww = w_s[t * D + i];
      if (lead)
        dr[seq + int64_t(c0 + t) * D + i] =
            from_f32<T>(acc + ui * kk * vdo_s[t]);
#pragma unroll
      for (int c = 0; c < CJ; c += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&v_s[t * D + j0 + c]);
        S[c] = fmaf(ww, S[c], kk * v4.x);
        S[c + 1] = fmaf(ww, S[c + 1], kk * v4.y);
        S[c + 2] = fmaf(ww, S[c + 2], kk * v4.z);
        S[c + 3] = fmaf(ww, S[c + 3], kk * v4.w);
      }
    }

    // 2b. the chunk's tokens backwards: dk, dlw, du and G, with S_{t-1}
    // read back from the window (this thread's own writes)
    for (int t = n - 1; t >= 0; --t) {
      float ak = 0.f, aw = 0.f;
#pragma unroll
      for (int c = 0; c < CJ; c += 4) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(&wn[int64_t(t) * D * D + row + c]);
        const float4 v4 =
            *reinterpret_cast<const float4*>(&v_s[t * D + j0 + c]);
        ak = fmaf(G[c], v4.x, ak);
        ak = fmaf(G[c + 1], v4.y, ak);
        ak = fmaf(G[c + 2], v4.z, ak);
        ak = fmaf(G[c + 3], v4.w, ak);
        aw = fmaf(G[c], s4.x, aw);
        aw = fmaf(G[c + 1], s4.y, aw);
        aw = fmaf(G[c + 2], s4.z, aw);
        aw = fmaf(G[c + 3], s4.w, aw);
      }
      ak = row_sum(ak);
      aw = row_sum(aw);
      const float rr = r_s[t * D + i], kk = k_s[t * D + i];
      const float ww = w_s[t * D + i], vd = vdo_s[t];
      if (lead) {
        const int64_t off = seq + int64_t(c0 + t) * D + i;
        dk[off] = from_f32<T>(ak + rr * ui * vd);
        dlw[off] = ww * aw;
      }
      du_acc = fmaf(rr * kk, vd, du_acc);
#pragma unroll
      for (int c = 0; c < CJ; c += 4) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(&do_s[t * D + j0 + c]);
        G[c] = fmaf(ww, G[c], rr * d4.x);
        G[c + 1] = fmaf(ww, G[c + 1], rr * d4.y);
        G[c + 2] = fmaf(ww, G[c + 2], rr * d4.z);
        G[c + 3] = fmaf(ww, G[c + 3], rr * d4.w);
      }
    }
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) ds0[st + row + c] = G[c];
  }
  if (lead) du_part[int64_t(bh) * D + i] = du_acc;
}

// dv: block (b, h), one thread per value column j holding G[:, j]
template <typename T, int D>
__global__ void __launch_bounds__(D)
cols_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const float* __restrict__ lw, const float* __restrict__ u,
            const T* __restrict__ dO, const float* __restrict__ dsT,
            T* __restrict__ dv, int H, int n_tok) {
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;                 // (C, D) each
  float* k_s = r_s + C * D;
  float* w_s = k_s + C * D;
  float* do_s = w_s + C * D;
  float* ruk_s = do_s + C * D;     // (C,)
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const float* uh = u + (bh % H) * D;
  const int64_t seq = int64_t(bh) * n_tok * D;
  const int64_t st = int64_t(bh) * D * D;
  const int nc = (n_tok + C - 1) / C;
  float G[D];
#pragma unroll
  for (int i = 0; i < D; ++i) G[i] = dsT != nullptr ? dsT[st + i * D + j] : 0.f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * C, n = min(C, n_tok - c0);
    __syncthreads();
    stage<T, D>(r_s, r, seq, c0, n);
    stage<T, D>(k_s, k, seq, c0, n);
    stage<T, D>(do_s, dO, seq, c0, n);
    stage_w<D>(w_s, lw, seq, c0, n);
    __syncthreads();
    for (int t = j; t < n; t += D) {
      float acc = 0.f;
      for (int i = 0; i < D; ++i)
        acc = fmaf(r_s[t * D + i] * uh[i], k_s[t * D + i], acc);
      ruk_s[t] = acc;
    }
    __syncthreads();
    for (int t = n - 1; t >= 0; --t) {
      const float dj = do_s[t * D + j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[t * D + i]);
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[t * D + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[t * D + i]);
        acc[0] = fmaf(k4.x, G[i], acc[0]);
        acc[1] = fmaf(k4.y, G[i + 1], acc[1]);
        acc[2] = fmaf(k4.z, G[i + 2], acc[2]);
        acc[3] = fmaf(k4.w, G[i + 3], acc[3]);
        G[i] = fmaf(w4.x, G[i], r4.x * dj);
        G[i + 1] = fmaf(w4.y, G[i + 1], r4.y * dj);
        G[i + 2] = fmaf(w4.z, G[i + 2], r4.z * dj);
        G[i + 3] = fmaf(w4.w, G[i + 3], r4.w * dj);
      }
      dv[seq + int64_t(c0 + t) * D + j] = from_f32<T>(
          ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ruk_s[t] * dj);
    }
  }
}

// du[h] = sum over b of du_part[b, h], in order of b
__global__ void du_reduce_kernel(const float* __restrict__ du_part,
                                 float* __restrict__ du, int B, int H, int D) {
  const int h = blockIdx.x;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += du_part[(int64_t(b) * H + h) * D + i];
    du[h * D + i] = acc;
  }
}

constexpr size_t rows_smem(int d) { return sizeof(float) * (5 * C * d + C); }
constexpr size_t cols_smem(int d) { return sizeof(float) * (4 * C * d + C); }

template <typename T, int D>
cudaError_t run(const void* r, const void* k, const void* v, const void* lw,
                const void* u, const void* s0, const void* dO,
                const void* dsT, void* dr, void* dk, void* dv, void* dlw,
                void* du_part, void* du, void* ds0, void* bound, void* win,
                int B, int H, int n_tok, cudaStream_t stream) {
  static bool configured = false;   // the attributes are per kernel, once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(rows_smem(D)));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(cols_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(cols_smem(D)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* dop = static_cast<const T*>(dO);
  const float* lwp = static_cast<const float*>(lw);
  const float* up = static_cast<const float*>(u);
  const float* dsTp = static_cast<const float*>(dsT);
  rows_kernel<T, D><<<B * H, D * NJ, rows_smem(D), stream>>>(
      rp, kp, static_cast<const T*>(v), lwp, up,
      static_cast<const float*>(s0), dop, dsTp, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<float*>(dlw),
      static_cast<float*>(du_part), static_cast<float*>(ds0),
      static_cast<float*>(bound), static_cast<float*>(win), H, n_tok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cols_kernel<T, D><<<B * H, D, cols_smem(D), stream>>>(
      rp, kp, lwp, up, dop, dsTp, static_cast<T*>(dv), H, n_tok);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  du_reduce_kernel<<<H, D, 0, stream>>>(static_cast<const float*>(du_part),
                                        static_cast<float*>(du), B, H, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(int D, const void* r, const void* k, const void* v,
                  const void* lw, const void* u, const void* s0,
                  const void* dO, const void* dsT, void* dr, void* dk,
                  void* dv, void* dlw, void* du_part, void* du, void* ds0,
                  void* bound, void* win, int B, int H, int n_tok,
                  cudaStream_t st) {
  switch (D) {
    case 16:
      return run<T, 16>(r, k, v, lw, u, s0, dO, dsT, dr, dk, dv, dlw,
                        du_part, du, ds0, bound, win, B, H, n_tok, st);
    case 32:
      return run<T, 32>(r, k, v, lw, u, s0, dO, dsT, dr, dk, dv, dlw,
                        du_part, du, ds0, bound, win, B, H, n_tok, st);
    case 64:
      return run<T, 64>(r, k, v, lw, u, s0, dO, dsT, dr, dk, dv, dlw,
                        du_part, du, ds0, bound, win, B, H, n_tok, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, dO, dr, dk, dv: (B, H, T, D) of dtype (0 = float32, 1 =
// bfloat16); lw, dlw: (B, H, T, D) f32; u, du: (H, D) f32; du_part (B, H,
// D) f32 scratch; s0, dsT, ds0: (B, H, D, D) f32 or null (s0 and dsT
// zeros; ds0 not written); the scratch bound (B, H, ceil(T / 64), D, D)
// and win (B, H, 64, D, D) f32, 16-byte aligned; all contiguous.  D in
// {16, 32, 64}.  Launches three kernels on `stream` without synchronising
// and returns the first error.
extern "C" int rwkv6_bwd(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, const void* s0,
                         const void* dO, const void* dsT, void* dr, void* dk,
                         void* dv, void* dlw, void* du_part, void* du,
                         void* ds0, void* bound, void* win, int B, int H,
                         int T, int D, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(run_d<float>(D, r, k, v, lw, u, s0, dO, dsT, dr, dk, dv, dlw,
                              du_part, du, ds0, bound, win, B, H, T, st));
    case 1:
      return int(run_d<__nv_bfloat16>(D, r, k, v, lw, u, s0, dO, dsT, dr, dk,
                                      dv, dlw, du_part, du, ds0, bound, win,
                                      B, H, T, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
