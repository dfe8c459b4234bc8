// RG-LRU backward for Hopper (sm_90a), loads by TMA: K7's backward for
// calls of at least ops.SM90_BWD_MIN_T tokens (training).
//
// Replaces the reference's analytic reverse scan _rglru_bwd
// (src/repro/kernels/rglru/ops.py:54-86), the backward of rglru_pallas
// (src/repro/kernels/rglru/kernel.py:58); ops.py routes shorter calls to
// rglru_bwd.cu.  Per channel, in f32, from the cotangents dh (B, T, D) and
// dh_last (B, D) of (h, h_final):
//
//   lam_t = dh_t + a_{t+1} * lam_{t+1},  lam_{T-1} = dh_{T-1} + dh_last
//   dg_t = lam_t,  dlog_a_t = lam_t * h_{t-1} * a_t,  dh0 = a_0 * lam_0
//
// with a_t = exp(log_a_t), h_{t-1} read from the forward's saved h (in its
// dtype) and h_{-1} = h0 (or 0).
//
// What bounds it.  Bytes: log_a and dlog_a f32, h, dh and dg in h's type,
// h0, dh_last and dh0 f32 (recurrentgemma-9b's training shape, B 1, T 4096,
// D 4096, bf16: 235 MB, 0.070 ms at 3.35 TB/s).  The chain is two dependent
// f32 operations a token, about 20 us over 4,096 tokens, and nothing else
// depends on it, so keeping enough bytes in flight is the limit: several MB
// on the card.  rglru_bwd.cu holds them in registers, 16 tokens of one
// channel a thread, one thread a channel: at one batch row that is 4,096
// threads and about 0.5 MB in flight.
//
// Design: rglru_sm90.cu's, run from the last chunk to the first.  A CTA of
// 1 + NH warps owns a strip of W = 32 channels of one batch row and walks
// its tokens in chunks of U (32 when CTAs share an SM, 128 when each has
// one: kernel.plan), last chunk first.  A ring of `stages` stages in
// shared memory each holds one chunk [t0, t0 + U): the log_a box (f32), the
// dh box and the h box one token earlier, [t0 - 1, t0 - 1 + U), so that
// its row u is h_{t-1} of token t0 + u (the first chunk's row 0, token -1,
// arrives as zeros: h0 takes its place), all brought by TMA onto the
// stage's `full` mbarrier; and a lam box (f32) the chain writes.
//   * helper warps: once a chunk lands, exp(log_a) in place (consecutive
//     threads on consecutive words), then `ready`; once the chain is done
//     with the chunk before (in processing order), its dlog_a = lam h_{t-1}
//     a (f32) and dg = lam (in h's type) into device memory, 8 channels of
//     a token a thread with 16-byte stores straight from registers; then,
//     when every helper is done with that stage (a proxy fence and a named
//     barrier), one of them refills it with the chunk `stages` on;
//   * the chain warp, one lane a channel: once a chunk is `ready`, its
//     exps and dh loaded 32 tokens at a time, the reverse chain, lam
//     written into the lam box; then a proxy fence and `done`.  The carry
//     a_t lam_t crosses chunks in a register; after the first chunk it is
//     dh0.
// One arrival a warp on each barrier.  The stages are read and written
// through the generic proxy before TMA (the async proxy) refills them, so
// every warp that touched one fences the proxies before it signals.
//
// Numerics: rglru.cuh's steps (each operation rounded on its own, expf
// without fast math, h0 in f32, dg rounded to nearest into h's type) in the
// order of rglru_bwd.cu, so the two kernels are bit-equal at every shape.
// No atomics.
#include "rglru.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int W = 32;             // channels a CTA: the chain warp's lanes
constexpr int SUB = 32;           // tokens the chain loads at once
constexpr int NH = 4;             // helper warps
constexpr int HT = 32 * NH;       // helper threads
constexpr int NTHREADS = 32 + HT;
constexpr int MAX_STAGES = 32;
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a CTA may ask for
constexpr int ALIGN = 128;        // TMA destinations

// a stage: the log_a box (f32, exp(log_a) once the helpers are done), the
// lam box (f32), the dh box and the shifted h box (h's type), each
// [U tokens][W channels] as TMA lays them
template <typename T, int U>
struct Stage {
  static_assert(U % SUB == 0 && U * W / 8 % HT == 0 && U * W % HT == 0,
                "helpers share a stage evenly");
  static constexpr int F32 = U * W * 4;
  static constexpr int TB = U * W * int(sizeof(T));
  static constexpr int LOADED = F32 + 2 * TB;     // what TMA brings
  static constexpr int BYTES = 2 * F32 + 2 * TB;
};

// shared memory: the ring, then the barriers: full, ready and done a stage
template <typename T, int U>
struct Smem {
  using S = Stage<T, U>;
  uint8_t* base;
  int stages;
  __device__ float* a(int s) const {
    return reinterpret_cast<float*>(base + s * S::BYTES);
  }
  __device__ float* lam(int s) const {
    return reinterpret_cast<float*>(base + s * S::BYTES + S::F32);
  }
  __device__ T* dh(int s) const {
    return reinterpret_cast<T*>(base + s * S::BYTES + 2 * S::F32);
  }
  __device__ T* hp(int s) const {
    return reinterpret_cast<T*>(base + s * S::BYTES + 2 * S::F32 + S::TB);
  }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + stages * S::BYTES) + i;
  }
  __device__ uint64_t* full(int s) const { return bar(s); }
  __device__ uint64_t* ready(int s) const { return bar(stages + s); }
  __device__ uint64_t* done(int s) const { return bar(2 * stages + s); }
};

// the p-th chunk in processing order, chunk n_chunks - 1 - p (tokens [t0,
// t0 + U), t0 = (n_chunks - 1 - p) U, of channels [c0, c0 + W) of row b),
// into stage p mod stages, on that stage's full barrier
template <typename T, int U>
__device__ __forceinline__ void issue(const Smem<T, U>& sm,
                                      const CUtensorMap* ma,
                                      const CUtensorMap* mdh,
                                      const CUtensorMap* mh, int p,
                                      int n_chunks, int c0, int b) {
  const int s = p % sm.stages;
  const int t0 = (n_chunks - 1 - p) * U;
  mbar_arrive_expect_tx(sm.full(s), Stage<T, U>::LOADED);
  tma_load_3d(sm.a(s), ma, sm.full(s), c0, t0, b);
  tma_load_3d(sm.dh(s), mdh, sm.full(s), c0, t0, b);
  tma_load_3d(sm.hp(s), mh, sm.full(s), c0, t0 - 1, b);
}

// 8 consecutive values of a box row from shared memory as f32: two
// 16-byte loads for f32, one for bf16
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 x = reinterpret_cast<const float4*>(src)[0];
  const float4 y = reinterpret_cast<const float4*>(src)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// four values as one float4, store8's operand
__device__ __forceinline__ float4 f4(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the chain's steps over SUB tokens of one lane's column, last token first
// (only the first `n` tokens, those inside T, unless FULL): the exps and dh
// all loaded, then the chain, then lam into the lam box
template <typename T, bool FULL>
__device__ __forceinline__ float steps(const float* __restrict__ a,
                                       const T* __restrict__ dh,
                                       float* __restrict__ lam, float carry,
                                       int n) {
  float av[SUB], dv[SUB];
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    av[u] = a[u * W];
    dv[u] = to_f32(dh[u * W]);
  }
#pragma unroll
  for (int u = SUB - 1; u >= 0; --u) {
    if (FULL || u < n) {
      const float l = bwd_lam(dv[u], carry);
      carry = bwd_carry(av[u], l);
      av[u] = l;
    }
  }
#pragma unroll
  for (int u = 0; u < SUB; ++u) lam[u * W] = av[u];
  return carry;
}

template <typename T, int U>
__global__ void __launch_bounds__(NTHREADS, 4)
rglru_bwd_sm90_kernel(const __grid_constant__ CUtensorMap ma,
                      const __grid_constant__ CUtensorMap mdh,
                      const __grid_constant__ CUtensorMap mh,
                      const float* __restrict__ h0,
                      const float* __restrict__ dh_last,
                      float* __restrict__ dla, T* __restrict__ dg,
                      float* __restrict__ dh0, int n_tok, int D,
                      int stages) {
  // the ring aligned to ALIGN by an offset from smem_raw, so that the
  // compiler still knows it for shared memory (LDS / STS)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<T, U> sm{
      smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1)),
      stages};
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * W;
  const int b = blockIdx.y;
  const int n_chunks = (n_tok + U - 1) / U;

  if (tid == 0) {
    prefetch_tensormap(&ma);
    prefetch_tensormap(&mdh);
    prefetch_tensormap(&mh);
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.ready(s), NH);
      mbar_init(sm.done(s), 1);
    }
    fence_barrier_init();
    for (int p = 0; p < min(stages, n_chunks); ++p)
      issue(sm, &ma, &mdh, &mh, p, n_chunks, c0, b);
  }
  __syncthreads();           // the barriers exist before anyone waits

  if (tid >= 32) {
    // helpers.  The p-th chunk: exp(log_a) in place once it lands; then
    // the (p-1)-th chunk's dlog_a and dg, once the chain has stepped it,
    // into device memory, and its stage refilled with the (p - 1 +
    // stages)-th chunk once every helper has read it
    const int j = tid - 32;
    for (int p = 0; p <= n_chunks; ++p) {
      if (p < n_chunks) {
        const int s = p % stages;
        mbar_wait(sm.full(s), (p / stages) & 1);
        float* a = sm.a(s);
        float v[U * W / HT];
#pragma unroll
        for (int i = 0; i < U * W / HT; ++i) v[i] = a[j + i * HT];
#pragma unroll
        for (int i = 0; i < U * W / HT; ++i) a[j + i * HT] = expf(v[i]);
        __syncwarp();        // the warp's exps, then one arrival
        if ((tid & 31) == 0) mbar_arrive(sm.ready(s));
      }
      if (p > 0) {
        const int q = p - 1, s = q % stages;
        const int t0 = (n_chunks - 1 - q) * U;
        mbar_wait(sm.done(s), (q / stages) & 1);
#pragma unroll
        for (int i = 0; i < U * W / 8 / HT; ++i) {
          const int g = j + i * HT;
          const int u = g / (W / 8), x = 8 * (g % (W / 8));
          const int t = t0 + u, c = c0 + x;
          if (t >= n_tok || c >= D) continue;
          const int room = D - c;
          float lv[8], av[8], hv[8], out[8];
          load8(sm.lam(s) + u * W + x, lv);
          load8(sm.a(s) + u * W + x, av);
          if (t > 0) {
            load8(sm.hp(s) + u * W + x, hv);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              hv[e] = (h0 != nullptr && e < room)
                          ? h0[int64_t(b) * D + c + e] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) out[e] = bwd_dlog_a(lv[e], hv[e], av[e]);
          const int64_t off = (int64_t(b) * n_tok + t) * D + c;
          store8(dla + off, f4(out), f4(out + 4), room);
          store8(dg + off, f4(lv), f4(lv + 4), room);
        }
        // every helper has read the stage: its generic reads and writes
        // ordered before the TMA write that refills it
        fence_proxy_async();
        named_barrier(1, HT);
        if (tid == 32 && q + stages < n_chunks)
          issue(sm, &ma, &mdh, &mh, q + stages, n_chunks, c0, b);
      }
    }
    return;
  }

  // the chain warp: one lane a channel, the chunks last first and each
  // chunk's sub-blocks last first
  const int c = c0 + tid;
  float carry =
      (dh_last != nullptr && c < D) ? dh_last[int64_t(b) * D + c] : 0.f;
  for (int p = 0; p < n_chunks; ++p) {
    const int s = p % stages;
    const int t0 = (n_chunks - 1 - p) * U;
    mbar_wait(sm.ready(s), (p / stages) & 1);
#pragma unroll
    for (int sub = U / SUB - 1; sub >= 0; --sub) {
      const float* a = sm.a(s) + sub * SUB * W + tid;
      const T* dh = sm.dh(s) + sub * SUB * W + tid;
      float* lam = sm.lam(s) + sub * SUB * W + tid;
      const int n = n_tok - t0 - sub * SUB;
      if (n >= SUB) carry = steps<T, true>(a, dh, lam, carry, SUB);
      else if (n > 0) carry = steps<T, false>(a, dh, lam, carry, n);
    }
    fence_proxy_async();     // the stage's generic accesses before TMA's
    __syncwarp();            // the warp's lam, then one arrival
    if (tid == 0) mbar_arrive(sm.done(s));
  }
  if (dh0 != nullptr && c < D) dh0[int64_t(b) * D + c] = carry;
}

template <typename T, int U>
cudaError_t launch(const void* log_a, const void* h, const void* h0,
                   const void* dh, const void* dh_last, void* dla, void* dg,
                   void* dh0, int B, int n_tok, int D, int stages,
                   cudaStream_t stream) {
  // the helpers refill a stage one chunk after the chain steps it: a ring
  // of one stage would wait on itself
  if (stages < 1 || stages > MAX_STAGES || (stages < 2 && n_tok > U))
    return cudaErrorInvalidValue;
  // the ring, three barriers a stage, and room to align the ring
  const size_t smem = size_t(stages) * (Stage<T, U>::BYTES + 24) + ALIGN;
  if (smem > size_t(SMEM_MAX) || int64_t(D) * sizeof(T) % 16)
    return cudaErrorInvalidValue;
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_bwd_sm90_kernel<T, U>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const CUtensorMapDataType tt = sizeof(T) == 4
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ma, mdh, mh;
  cudaError_t e = make_rglru_map(&ma, log_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                 4, D, n_tok, B, W, U);
  if (e == cudaSuccess)
    e = make_rglru_map(&mdh, dh, tt, int(sizeof(T)), D, n_tok, B, W, U);
  if (e == cudaSuccess)
    e = make_rglru_map(&mh, h, tt, int(sizeof(T)), D, n_tok, B, W, U);
  if (e != cudaSuccess) return e;
  dim3 grid((D + W - 1) / W, B);
  rglru_bwd_sm90_kernel<T, U><<<grid, NTHREADS, smem, stream>>>(
      ma, mdh, mh, static_cast<const float*>(h0),
      static_cast<const float*>(dh_last), static_cast<float*>(dla),
      static_cast<T*>(dg), static_cast<float*>(dh0), n_tok, D, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tokens(const void* log_a, const void* h, const void* h0,
                          const void* dh, const void* dh_last, void* dla,
                          void* dg, void* dh0, int B, int n_tok, int D,
                          int tokens, int stages, cudaStream_t stream) {
  switch (tokens) {
    case 32:
      return launch<T, 32>(log_a, h, h0, dh, dh_last, dla, dg, dh0, B, n_tok,
                           D, stages, stream);
    case 128:
      return launch<T, 128>(log_a, h, h0, dh, dh_last, dla, dg, dh0, B,
                            n_tok, D, stages, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// log_a, dlog_a: (B, T, D) f32; h, dh, dg: (B, T, D) of dtype (0 =
// float32, 1 = bfloat16); h0, dh_last, dh0: (B, D) f32 or null (h0 and
// dh_last zeros; dh0 not written); all contiguous, log_a, h, dh, dlog_a and
// dg 16-byte aligned with rows of a multiple of 16 bytes (TMA reads log_a,
// h and dh, 16-byte stores write dlog_a and dg: D a multiple of 4 for f32,
// of 8 for bf16).  `tokens`: a chunk's tokens, 32 or 128; `stages`: the
// ring's depth, 1 to 32 (2 at least when T > tokens), at most 227 KB of
// shared memory.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int rglru_bwd_sm90(const void* log_a, const void* h,
                              const void* h0, const void* dh,
                              const void* dh_last, void* dlog_a, void* dg,
                              void* dh0, int B, int T, int D, int dtype,
                              int tokens, int stages, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(log_a) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(dlog_a) |
       reinterpret_cast<uintptr_t>(dg)) % 16)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_tokens<float>(log_a, h, h0, dh, dh_last, dlog_a, dg,
                                      dh0, B, T, D, tokens, stages, st));
    case 1:
      return int(launch_tokens<__nv_bfloat16>(log_a, h, h0, dh, dh_last,
                                              dlog_a, dg, dh0, B, T, D,
                                              tokens, stages, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rglru_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
