// RG-LRU diagonal recurrence for Hopper (sm_90a), loads by TMA: K7 for
// calls of at least ops.SM90_MIN_T tokens (prefill).
//
// Replaces rglru_pallas (src/repro/kernels/rglru/kernel.py:58; body
// _rglru_kernel :29); ops.py routes shorter calls (a decode step) to
// rglru.cu.  Per channel, in f32:
//
//   h_t = exp(log_a_t) * h_{t-1} + g_t,   h_0 = h0 (or 0)
//
// What bounds it.  Bytes: log_a f32 and g read once, h written once in
// g's type, h0 and h_final f32 (recurrentgemma-9b's prefill, B 4, T 512,
// D 4096, bf16 g: 67.2 MB, 0.0201 ms at 3.35 TB/s).  The f32 chain is one
// FMA a token, and neither the exp nor the loads depend on h, so the
// chain is not the limit; keeping enough bytes in flight is.  rglru.cu
// keeps them in registers, at most 64 tokens x 6 B a thread, and a thread
// waits for one batch before it issues the next.  Here TMA keeps them in
// flight, and the rest of the work is spread so that no one warp's
// instructions set the pace: a warp issues shared-memory instructions far
// below its arithmetic rate and an mbarrier wait costs hundreds of
// cycles, so one warp doing a token's loads, exp, FMA, conversion and
// store (about 15 instructions) would run at a fraction of the bytes'
// pace at one batch row, where an SM holds one strip of channels.
//
// Design.  A CTA of 1 + NH warps owns a strip of W = 32 channels of one
// batch row and walks its tokens in chunks of U (32 when CTAs share an SM,
// 128 when each has one: kernel.plan).  A ring of `stages` stages in shared
// memory each holds one chunk's log_a box (f32) and g box, brought by TMA
// from 3-d maps (D, T, B) onto the stage's `full` mbarrier; rows past T
// and channels past D arrive as zeros.
//   * helper warps: once a chunk lands, exp(log_a) in place (consecutive
//     threads on consecutive words), then `ready`; once the chain is done
//     with the chunk before, its h from shared memory into device memory
//     in g's type, 8 channels of a token a thread with 16-byte stores;
//     then, when every helper is done with that stage (a proxy fence and a
//     named barrier), one of them refills it with the chunk `stages` ahead;
//   * the chain warp, one lane a channel: once a chunk is `ready`, its
//     exps and g loaded 32 tokens at a time, the chain of FMAs, and h (f32)
//     written over the exps; then a proxy fence and `done`.
// One arrival a warp on each barrier.  The stages are written through the
// generic proxy before TMA (the async proxy) refills them, so every warp
// that wrote or read one fences the proxies before it signals.  Three
// stages keep two chunks in flight while the third is worked on; deeper
// rings measured no faster (PERF.md, K7's ring-depth sweep).
//
// Numerics: the f32 steps of rglru.cu (fmaf(expf(log_a), h, g), no fast
// math, h0 in f32, h rounded to nearest into g's type), so the two kernels
// are bit-equal at every shape and a run split anywhere equals one shot
// bit for bit.  No atomics.
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

// a stage: the log_a box (f32) and the g box, [U tokens][W channels]
// each as TMA lays them.  The helpers turn log_a into exp(log_a) in
// place, the chain that into h (f32)
template <typename G, int U>
struct Stage {
  static_assert(U % SUB == 0 && U * W / 8 % HT == 0,
                "helpers share a stage evenly");
  static constexpr int LA = U * W * 4;
  static constexpr int BYTES = LA + U * W * int(sizeof(G));
};

// shared memory: the ring, then the barriers: full, ready and done a stage
template <typename G, int U>
struct Smem {
  using S = Stage<G, U>;
  uint8_t* base;
  int stages;
  __device__ float* a(int s) const {
    return reinterpret_cast<float*>(base + s * S::BYTES);
  }
  __device__ const G* g(int s) const {
    return reinterpret_cast<const G*>(base + s * S::BYTES + S::LA);
  }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + stages * S::BYTES) + i;
  }
  __device__ uint64_t* full(int s) const { return bar(s); }
  __device__ uint64_t* ready(int s) const { return bar(stages + s); }
  __device__ uint64_t* done(int s) const { return bar(2 * stages + s); }
};

// chunk k (tokens [k U, k U + U) of channels [c0, c0 + W) of row b) into
// stage k mod stages, on that stage's full barrier
template <typename G, int U>
__device__ __forceinline__ void issue(const Smem<G, U>& sm,
                                      const CUtensorMap* ma,
                                      const CUtensorMap* mg, int k, int c0,
                                      int b) {
  const int s = k % sm.stages;
  mbar_arrive_expect_tx(sm.full(s), Stage<G, U>::BYTES);
  tma_load_3d(sm.a(s), ma, sm.full(s), c0, k * U, b);
  tma_load_3d(sm.a(s) + U * W, mg, sm.full(s), c0, k * U, b);
}

// the chain's `n` steps of SUB tokens (all SUB when FULL) of one lane's
// column: the exps and g all loaded, then the chain of FMAs, then h over
// the exps
template <typename G, bool FULL>
__device__ __forceinline__ float steps(float* __restrict__ a,
                                       const G* __restrict__ g, float hc,
                                       int n) {
  float av[SUB], xv[SUB];
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    av[u] = a[u * W];
    xv[u] = to_f32(g[u * W]);
  }
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    if (FULL || u < n) hc = fmaf(av[u], hc, xv[u]);
    av[u] = hc;
  }
#pragma unroll
  for (int u = 0; u < SUB; ++u) a[u * W] = av[u];
  return hc;
}

template <typename G, int U>
__global__ void __launch_bounds__(NTHREADS, 4)
rglru_sm90_kernel(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mg,
                  const float* __restrict__ h0, G* __restrict__ h,
                  float* __restrict__ h_final, int n_tok, int D,
                  int stages) {
  // the ring aligned to ALIGN by an offset from smem_raw, so that the
  // compiler still knows it for shared memory (LDS / STS, not generic
  // loads and stores)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<G, U> sm{
      smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1)),
      stages};
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * W;
  const int b = blockIdx.y;
  const int n_chunks = (n_tok + U - 1) / U;

  if (tid == 0) {
    prefetch_tensormap(&ma);
    prefetch_tensormap(&mg);
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.ready(s), NH);
      mbar_init(sm.done(s), 1);
    }
    fence_barrier_init();
    for (int k = 0; k < min(stages, n_chunks); ++k)
      issue(sm, &ma, &mg, k, c0, b);
  }
  __syncthreads();           // the barriers exist before anyone waits

  if (tid >= 32) {
    // helpers.  Chunk k: exp(log_a) in place once it lands; then chunk
    // k - 1's h, once the chain has stepped it, into device memory in g's
    // type (8 channels of a token a thread), and its stage refilled with
    // chunk k - 1 + stages once every helper has read it
    const int j = tid - 32;
    for (int k = 0; k <= n_chunks; ++k) {
      if (k < n_chunks) {
        const int s = k % stages;
        mbar_wait(sm.full(s), (k / stages) & 1);
        float* a = sm.a(s);
        float v[U * W / HT];
#pragma unroll
        for (int i = 0; i < U * W / HT; ++i)
          v[i] = a[j + i * HT];
#pragma unroll
        for (int i = 0; i < U * W / HT; ++i)
          a[j + i * HT] = expf(v[i]);
        __syncwarp();        // the warp's exps, then one arrival
        if ((tid & 31) == 0) mbar_arrive(sm.ready(s));
      }
      if (k > 0) {
        const int kp = k - 1, s = kp % stages;
        mbar_wait(sm.done(s), (kp / stages) & 1);
        const float* hs = sm.a(s);
#pragma unroll
        for (int i = 0; i < U * W / 8 / HT; ++i) {
          const int q = j + i * HT;
          const int t = kp * U + q / (W / 8), c = c0 + 8 * (q % (W / 8));
          if (t < n_tok && c < D) {
            const float4* src = reinterpret_cast<const float4*>(hs + 8 * q);
            store8(h + (int64_t(b) * n_tok + t) * D + c, src[0], src[1],
                   D - c);
          }
        }
        // every helper has read the stage: its generic reads and writes
        // ordered before the TMA write that refills it
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" :: "n"(HT) : "memory");
        if (tid == 32 && kp + stages < n_chunks)
          issue(sm, &ma, &mg, kp + stages, c0, b);
      }
    }
    return;
  }

  // the chain warp: one lane a channel
  const int c = c0 + tid;
  float hc = (h0 != nullptr && c < D) ? h0[int64_t(b) * D + c] : 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % stages;
    mbar_wait(sm.ready(s), (k / stages) & 1);
#pragma unroll
    for (int sub = 0; sub < U / SUB; ++sub) {
      float* a = sm.a(s) + sub * SUB * W + tid;
      const G* g = sm.g(s) + sub * SUB * W + tid;
      const int n = n_tok - k * U - sub * SUB;
      if (n >= SUB) hc = steps<G, true>(a, g, hc, SUB);
      else if (n > 0) hc = steps<G, false>(a, g, hc, n);
    }
    fence_proxy_async();     // h's generic writes before a later TMA write
    __syncwarp();            // the warp's h, then one arrival
    if (tid == 0) mbar_arrive(sm.done(s));
  }
  if (c < D) h_final[int64_t(b) * D + c] = hc;
}

template <typename G, int U>
cudaError_t launch(const void* log_a, const void* g, const void* h0,
                   void* h, void* h_final, int B, int T, int D, int stages,
                   cudaStream_t stream) {
  // the helpers refill a stage one chunk after the chain steps it: a ring
  // of one stage would wait on itself
  if (stages < 1 || stages > MAX_STAGES || (stages < 2 && T > U))
    return cudaErrorInvalidValue;
  // the ring, three barriers a stage, and room to align the ring
  const size_t smem = size_t(stages) * (Stage<G, U>::BYTES + 24) + ALIGN;
  if (smem > size_t(SMEM_MAX) || int64_t(D) * sizeof(G) % 16)
    return cudaErrorInvalidValue;
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_sm90_kernel<G, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ma, mg;
  cudaError_t e = make_rglru_map(&ma, log_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                 4, D, T, B, W, U);
  if (e == cudaSuccess)
    e = make_rglru_map(&mg, g,
                       sizeof(G) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       int(sizeof(G)), D, T, B, W, U);
  if (e != cudaSuccess) return e;
  dim3 grid((D + W - 1) / W, B);
  rglru_sm90_kernel<G, U><<<grid, NTHREADS, smem, stream>>>(
      ma, mg, static_cast<const float*>(h0), static_cast<G*>(h),
      static_cast<float*>(h_final), T, D, stages);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_tokens(const void* log_a, const void* g, const void* h0,
                          void* h, void* h_final, int B, int T, int D,
                          int tokens, int stages, cudaStream_t stream) {
  switch (tokens) {
    case 32:
      return launch<G, 32>(log_a, g, h0, h, h_final, B, T, D, stages, stream);
    case 128:
      return launch<G, 128>(log_a, g, h0, h, h_final, B, T, D, stages,
                            stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// log_a: (B, T, D) f32; g, h: (B, T, D) of dtype (0 = float32,
// 1 = bfloat16); h0: (B, D) f32 or null (zeros); h_final: (B, D) f32; all
// contiguous, log_a, g and h 16-byte aligned with rows of a multiple of 16
// bytes (TMA reads log_a and g, 16-byte stores write h: D a multiple of 4
// for f32 g, of 8 for bf16).  `tokens`: a chunk's tokens, 32 or 128;
// `stages`: the ring's depth, 1 to 32 (2 at least when T > tokens), at
// most 227 KB of shared memory.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int rglru_sm90(const void* log_a, const void* g, const void* h0,
                          void* h, void* h_final, int B, int T, int D,
                          int dtype, int tokens, int stages, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(log_a) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(h)) % 16)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_tokens<float>(log_a, g, h0, h, h_final, B, T, D,
                                      tokens, stages, st));
    case 1:
      return int(launch_tokens<__nv_bfloat16>(log_a, g, h0, h, h_final, B, T,
                                              D, tokens, stages, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rglru_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
