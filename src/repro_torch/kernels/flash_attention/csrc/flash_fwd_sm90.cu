// Flash-attention forward for Hopper (sm_90a), bf16, on the tensor cores:
// GQA, causal (bottom-right) or sliding window, online softmax; returns
// out and the f32 log-sum-exp.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:95, body _fa_kernel at :34) for bf16 inputs; f32 inputs keep
// the FMA kernel of flash_fwd.cu.  Same function, not the same blocking:
// the TPU kernel walks the KV axis as a sequential grid dimension with its
// accumulators in VMEM scratch; here one block owns (b, q-head, 128
// queries) and walks the KV tiles in a loop, with the running max, sum
// and output in registers.
//
// What bounds it.  At the training path's shape (B 1, Hq 16, Hkv 2, T = S
// = 4096, D 128, causal) the work is 6.9e10 FLOP, 0.069 ms at the card's
// 989 TFLOP/s bf16 tensor rate, against 17 MB of bytes (0.005 ms): bound
// by operations.  At the serving shapes (T = S = 512) both are near 0.01
// ms.  Both products therefore run on wgmma, fed by TMA:
//
//   * One block of three warpgroups.  Warpgroups 0 and 1 are consumers,
//     64 query rows each; warpgroup 2 is the producer, one thread of which
//     issues every TMA load.  setmaxnreg gives the consumers 240 registers
//     and the producer 24.
//   * The Q tile (128 rows) is loaded once.  K and V tiles of BK keys (128
//     at D <= 128, 64 at D 160 and 256) go through a ring of NSTAGE stages, one
//     full and one empty mbarrier a stage: the producer waits for a stage
//     to be empty, loads it, and the consumers wait for it to be full,
//     use it and release it, so the next tiles load during the products.
//   * S = Q K^T is an SS wgmma (both K-major) into f32 registers; the
//     softmax scale (times log2 e, for exp2) is applied to S in f32, as
//     the reference scales q in f32 before its product.  P is rounded to
//     bf16 in registers, where the S accumulator's layout is already the
//     A fragment's, and O += P V is an RS wgmma with V the MN-major B.
//   * Head dim 160 (pixtral-12b) is not a power of two: its tiles are five
//     column boxes of 32 under SWIZZLE_64B (sm90.cuh, Geo), so one
//     m64n160k16 instruction spans V's five boxes with one descriptor
//     stride, and Q K^T walks ten k-steps, two a box.  Shared memory is
//     123,944 bytes (Q 40,960, two stages of K and V 81,920), one block an
//     SM; a consumer thread holds o[80] + s[32] + p[16] f32 registers.
//   * Only tiles that the causal diagonal, the window's edge or the end
//     of the keys cross are masked; tiles a mask hides entirely are never
//     loaded, and the query tiles with the most key tiles start first.
//
// Numerics: scores, the softmax statistics and O are f32; P enters the
// P V product in bf16, as in every tensor-core flash attention.  A row with
// no allowed key gets zeros and lse = -inf.
#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int BQ = 128;         // queries per block, 64 per consumer
constexpr int NSTAGE = 2;       // K/V ring depth
constexpr int NTHREADS = 384;   // two consumer warpgroups, one producer
constexpr float LN2 = 0.69314718055994531f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // 1024 of slack to align the tiles, then Q, the K ring, the V ring and
  // the barriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + size_t(2) * NSTAGE * KV_BYTES + 8 * (1 + 2 * NSTAGE);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Hq, int Hkv, int Tq, int S,
                      float scale_log2, int causal, int has_window,
                      int window) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + C::Q_BYTES;
  uint8_t* sV = sK + NSTAGE * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + NSTAGE * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NSTAGE;

  // grid (Hq, query tiles, B): the last query tile (the most key tiles
  // under a causal mask) first
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;    // bottom-right alignment

  // the key tiles any real query row of this block may see
  const int qpos_lo = q0 + offset;
  const int qpos_hi = min(q0 + BQ, Tq) - 1 + offset;
  const int k_end = causal ? min(S, qpos_hi + 1) : S;
  const int k_begin = has_window ? max(0, qpos_lo - window + 1) : 0;
  const int kt0 = (k_begin / BK) * BK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);   // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (tid == 256) {
      prefetch_tensormap(&mq);
      prefetch_tensormap(&mk);
      prefetch_tensormap(&mv);
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      load_tile<D, BQ>(sQ, &mq, q_full, q0, b * Hq + h);
      int stage = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * C::KV_BYTES);
        const int k0 = kt0 + j * BK;
        load_tile<D, BK>(sK + stage * C::KV_BYTES, &mk, &full[stage], k0,
                         b * Hkv + hk);
        load_tile<D, BK>(sV + stage * C::KV_BYTES, &mv, &full[stage], k0,
                         b * Hkv + hk);
        if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    const int t = tid % 128;
    const int lane = t % 32;
    const int r_in = (t / 32) * 16 + lane / 4;  // accumulator row (and +8)
    const int cq = 2 * (lane % 4);              // column within 8
    const int wq_lo = q0 + wg * 64;             // this warpgroup's rows
    const int wq_hi = wq_lo + 63;
    const int row0 = wq_lo + r_in;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};        // this thread's part of the row sums

    const uint32_t qaddr = smem_u32(sQ);
    mbar_wait(q_full, 0);

    int stage = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = kt0 + j * BK;
      mbar_wait(&full[stage], phase);
      // warpgroup-uniform: a tile the mask hides from all 64 rows
      const bool hidden =
          (causal && k0 > wq_hi + offset) ||
          (has_window && k0 + BK - 1 <= wq_lo + offset - window);
      if (!hidden) {
        const uint32_t kaddr = smem_u32(sK + stage * C::KV_BYTES);
        const uint32_t vaddr = smem_u32(sV + stage * C::KV_BYTES);
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, desc_k<D, BQ>(qaddr, wg * 64, kk),
                   desc_k<D, BK>(kaddr, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        const bool masked =
            k0 + BK > S || (causal && k0 + BK - 1 > wq_lo + offset) ||
            (has_window && k0 <= wq_hi + offset - window);
        if (masked) {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int kpos = k0 + 8 * n + cq + jj;
                const int qpos = row0 + 8 * i + offset;
                const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                                (!has_window || kpos > qpos - window);
                if (!ok) s[4 * n + 2 * i + jj] = -INFINITY;
              }
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
            mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx * scale_log2);
          // a row with no allowed key yet keeps p = 0 (never -inf - -inf)
          const float base = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m[i] - base);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float p = exp2f(fmaf(s[4 * n + 2 * i + jj], scale_log2,
                                         -base));
              s[4 * n + 2 * i + jj] = p;
              sum += p;
            }
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            o[4 * n + 2 * i] *= alpha;
            o[4 * n + 2 * i + 1] *= alpha;
          }
        }

        uint32_t p[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(s, kk, p[kk]);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(o, p[kk], desc_mn<D, BK>(vaddr, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
    }

    const size_t bh = size_t(b) * Hq + h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = row0 + 8 * i;
      if (row < Tq) {
        const float inv = li > 0.f ? 1.f / li : 0.f;
        __nv_bfloat16* orow = out + (bh * Tq + row) * D + cq;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
        if (cq == 0)
          lse[bh * Tq + row] =
              li > 0.f ? (m[i] + log2f(li)) * LN2 : -INFINITY;
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Hq, int Hkv, int Tq, int S,
                   float scale, int causal, int has_window, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::SMEM;
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  cudaError_t e = make_map<D>(&mq, q, Tq, B * Hq);
  // S = 0 loads no key tile; its maps only have to be valid
  if (e == cudaSuccess) e = make_map<D>(&mk, S > 0 ? k : q, max(S, 1),
                                        S > 0 ? B * Hkv : 1);
  if (e == cudaSuccess) e = make_map<D>(&mv, S > 0 ? v : q, max(S, 1),
                                        S > 0 ? B * Hkv : 1);
  if (e != cudaSuccess) return e;
  dim3 grid(Hq, (Tq + BQ - 1) / BQ, B);
  flash_fwd_sm90_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      Hq, Hkv, Tq, S, scale * 1.4426950408889634f, causal, has_window,
      window);
  return cudaGetLastError();
}

}  // namespace

// bf16 only (dtype 1); q (B, Hq, T, D), k/v (B, Hkv, S, D), out (B, Hq, T,
// D) bf16, lse (B, Hq, T) f32, all contiguous, q/k/v 16-byte aligned (TMA).
// D in {32, 64, 128, 160, 256}.  Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Hq, int Hkv,
                              int Tq, int S, int D, float scale, int causal,
                              int has_window, int window, int dtype,
                              void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Tq <= 0 || S < 0 || Hq % Hkv != 0 ||
      dtype != 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return int(launch<32>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                            causal, has_window, window, st));
    case 64:
      return int(launch<64>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                            causal, has_window, window, st));
    case 128:
      return int(launch<128>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                             causal, has_window, window, st));
    case 160:
      return int(launch<160>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                             causal, has_window, window, st));
    case 256:
      return int(launch<256>(q, k, v, out, lse, B, Hq, Hkv, Tq, S, scale,
                             causal, has_window, window, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_fwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
