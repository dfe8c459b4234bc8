// Flash-attention backward for Hopper (sm_90a), bf16, on the tensor cores:
// GQA, causal (bottom-right) or sliding window; dq, dk, dv from q, k, v,
// out, the f32 log-sum-exp and the output's gradient.
//
// Replaces, for bf16 inputs at every head dim (32, 64, 128, 160, 256), the
// backward of K4 (flash_attention_pallas, src/repro/kernels/
// flash_attention/kernel.py:95), which JAX runs as the XLA blockwise
// ops._xla_flash_bwd (src/repro/kernels/flash_attention/ops.py:94-150);
// f32 inputs keep the FMA kernels of flash_bwd.cu.  Same
// function: p is recomputed per tile from the saved lse, p = exp(s - lse),
// with D = rowsum(do * o) in f32, dv = p^T do, ds = p (do v^T - D),
// dq = scale ds k, dk = scale ds^T q.
//
// Deterministic, with no atomics, in four kernels, as the FMA design:
//   1. rowdot: D = rowsum(do * o), one warp per query row.
//   2. dkdv: one block per (b, q-head, 128 keys), every head's first key
//      tile (the most query tiles under a causal mask) first.  Two consumer
//      warpgroups own 64 keys each and keep dk and dv in registers; a
//      producer warpgroup loads K and V once and the (Q, dO) tiles of 64
//      queries, with their lse and D, through a ring of NSTAGE stages.
//      Per tile: S^T = K Q^T and dP^T = V dO^T are SS wgmmas (all
//      K-major); P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T
//      (dP^T - D) in f32, both rounded to bf16 in registers; dV += P^T dO
//      and dK += dS^T Q are RS wgmmas with dO and Q as MN-major B.  Each
//      query head's dk and dv are written in f32 as its part of its KV
//      head's.
//      At head dim 256 these tiles do not fit: dkdv_d256 (below) takes 64
//      keys a block, splits the queries of S^T and dP^T and the columns of
//      dK and dV between its consumers, and sums a group of query heads
//      into each part.  At head dim 160 dkdv_qsplit takes 64 keys a block
//      and splits each query tile between its consumers, whose partial dk
//      and dv are summed in shared memory at the end.
//   3. dkdv_reduce: dk, dv = the sum of the parts of each KV head, in
//      head order.
//   4. dq: one block per (b, q-head, 128 queries), longest first; Q and dO
//      are loaded once, (K, V) tiles of 64 keys (32 at head dim 256) go
//      through the ring.  S = Q K^T and dP = dO V^T are recomputed with SS
//      wgmmas, dS is rounded to bf16 and dQ += dS K is an RS wgmma with K
//      as MN-major B.
// Probabilities are masked to exact zeros, so a row with no allowed key
// (lse = -inf) gives zero gradients.
//
// What bounds it.  At the training path's shape (B 1, Hq 16, Hkv 2, T = S
// = 4096, D 128, causal) the five products of the algorithm are about
// 1.7e11 FLOP, 0.17 ms at 989 TFLOP/s, against about 76 MB (0.023 ms):
// bound by operations.  At recurrentgemma-9b's (B 1, Hq 16, Hkv 1, T = S
// = 4096, D 256, window 2048) they are 2.6e11 FLOP, 0.26 ms.  This design
// runs seven products, since the dq pass recomputes S and dP; that is the
// price of a dq with no atomics.
#include "sm90.cuh"

#include <algorithm>
#include <math.h>

namespace {

using namespace sm90;

constexpr int NSTAGE = 2;
constexpr int NTHREADS = 384;   // two consumer warpgroups, one producer
constexpr int RD_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(RD_THREADS)
rowdot_kernel(const __nv_bfloat16* __restrict__ dout,
              const __nv_bfloat16* __restrict__ out, float* __restrict__ Dsum,
              int64_t rows, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      int64_t(blockIdx.x) * (RD_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(__bfloat162float(dout[r * D + c]),
               __bfloat162float(out[r * D + c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) Dsum[r] = acc;
}

// dk[b, hk] = sum over gi of pdk[b, hk * g + gi], in order of gi; dv alike
__global__ void __launch_bounds__(RD_THREADS)
dkdv_reduce_kernel(const float* __restrict__ pdk,
                   const float* __restrict__ pdv,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int64_t head_elems,
                   int64_t n, int g) {
  for (int64_t i = int64_t(blockIdx.x) * RD_THREADS + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * RD_THREADS) {
    const int64_t bh = i / head_elems;      // b * Hkv + hk
    const int64_t e = i - bh * head_elems;
    const int64_t p0 = bh * g * head_elems + e;
    float sk = 0.f, sv = 0.f;
    for (int gi = 0; gi < g; ++gi) {
      sk += pdk[p0 + gi * head_elems];
      sv += pdv[p0 + gi * head_elems];
    }
    dk[i] = __float2bfloat16_rn(sk);
    dv[i] = __float2bfloat16_rn(sv);
  }
}

// ---------------------------------------------------------------- dk / dv
constexpr int KV_ROWS = 128;    // keys per dkdv block, 64 per consumer
constexpr int QT = 64;          // queries per ring tile

template <int D>
struct DkdvCfg {
  static constexpr int KV_BYTES = KV_ROWS * D * 2;
  static constexpr int Q_BYTES = QT * D * 2;
  // per stage: Q, dO, then lse log2e and D for its 64 queries
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 2 * QT * 4;
  static constexpr size_t SMEM = 1024 + 2 * size_t(KV_BYTES) +
                                 size_t(NSTAGE) * STAGE_BYTES +
                                 8 * (1 + 2 * NSTAGE);
};

// grid (Hq, key tiles, B); pdk / pdv are (B, Hq, S, D) f32
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const float* __restrict__ lse, const float* __restrict__ Dsum,
                 float* __restrict__ pdk, float* __restrict__ pdv, int Hq,
                 int Hkv, int Tq, int S, float scale, int causal,
                 int has_window, int window) {
  using C = DkdvCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sV = sK + C::KV_BYTES;
  uint8_t* ring = sV + C::KV_BYTES;      // stage s at ring + s STAGE_BYTES
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(ring + NSTAGE * C::STAGE_BYTES);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NSTAGE;

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * KV_ROWS;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;      // bottom-right alignment
  const size_t qoff = (size_t(b) * Hq + h) * size_t(Tq);

  // the query tiles that may see a key of this block
  const int k_last = min(k0 + KV_ROWS, S) - 1;
  const int q_lo = causal ? max(0, k0 - offset) : 0;
  const int q_hi = has_window ? min(Tq, k_last + window - offset) : Tq;
  const int qt0 = (q_lo / QT) * QT;
  const int n_tiles = q_hi > qt0 ? (q_hi - qt0 + QT - 1) / QT : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      // the TMA thread's arrival and one from each lane that stored lse / D
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (tid < 256 + 32) {
      const int lane = tid - 256;
      if (lane == 0) {
        prefetch_tensormap(&mq);
        prefetch_tensormap(&mdo);
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
        load_tile<D, KV_ROWS>(sK, &mk, kv_full, k0, b * Hkv + hk);
        load_tile<D, KV_ROWS>(sV, &mv, kv_full, k0, b * Hkv + hk);
      }
      int stage = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int q0 = qt0 + j * QT;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * C::STAGE_BYTES;
        // lse in log2 units, +inf where p must be 0 (past T, or a row
        // with no allowed key): exp2(s - inf) = 0
        float* sl = reinterpret_cast<float*>(st + 2 * C::Q_BYTES);
        float* sd = sl + QT;
        for (int r = lane; r < QT; r += 32) {
          const int qi = q0 + r;
          const float L = qi < Tq ? lse[qoff + qi] : -INFINITY;
          sl[r] = L == -INFINITY ? INFINITY : L * LOG2E;
          sd[r] = qi < Tq ? Dsum[qoff + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * C::Q_BYTES);
          load_tile<D, QT>(st, &mq, &full[stage], q0, b * Hq + h);
          load_tile<D, QT>(st + C::Q_BYTES, &mdo, &full[stage], q0,
                           b * Hq + h);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    const int t = tid % 128;
    const int lane = t % 32;
    const int r_in = (t / 32) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int kw0 = k0 + wg * 64;          // this warpgroup's keys
    const float scale_log2 = scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t kaddr = smem_u32(sK), vaddr = smem_u32(sV);
    mbar_wait(kv_full, 0);

    int stage = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int q0 = qt0 + j * QT;
      mbar_wait(&full[stage], phase);
      const bool hidden =
          (causal && kw0 > q0 + QT - 1 + offset) ||
          (has_window && kw0 + 63 <= q0 + offset - window);
      if (!hidden) {
        uint8_t* st = ring + stage * C::STAGE_BYTES;
        const uint32_t qaddr = smem_u32(st);
        const uint32_t doaddr = smem_u32(st + C::Q_BYTES);
        const float* sl = reinterpret_cast<const float*>(st + 2 * C::Q_BYTES);
        const float* sd = sl + QT;
        float s[QT / 2], dp[QT / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, desc_k<D, KV_ROWS>(kaddr, wg * 64, kk),
                   desc_k<D, QT>(qaddr, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, desc_k<D, KV_ROWS>(vaddr, wg * 64, kk),
                   desc_k<D, QT>(doaddr, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // rows are keys, columns queries
        const bool masked =
            (causal && kw0 + 63 > q0 + offset) ||
            (has_window && kw0 <= q0 + QT - 1 + offset - window);
#pragma unroll
        for (int n = 0; n < QT / 8; ++n)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = 8 * n + cq + jj;
            const float L = sl[c], Dc = sd[c];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * n + 2 * i + jj;
              float p = exp2f(fmaf(s[x], scale_log2, -L));
              if (masked) {
                const int kpos = kw0 + r_in + 8 * i;
                const int qpos = q0 + c + offset;
                const bool ok = (!causal || kpos <= qpos) &&
                                (!has_window || kpos > qpos - window);
                p = ok ? p : 0.f;
              }
              s[x] = p;
              dp[x] = p * (dp[x] - Dc);
            }
          }

        uint32_t pa[QT / 16][4], dsa[QT / 16][4];
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          to_a_frag(s, kk, pa[kk]);
          to_a_frag(dp, kk, dsa[kk]);
        }
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          wgmma_rs(dv, pa[kk], desc_mn<D, QT>(doaddr, kk), 1);
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          wgmma_rs(dk, dsa[kk], desc_mn<D, QT>(qaddr, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
    }

    const size_t poff = (size_t(b) * Hq + h) * size_t(S) * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = kw0 + r_in + 8 * i;
      if (r >= S) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const size_t e = poff + size_t(r) * D + 8 * n + cq;
        *reinterpret_cast<float2*>(pdk + e) = make_float2(
            dk[4 * n + 2 * i] * scale, dk[4 * n + 2 * i + 1] * scale);
        *reinterpret_cast<float2*>(pdv + e) =
            make_float2(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------- dk / dv, D 256
// At head dim 256 the tiles above do not fit: K and V of 128 keys take
// 128 KB and a ring stage of (Q, dO) 64 KB, and dk and dv of 64 keys x 256
// columns in f32 would be 256 registers a consumer thread.  So a block
// takes 64 keys and the two consumer warpgroups split the work twice:
//   * S^T = K Q^T and dP^T = V dO^T over the full 256 columns (SS wgmmas,
//     m64n32): warpgroup w takes the tile's queries [32 w, 32 w + 32);
//     each rounds its P^T and dS^T to bf16 into one shared 64 x 64 tile
//     apiece (a named barrier between the consumers, then one more);
//   * dV += P^T dO and dK += dS^T Q (SS wgmmas, m64n128, P^T and dS^T as
//     the K-major A, dO and Q as the MN-major B): warpgroup w owns columns
//     [128 w, 128 w + 128) of dk and dv, 128 accumulator registers.
// K and V (64 KB), two ring stages of (Q, dO) (128 KB) and P^T and dS^T
// (16 KB) take 210 KB.  A block walks the query tiles of `hg` query heads
// of one KV head in turn and writes their summed dk and dv as one part:
// the parts (B, Hq / hg, S, 256) f32 are summed in head order by
// dkdv_reduce.  hg is chosen by the caller (kernel.py) as the most heads
// that still leave a block for every SM; at recurrentgemma-9b's training
// shape (Hq 16 over one KV head, S 4096) it is 4: 256 blocks, and parts of
// 67 MB instead of 268 MB.
constexpr int K2_ROWS = 64;     // keys per block at D 256

struct Dkdv256Cfg {
  static constexpr int D = 256;
  static constexpr int KV_BYTES = K2_ROWS * D * 2;
  static constexpr int Q_BYTES = QT * D * 2;
  static constexpr int PT_BYTES = K2_ROWS * QT * 2;    // P^T or dS^T, bf16
  // K, V, the ring of (Q, dO), P^T, dS^T (all 1024-aligned), then lse
  // log2e and D for each stage's queries, then the barriers
  static constexpr int OFF_RING = 2 * KV_BYTES;
  static constexpr int OFF_P = OFF_RING + NSTAGE * 2 * Q_BYTES;
  static constexpr int OFF_DS = OFF_P + PT_BYTES;
  static constexpr int OFF_LD = OFF_DS + PT_BYTES;
  static constexpr int OFF_BAR = OFF_LD + NSTAGE * 2 * QT * 4;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * NSTAGE);
};

// element (row, col) of a 64 x 64 bf16 tile of 128-byte rows, swizzled as
// TMA's SWIZZLE_128B lays a tile (Geo<64>), so that desc_k<64, 64> reads it
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// grid (Hq / hg, key tiles, B); pdk / pdv are (B, Hq / hg, S, 256) f32
__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_d256_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const float* __restrict__ lse, const float* __restrict__ Dsum,
                 float* __restrict__ pdk, float* __restrict__ pdv, int Hq,
                 int Hkv, int Tq, int S, int hg, float scale, int causal,
                 int has_window, int window) {
  using C = Dkdv256Cfg;
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sK = base;
  uint8_t* sV = base + C::KV_BYTES;
  uint8_t* ring = base + C::OFF_RING;     // stage s: Q, then dO
  uint8_t* sP = base + C::OFF_P;
  uint8_t* sDS = base + C::OFF_DS;
  float* sLD = reinterpret_cast<float*>(base + C::OFF_LD);  // [s][2][QT]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NSTAGE;

  const int h0 = blockIdx.x * hg;         // the first of this block's heads
  const int k0 = blockIdx.y * K2_ROWS;
  const int b = blockIdx.z;
  const int hk = h0 / (Hq / Hkv);
  const int offset = S - Tq;

  const int k_last = min(k0 + K2_ROWS, S) - 1;
  const int q_lo = causal ? max(0, k0 - offset) : 0;
  const int q_hi = has_window ? min(Tq, k_last + window - offset) : Tq;
  const int qt0 = (q_lo / QT) * QT;
  const int n_tiles = q_hi > qt0 ? (q_hi - qt0 + QT - 1) / QT : 0;
  const int n_iter = hg * n_tiles;        // (head, query tile) pairs

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (tid < 256 + 32) {
      const int lane = tid - 256;
      if (lane == 0) {
        prefetch_tensormap(&mq);
        prefetch_tensormap(&mdo);
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
        load_tile<D, K2_ROWS>(sK, &mk, kv_full, k0, b * Hkv + hk);
        load_tile<D, K2_ROWS>(sV, &mv, kv_full, k0, b * Hkv + hk);
      }
      int stage = 0, phase = 0;
      for (int j = 0; j < n_iter; ++j) {
        const int h = h0 + j / n_tiles;
        const int q0 = qt0 + (j % n_tiles) * QT;
        const size_t qoff = (size_t(b) * Hq + h) * size_t(Tq);
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * C::Q_BYTES;
        float* sl = sLD + stage * 2 * QT;
        float* sd = sl + QT;
        for (int r = lane; r < QT; r += 32) {
          const int qi = q0 + r;
          const float L = qi < Tq ? lse[qoff + qi] : -INFINITY;
          sl[r] = L == -INFINITY ? INFINITY : L * LOG2E;
          sd[r] = qi < Tq ? Dsum[qoff + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * C::Q_BYTES);
          load_tile<D, QT>(st, &mq, &full[stage], q0, b * Hq + h);
          load_tile<D, QT>(st + C::Q_BYTES, &mdo, &full[stage], q0,
                           b * Hq + h);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = tid % 128;
    const int lane = t % 32;
    const int r_in = (t / 32) * 16 + lane / 4;   // key rows r_in, r_in + 8
    const int cq = 2 * (lane % 4);
    const int qw = 32 * wg;                      // this warpgroup's queries
    const float scale_log2 = scale * LOG2E;

    float dk[64], dv[64];     // columns [128 wg, 128 wg + 128)
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t kaddr = smem_u32(sK), vaddr = smem_u32(sV);
    const uint32_t paddr = smem_u32(sP), dsaddr = smem_u32(sDS);
    mbar_wait(kv_full, 0);

    int stage = 0, phase = 0;
    for (int j = 0; j < n_iter; ++j) {
      const int q0 = qt0 + (j % n_tiles) * QT;
      mbar_wait(&full[stage], phase);
      // decided for the whole tile, so that both warpgroups meet at the
      // named barriers below
      const bool hidden =
          (causal && k0 > q0 + QT - 1 + offset) ||
          (has_window && k0 + K2_ROWS - 1 <= q0 + offset - window);
      if (!hidden) {
        uint8_t* st = ring + stage * 2 * C::Q_BYTES;
        const uint32_t qaddr = smem_u32(st);
        const uint32_t doaddr = smem_u32(st + C::Q_BYTES);
        const float* sl = sLD + stage * 2 * QT;
        const float* sd = sl + QT;
        float s[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, desc_k<D, K2_ROWS>(kaddr, 0, kk),
                   desc_k<D, QT>(qaddr, qw, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, desc_k<D, K2_ROWS>(vaddr, 0, kk),
                   desc_k<D, QT>(doaddr, qw, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // rows are keys, columns this warpgroup's queries
        const bool masked =
            (causal && k0 + K2_ROWS - 1 > q0 + offset) ||
            (has_window && k0 <= q0 + QT - 1 + offset - window);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = qw + 8 * n + cq + jj;
            const float L = sl[c], Dc = sd[c];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * n + 2 * i + jj;
              float p = exp2f(fmaf(s[x], scale_log2, -L));
              if (masked) {
                const int kpos = k0 + r_in + 8 * i;
                const int qpos = q0 + c + offset;
                const bool ok = (!causal || kpos <= qpos) &&
                                (!has_window || kpos > qpos - window);
                p = ok ? p : 0.f;
              }
              s[x] = p;
              dp[x] = p * (dp[x] - Dc);
            }
          }

        // the last tile's products have read P^T and dS^T (each
        // warpgroup waited for its own): overwrite them
        named_barrier(1, 256);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t off = swz128(r_in + 8 * i, qw + 8 * n + cq);
            *reinterpret_cast<uint32_t*>(sP + off) =
                pack_bf16(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]);
            *reinterpret_cast<uint32_t*>(sDS + off) =
                pack_bf16(dp[4 * n + 2 * i], dp[4 * n + 2 * i + 1]);
          }
        fence_proxy_async();    // the generic stores before wgmma reads
        named_barrier(2, 256);

        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          wgmma_ss_mn(dv, desc_k<64, 64>(paddr, 0, kk),
                      desc_mn<D, QT>(doaddr, kk, 2 * wg), 1);
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          wgmma_ss_mn(dk, desc_k<64, 64>(dsaddr, 0, kk),
                      desc_mn<D, QT>(qaddr, kk, 2 * wg), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
    }

    const size_t poff = (size_t(b) * (Hq / hg) + blockIdx.x) * size_t(S) * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = k0 + r_in + 8 * i;
      if (r >= S) continue;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const size_t e = poff + size_t(r) * D + 128 * wg + 8 * n + cq;
        *reinterpret_cast<float2*>(pdk + e) = make_float2(
            dk[4 * n + 2 * i] * scale, dk[4 * n + 2 * i + 1] * scale);
        *reinterpret_cast<float2*>(pdv + e) =
            make_float2(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------- dk / dv, D 160
// At head dim 160 (pixtral-12b) neither design above fits.  The D <= 128
// one would keep dk and dv of 64 keys x 160 columns (160 f32 registers a
// thread) beside S^T and dP^T of 64 queries (64 more) and their bf16
// fragments; the D 256 one splits dK and dV by columns, but 160 columns are
// five 64-byte boxes, which two warpgroups cannot halve on a box boundary.
// So a block takes 64 keys and the consumers split the query tile instead:
//   * warpgroup w takes queries [32 w, 32 w + 32) of each 64-query tile:
//     S^T = K Q^T and dP^T = V dO^T over them (SS wgmmas, m64n32), P^T and
//     dS^T rounded to bf16 in registers;
//   * dV += P^T dO and dK += dS^T Q over the same 32 queries (RS wgmmas,
//     m64n160: dO and Q as the MN-major B, all five boxes), so each
//     warpgroup holds a partial dk and dv of all 160 columns (160
//     registers, S^T and dP^T 32 more);
//   * after the last tile, warpgroup 1 leaves its partials in the ring
//     (128 threads x 160 f32, exactly the ring's 80 KB) and warpgroup 0
//     adds them, in the same order for every block, and writes the part.
// K and V (40 KB), two ring stages of (Q, dO) (80 KB) and lse / D take
// 121 KB.  One part per query head, as below D 256.
template <int D>
struct DkdvQsplitCfg {
  static constexpr int KV_BYTES = K2_ROWS * D * 2;
  static constexpr int Q_BYTES = QT * D * 2;
  static constexpr int OFF_RING = 2 * KV_BYTES;
  static constexpr int RING_BYTES = NSTAGE * 2 * Q_BYTES;
  static constexpr int OFF_LD = OFF_RING + RING_BYTES;
  static constexpr int OFF_BAR = OFF_LD + NSTAGE * 2 * QT * 4;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * NSTAGE);
  static_assert(RING_BYTES >= 128 * D * 4, "the ring holds the partials");
};

// grid (Hq, key tiles, B); pdk / pdv are (B, Hq, S, D) f32
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_qsplit_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ Dsum, float* __restrict__ pdk,
                   float* __restrict__ pdv, int Hq, int Hkv, int Tq, int S,
                   float scale, int causal, int has_window, int window) {
  using C = DkdvQsplitCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sK = base;
  uint8_t* sV = base + C::KV_BYTES;
  uint8_t* ring = base + C::OFF_RING;     // stage s: Q, then dO
  float* sLD = reinterpret_cast<float*>(base + C::OFF_LD);  // [s][2][QT]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NSTAGE;

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * K2_ROWS;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;
  const size_t qoff = (size_t(b) * Hq + h) * size_t(Tq);

  const int k_last = min(k0 + K2_ROWS, S) - 1;
  const int q_lo = causal ? max(0, k0 - offset) : 0;
  const int q_hi = has_window ? min(Tq, k_last + window - offset) : Tq;
  const int qt0 = (q_lo / QT) * QT;
  const int n_tiles = q_hi > qt0 ? (q_hi - qt0 + QT - 1) / QT : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (tid < 256 + 32) {
      const int lane = tid - 256;
      if (lane == 0) {
        prefetch_tensormap(&mq);
        prefetch_tensormap(&mdo);
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
        load_tile<D, K2_ROWS>(sK, &mk, kv_full, k0, b * Hkv + hk);
        load_tile<D, K2_ROWS>(sV, &mv, kv_full, k0, b * Hkv + hk);
      }
      int stage = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int q0 = qt0 + j * QT;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * C::Q_BYTES;
        float* sl = sLD + stage * 2 * QT;
        float* sd = sl + QT;
        for (int r = lane; r < QT; r += 32) {
          const int qi = q0 + r;
          const float L = qi < Tq ? lse[qoff + qi] : -INFINITY;
          sl[r] = L == -INFINITY ? INFINITY : L * LOG2E;
          sd[r] = qi < Tq ? Dsum[qoff + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * C::Q_BYTES);
          load_tile<D, QT>(st, &mq, &full[stage], q0, b * Hq + h);
          load_tile<D, QT>(st + C::Q_BYTES, &mdo, &full[stage], q0,
                           b * Hq + h);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = tid % 128;
    const int lane = t % 32;
    const int r_in = (t / 32) * 16 + lane / 4;   // key rows r_in, r_in + 8
    const int cq = 2 * (lane % 4);
    const int qw = 32 * wg;                      // this warpgroup's queries
    const float scale_log2 = scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t kaddr = smem_u32(sK), vaddr = smem_u32(sV);
    mbar_wait(kv_full, 0);

    int stage = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int q0 = qt0 + j * QT;
      mbar_wait(&full[stage], phase);
      const int qa = q0 + qw;                    // this warpgroup's first
      const bool hidden =
          (causal && k0 > qa + 31 + offset) ||
          (has_window && k0 + K2_ROWS - 1 <= qa + offset - window);
      if (!hidden) {
        uint8_t* st = ring + stage * 2 * C::Q_BYTES;
        const uint32_t qaddr = smem_u32(st);
        const uint32_t doaddr = smem_u32(st + C::Q_BYTES);
        const float* sl = sLD + stage * 2 * QT;
        const float* sd = sl + QT;
        float s[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, desc_k<D, K2_ROWS>(kaddr, 0, kk),
                   desc_k<D, QT>(qaddr, qw, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, desc_k<D, K2_ROWS>(vaddr, 0, kk),
                   desc_k<D, QT>(doaddr, qw, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // rows are keys, columns this warpgroup's queries
        const bool masked =
            (causal && k0 + K2_ROWS - 1 > qa + offset) ||
            (has_window && k0 <= qa + 31 + offset - window);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = qw + 8 * n + cq + jj;
            const float L = sl[c], Dc = sd[c];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * n + 2 * i + jj;
              float p = exp2f(fmaf(s[x], scale_log2, -L));
              if (masked) {
                const int kpos = k0 + r_in + 8 * i;
                const int qpos = q0 + c + offset;
                const bool ok = (!causal || kpos <= qpos) &&
                                (!has_window || kpos > qpos - window);
                p = ok ? p : 0.f;
              }
              s[x] = p;
              dp[x] = p * (dp[x] - Dc);
            }
          }

        uint32_t pa[2][4], dsa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          to_a_frag(s, kk, pa[kk]);
          to_a_frag(dp, kk, dsa[kk]);
        }
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
        // rows [qw + 16 kk, qw + 16 kk + 16) of the tile's dO and Q
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs(dv, pa[kk], desc_mn<D, QT>(doaddr, 2 * wg + kk), 1);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs(dk, dsa[kk], desc_mn<D, QT>(qaddr, 2 * wg + kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
    }

    // every tile has landed and been read by both warpgroups: the ring is
    // free.  Warpgroup 1's partials go there, element i of thread t at
    // [i][t] (conflict-free), and warpgroup 0 adds them.
    float* red = reinterpret_cast<float*>(ring);
    named_barrier(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        red[i * 128 + t] = dk[i];
        red[(D / 2 + i) * 128 + t] = dv[i];
      }
    }
    named_barrier(2, 256);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk[i] += red[i * 128 + t];
        dv[i] += red[(D / 2 + i) * 128 + t];
      }
      const size_t poff = (size_t(b) * Hq + h) * size_t(S) * D;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = k0 + r_in + 8 * i;
        if (r >= S) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const size_t e = poff + size_t(r) * D + 8 * n + cq;
          *reinterpret_cast<float2*>(pdk + e) = make_float2(
              dk[4 * n + 2 * i] * scale, dk[4 * n + 2 * i + 1] * scale);
          *reinterpret_cast<float2*>(pdv + e) =
              make_float2(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

// --------------------------------------------------------------------- dq
constexpr int Q_ROWS = 128;     // queries per dq block, 64 per consumer

// KT keys per ring tile: 64 up to head dim 160 (at 160 Q and dO of 128
// queries take 80 KB, two stages of K and V another 80), 32 at 256 (where
// Q and dO take 128 KB)
template <int D, int KT>
struct DqCfg {
  static constexpr int Q_BYTES = Q_ROWS * D * 2;
  static constexpr int K_BYTES = KT * D * 2;
  static constexpr size_t SMEM = 1024 + 2 * size_t(Q_BYTES) +
                                 size_t(NSTAGE) * 2 * K_BYTES +
                                 8 * (1 + 2 * NSTAGE);
};

// grid (Hq, query tiles, B), the last query tile first; K and V maps of
// KT-row boxes
template <int D, int KT>
__global__ void __launch_bounds__(NTHREADS, 1)
dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mdo,
               const float* __restrict__ lse, const float* __restrict__ Dsum,
               __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Tq, int S,
               float scale, int causal, int has_window, int window) {
  using C = DqCfg<D, KT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sdO = sQ + C::Q_BYTES;
  uint8_t* sK = sdO + C::Q_BYTES;           // stage s at sK + s K_BYTES
  uint8_t* sV = sK + NSTAGE * C::K_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + NSTAGE * C::K_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NSTAGE;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Q_ROWS;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;
  const size_t qoff = (size_t(b) * Hq + h) * size_t(Tq);

  const int qpos_lo = q0 + offset;
  const int qpos_hi = min(q0 + Q_ROWS, Tq) - 1 + offset;
  const int k_end = causal ? min(S, qpos_hi + 1) : S;
  const int k_begin = has_window ? max(0, qpos_lo - window + 1) : 0;
  const int kt0 = (k_begin / KT) * KT;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + KT - 1) / KT : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (tid == 256) {
      prefetch_tensormap(&mk);
      prefetch_tensormap(&mv);
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      load_tile<D, Q_ROWS>(sQ, &mq, q_full, q0, b * Hq + h);
      load_tile<D, Q_ROWS>(sdO, &mdo, q_full, q0, b * Hq + h);
      int stage = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * C::K_BYTES);
        const int k0 = kt0 + j * KT;
        load_tile<D, KT, KT>(sK + stage * C::K_BYTES, &mk, &full[stage],
                             k0, b * Hkv + hk);
        load_tile<D, KT, KT>(sV + stage * C::K_BYTES, &mv, &full[stage],
                             k0, b * Hkv + hk);
        if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = tid % 128;
    const int lane = t % 32;
    const int r_in = (t / 32) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int wq_lo = q0 + wg * 64;
    const int wq_hi = wq_lo + 63;
    const int row0 = wq_lo + r_in;
    const float scale_log2 = scale * LOG2E;

    // each thread's two rows: lse in log2 units (+inf: p = 0) and D
    float L[2], Dr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      const float x = qi < Tq ? lse[qoff + qi] : -INFINITY;
      L[i] = x == -INFINITY ? INFINITY : x * LOG2E;
      Dr[i] = qi < Tq ? Dsum[qoff + qi] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t qaddr = smem_u32(sQ), doaddr = smem_u32(sdO);
    mbar_wait(q_full, 0);

    int stage = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = kt0 + j * KT;
      mbar_wait(&full[stage], phase);
      const bool hidden =
          (causal && k0 > wq_hi + offset) ||
          (has_window && k0 + KT - 1 <= wq_lo + offset - window);
      if (!hidden) {
        const uint32_t kaddr = smem_u32(sK + stage * C::K_BYTES);
        const uint32_t vaddr = smem_u32(sV + stage * C::K_BYTES);
        float s[KT / 2], dp[KT / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s, desc_k<D, Q_ROWS>(qaddr, wg * 64, kk),
                   desc_k<D, KT>(kaddr, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, desc_k<D, Q_ROWS>(doaddr, wg * 64, kk),
                   desc_k<D, KT>(vaddr, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        const bool masked =
            k0 + KT > S || (causal && k0 + KT - 1 > wq_lo + offset) ||
            (has_window && k0 <= wq_hi + offset - window);
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int x = 4 * n + 2 * i + jj;
              float p = exp2f(fmaf(s[x], scale_log2, -L[i]));
              if (masked) {
                const int kpos = k0 + 8 * n + cq + jj;
                const int qpos = row0 + 8 * i + offset;
                const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                                (!has_window || kpos > qpos - window);
                p = ok ? p : 0.f;
              }
              dp[x] = p * (dp[x] - Dr[i]);
            }

        uint32_t dsa[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) to_a_frag(dp, kk, dsa[kk]);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma_rs(acc, dsa[kk], desc_mn<D, KT>(kaddr, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Tq) continue;
      __nv_bfloat16* drow = dq + (qoff + row) * D + cq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(drow + 8 * n) = pack_bf16(
            acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* Dsum, void* part, void* dq, void* dk, void* dv,
                   int B, int Hq, int Hkv, int Tq, int S, int hg, float scale,
                   int causal, int has_window, int window, cudaStream_t st) {
  // the dk/dv design: 128 keys a block below 160, 64 keys split by
  // queries at 160, by columns at 256
  constexpr bool WIDE = D == 256, QSPLIT = D == 160;
  constexpr int KT = WIDE ? 32 : 64;     // dq's key tile
  constexpr size_t smem_kv = WIDE     ? Dkdv256Cfg::SMEM
                             : QSPLIT ? DkdvQsplitCfg<D>::SMEM
                                      : DkdvCfg<D>::SMEM;
  constexpr size_t smem_q = DqCfg<D, KT>::SMEM;
  static bool configured = false;   // the attributes are per kernel, once
  if (!configured) {
    cudaError_t e;
    if constexpr (WIDE)
      e = cudaFuncSetAttribute(dkdv_d256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_kv));
    else if constexpr (QSPLIT)
      e = cudaFuncSetAttribute(dkdv_qsplit_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_kv));
    else
      e = cudaFuncSetAttribute(dkdv_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_kv));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dq_sm90_kernel<D, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_q));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // S = 0 loads no key tile; its maps only have to be valid
  const void* kp = S > 0 ? k : q;
  const void* vp = S > 0 ? v : q;
  const int kv_rows = max(S, 1), kv_heads = S > 0 ? B * Hkv : 1;
  CUtensorMap mq, mk, mv, mdo, mkq, mvq;   // mkq / mvq: dq's KT-row boxes
  cudaError_t e = make_map<D>(&mq, q, Tq, B * Hq);
  if (e == cudaSuccess) e = make_map<D>(&mdo, dout, Tq, B * Hq);
  if (e == cudaSuccess) e = make_map<D>(&mk, kp, kv_rows, kv_heads);
  if (e == cudaSuccess) e = make_map<D>(&mv, vp, kv_rows, kv_heads);
  if (e == cudaSuccess) e = make_map<D>(&mkq, kp, kv_rows, kv_heads, KT);
  if (e == cudaSuccess) e = make_map<D>(&mvq, vp, kv_rows, kv_heads, KT);
  if (e != cudaSuccess) return e;
  const float* lp = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(Dsum);
  const int64_t rows = int64_t(B) * Hq * Tq;
  rowdot_kernel<<<unsigned((rows + 7) / 8), RD_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), Dp, rows, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (S > 0) {
    float* pdk = static_cast<float*>(part);
    float* pdv = pdk + size_t(B) * (Hq / hg) * S * D;
    if constexpr (WIDE) {
      dim3 gkv(Hq / hg, (S + K2_ROWS - 1) / K2_ROWS, B);
      dkdv_d256_kernel<<<gkv, NTHREADS, smem_kv, st>>>(
          mq, mk, mv, mdo, lp, Dp, pdk, pdv, Hq, Hkv, Tq, S, hg, scale,
          causal, has_window, window);
    } else if constexpr (QSPLIT) {
      dim3 gkv(Hq, (S + K2_ROWS - 1) / K2_ROWS, B);
      dkdv_qsplit_kernel<D><<<gkv, NTHREADS, smem_kv, st>>>(
          mq, mk, mv, mdo, lp, Dp, pdk, pdv, Hq, Hkv, Tq, S, scale, causal,
          has_window, window);
    } else {
      dim3 gkv(Hq, (S + KV_ROWS - 1) / KV_ROWS, B);
      dkdv_sm90_kernel<D><<<gkv, NTHREADS, smem_kv, st>>>(
          mq, mk, mv, mdo, lp, Dp, pdk, pdv, Hq, Hkv, Tq, S, scale, causal,
          has_window, window);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    // a grid-stride loop; the cap only bounds the grid
    const int64_t n = int64_t(B) * Hkv * S * D;
    const int64_t blocks =
        std::min<int64_t>((n + RD_THREADS - 1) / RD_THREADS, 4096);
    dkdv_reduce_kernel<<<unsigned(blocks), RD_THREADS, 0, st>>>(
        pdk, pdv, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), int64_t(S) * D, n, Hq / Hkv / hg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  dim3 gq(Hq, (Tq + Q_ROWS - 1) / Q_ROWS, B);
  dq_sm90_kernel<D, KT><<<gq, NTHREADS, smem_q, st>>>(
      mq, mkq, mvq, mdo, lp, Dp, static_cast<__nv_bfloat16*>(dq), Hq, Hkv,
      Tq, S, scale, causal, has_window, window);
  return cudaGetLastError();
}

}  // namespace

// bf16 only (dtype 1).  q, out, dout, dq (B, Hq, T, D); k, v, dk, dv (B,
// Hkv, S, D); lse and the scratch Dsum (B, Hq, T) f32; the scratch `part`
// (2, B, Hq / hg, S, D) f32 (dk and dv summed over each group of hg query
// heads; hg divides Hq / Hkv, and is 1 below D 256); all contiguous,
// q/k/v/dout 16-byte aligned (TMA); D in {32, 64, 128, 160, 256}.  Launches
// the four kernels on `stream` without synchronising and returns the
// first error.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* Dsum, void* part,
                              void* dq, void* dk, void* dv, int B, int Hq,
                              int Hkv, int Tq, int S, int D, float scale,
                              int causal, int has_window, int window,
                              int dtype, int hg, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Tq <= 0 || S < 0 || Hq % Hkv != 0 ||
      dtype != 1 || hg <= 0 || (Hq / Hkv) % hg != 0 || (D != 256 && hg != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_SM90_LAUNCH(DIM)                                         \
  int(launch<DIM>(q, k, v, out, dout, lse, Dsum, part, dq, dk, dv, B, Hq, \
                  Hkv, Tq, S, hg, scale, causal, has_window, window, st))
  switch (D) {
    case 32: return FLASH_BWD_SM90_LAUNCH(32);
    case 64: return FLASH_BWD_SM90_LAUNCH(64);
    case 128: return FLASH_BWD_SM90_LAUNCH(128);
    case 160: return FLASH_BWD_SM90_LAUNCH(160);
    case 256: return FLASH_BWD_SM90_LAUNCH(256);
    default: return int(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_SM90_LAUNCH
}

extern "C" const char* flash_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
