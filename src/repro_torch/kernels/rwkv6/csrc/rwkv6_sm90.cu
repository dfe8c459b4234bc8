// RWKV-6 (Finch) time-mix recurrence for Hopper (sm_90a), bf16 r/k/v, in
// the chunked form on the tensor cores: K6 for prefill.
//
// Replaces rwkv6_pallas (src/repro/kernels/rwkv6/kernel.py:86; body
// _rwkv6_kernel :38) for bf16 r/k/v; ops.py routes f32 inputs and short
// calls (a decode step) to the sequential kernel of rwkv6.cu.  Per
// (batch, head), with the f32 state S (Dk x Dv), chunks of C = 64 tokens,
// w = exp(max(log_w, -30)) (kernel.py:35, :53), L the inclusive cumulative
// log-decay inside the chunk and Lx = L - log_w:
//
//   o   = (r . exp(Lx)) S  +  A v,   A[t][i] = sum_c r_t k_i exp(Lx_t - L_i)
//         for i < t, A[t][t] = sum_c r_t u k_t
//   S  <- exp(L_C) . S  +  (k . exp(L_C - L))^T v
//
// What bounds it.  At rwkv6-7b's prefill (B 4, H 64, T 512, D 64) the
// bytes (r, k, v, o in bf16, log_w, s0, sT in f32: 109 MB) take 0.033 ms
// at 3.35 TB/s; the four products a chunk, 4.3 GFLOP (about twice that
// as the split products below run them), 0.004 ms at the bf16 tensor
// rate.  So: stream the inputs once, and keep the f32 elementwise work,
// which no tensor core does, off the loads' critical path.
//
// Layout.  One CTA of four warps per (b, h) walks the chunks in order; warp
// q owns sub-chunk q (16 tokens) of each chunk.  TMA brings chunk n + 1's
// r, k and log_w (one mbarrier) as soon as chunk n's elementwise pass has
// read them, and its v (another) once chunk n's products are done; rows
// past T arrive as zeros (3-d maps), so a ragged chunk is padded with k =
// 0 and log_w = 0, which leaves the state exact.  About 104 KB of shared
// memory a CTA at D = 64: two CTAs fit on an SM, so the 256 CTAs of the
// prefill shape are all resident at once.
//
// No overflow for any decay.  The Pallas kernel builds the (C, C, D)
// pairwise decays (1 MiB here) because the k / exp(L) normalisation
// overflows.  Here every decay factor is a product of w's, so it lies in
// [0, 1]:
//   * One thread per channel walks its sub-chunk's 16 tokens: w (the only
//     exp, one a token and channel), Q_t = r_t prod w from the start of
//     t's half-sub-chunk (8 tokens) and E_i = k_i prod w to the end of
//     i's half, and the halves' decays U (second) and L (first).  A
//     table of their per-channel products over sub-chunks follows.
//   * Keys of an earlier sub-chunk a take the start of q as reference
//     point: A[t][i] = (Q_t ...) . (E_i prod_{a < x < q} W_x ...), both
//     factors in [0, 1], their product exactly the pair's decay.  The
//     same E_i times prod_{x > a} W_x is k . exp(L_C - L) for the state,
//     and Q_t times prod_{x < q} W_x is r . exp(Lx) for o's inter-chunk
//     term.
//   * Inside a sub-chunk, the 8 x 8 block of queries 8..15 against keys
//     0..7 takes token 8 as reference point (Q and E as they are); the
//     pairs inside 8 tokens and the bonus are f32 sums on CUDA cores:
//     each lane holds 8 rows of r and w for a few channels and walks
//     every key forward with a running decay (one multiply a step, no
//     exp), and a butterfly over the lanes reduces the 36 entries.
//
// Products (mma.sync m16n8k16, bf16 in, f32 accumulators).  Every product
// has an operand built in registers from f32 values (decay-scaled r or k,
// A, the state), which mma.sync takes from registers as they are; v and
// the split state come through ldmatrix from swizzled tiles.  A single
// bf16 rounding of those f32 operands would miss RWKV_TOL on the state
// (3.2e-3 against atol 2e-3, tests/test_torch_rwkv6_chunked_split.py), so
// each is split into bf16 hi + lo: split x split is three products (hi.hi
// + hi.lo + lo.hi), split x exact (v) two.  Warp q computes rows q of
//   o  = (Q_q prod W) S            3 products, S split in shared memory
//   A_q = Q_q K_q^T                3 products over the keys before q
//   o += A_q v                     2 products (A split, v exact)
//   S[rows q] = exp(L_C) S + Kd^T v   2 products (Kd split, v exact)
// so a CTA's state stays in registers, spread over the warps by rows.
//
// Numerics: f32 throughout apart from the split operands (relative error
// about 2^-17 each); expf, no fast math.  No atomics: two runs are
// bit-equal.
#include "../../flash_attention/csrc/sm90.cuh"
#include "chunk.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr float LOG_W_MIN = -30.0f;   // kernel.py:35
constexpr int C = 64;                 // tokens per chunk
constexpr int SUB = 16;               // tokens per sub-chunk (one warp)
constexpr int NTHREADS = 128;         // four warps, one per sub-chunk

// shared-memory geometry for head dim D.  bf16 tiles (r, k, v) are one
// TMA box of C rows x D columns, rows of 2 D bytes swizzled over 2 D bytes
// (SWIZZLE_32B / 64B / 128B); the log_w tile is D / CBW boxes of CBW f32
// columns, each swizzled over CBW * 4 bytes.  The swizzle XORs the 16-byte
// chunk index of an offset by bits 7.. of it (cute's Swizzle<b, 4, 3>);
// every tile starts on 1024 bytes, so offsets and addresses agree.
template <int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64, "head dim");
  static constexpr int RB = 2 * D;              // bf16 row bytes
  static constexpr uint32_t MB = RB / 16 - 1;   // its swizzle mask
  static constexpr int TILE = C * RB;           // bf16 tile bytes
  static constexpr int CBW = D < 32 ? D : 32;   // f32 columns per box
  static constexpr int RBW = CBW * 4;
  static constexpr uint32_t MW = RBW / 16 - 1;
  static constexpr int WTILE = C * D * 4;
  static constexpr int ES = D + 8;              // E row stride, floats
  static constexpr int NK = D / 16;             // k-steps over channels
  static constexpr int NN = D / 8;              // n-tiles over channels
  // r, k, v, S hi and lo (bf16 tiles of the same layout, D x D for S),
  // then log_w, E, Q, the diagonal 8 x 8 blocks of A, the table of decay
  // products and two barriers
  static constexpr int OFF_SH = 3 * TILE;
  static constexpr int OFF_SL = 4 * TILE;
  static constexpr int OFF_W = 5 * TILE;
  static constexpr int OFF_E = OFF_W + WTILE;
  static constexpr int OFF_QH = OFF_E + C * ES * 4;
  static constexpr int OFF_AD = OFF_QH + C * ES * 4;
  static constexpr int OFF_TAB = OFF_AD + 8 * 8 * 9 * 4;
  static constexpr int OFF_BAR = OFF_TAB + T_ROWS * D * 4;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 2 * 8;
};

template <int D>
struct Smem {
  using G = Geo<D>;
  uint8_t* base;
  __device__ const uint8_t* r() const { return base; }
  __device__ const uint8_t* k() const { return base + G::TILE; }
  __device__ const uint8_t* v() const { return base + 2 * G::TILE; }
  // element (row, c) of a bf16 tile
  __device__ static float bf(const uint8_t* t, int row, int c) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
        t + swz(row * G::RB + c * 2, G::MB)));
  }
  // the log_w / w tile
  __device__ float* w(int row, int c) const {
    return reinterpret_cast<float*>(
        base + G::OFF_W + (c / G::CBW) * (C * G::RBW) +
        swz(row * G::RBW + (c % G::CBW) * 4, G::MW));
  }
  __device__ float* e(int row, int c) const {
    return reinterpret_cast<float*>(base + G::OFF_E) + row * G::ES + c;
  }
  // Q_t = r_t times the decay from the start of t's half-sub-chunk
  __device__ float* qh(int row, int c) const {
    return reinterpret_cast<float*>(base + G::OFF_QH) + row * G::ES + c;
  }
  __device__ uint8_t* s_hi() const { return base + G::OFF_SH; }
  __device__ uint8_t* s_lo() const { return base + G::OFF_SL; }
  // warp q's diagonal 8 x 8 block `half` of A, row stride 9
  __device__ float* ad(int q, int half) const {
    return reinterpret_cast<float*>(base + G::OFF_AD) + (2 * q + half) * 72;
  }
  __device__ float* tab(int row) const {
    return reinterpret_cast<float*>(base + G::OFF_TAB) + row * D;
  }
  __device__ uint64_t* bar() const {
    return reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  }
};

// chunk n's r, k and log_w tiles (log_w as D / CBW boxes) on one barrier
template <int D>
__device__ __forceinline__ void load_rkw(const Smem<D>& sm,
                                         const CUtensorMap* mr,
                                         const CUtensorMap* mk,
                                         const CUtensorMap* mw, uint64_t* bar,
                                         int n, int bh) {
  using G = Geo<D>;
  mbar_arrive_expect_tx(bar, 2 * G::TILE + G::WTILE);
  tma_load_3d(sm.base, mr, bar, 0, n * C, bh);
  tma_load_3d(sm.base + G::TILE, mk, bar, 0, n * C, bh);
#pragma unroll
  for (int b = 0; b < D / G::CBW; ++b)
    tma_load_3d(sm.base + G::OFF_W + b * C * G::RBW, mw, bar, b * G::CBW,
                n * C, bh);
}

// chunk n's v tile
template <int D>
__device__ __forceinline__ void load_v(const Smem<D>& sm,
                                       const CUtensorMap* mv, uint64_t* bar,
                                       int n, int bh) {
  using G = Geo<D>;
  mbar_arrive_expect_tx(bar, G::TILE);
  tma_load_3d(sm.base + 2 * G::TILE, mv, bar, 0, n * C, bh);
}

// the split state's rows r0 and r0 + 8 (of an m16 accumulator) into the S
// hi and lo tiles
template <int D>
__device__ __forceinline__ void store_state(const Smem<D>& sm,
                                            const float (&st)[D / 2],
                                            int r0, int tig) {
  using G = Geo<D>;
#pragma unroll
  for (int nt = 0; nt < G::NN; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t hi, lo;
      split2(st[4 * nt + 2 * i], st[4 * nt + 2 * i + 1], hi, lo);
      const uint32_t off =
          swz((r0 + 8 * i) * G::RB + 2 * (8 * nt + 2 * tig), G::MB);
      *reinterpret_cast<uint32_t*>(sm.s_hi() + off) = hi;
      *reinterpret_cast<uint32_t*>(sm.s_lo() + off) = lo;
    }
}

// acc (an m16 x D accumulator, [4 nt + j]) += a b, b rows 16 kk .. 16 kk +
// 15 of a bf16 tile in the shared layout (those rows the reduction, its D
// columns the n dimension): mma.sync per n-tile, B through ldmatrix
template <int D>
__device__ __forceinline__ void prod(float (&acc)[D / 2],
                                     const uint32_t (&a)[4], uint32_t tile,
                                     int kk, int lane) {
  using G = Geo<D>;
  const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < G::NN / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_t(tile + swz(row * G::RB + (16 * np + (lane >> 4) * 8) * 2,
                         G::MB),
              b);
    mma(&acc[8 * np], a, b[0], b[1]);
    mma(&acc[8 * np + 4], a, b[2], b[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
rwkv6_sm90_kernel(const __grid_constant__ CUtensorMap mr,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ sT, int H,
                  int n_tok) {
  using G = Geo<D>;
  constexpr int NK = G::NK, NN = G::NN;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start on 1024 bytes; offsetting the array itself (not a
  // generic integer) keeps every access a shared-memory one
  const Smem<D> sm{smem_raw +
                   ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u)};
  uint64_t* full_rkw = sm.bar();      // r, k and log_w landed
  uint64_t* full_v = sm.bar() + 1;    // v landed

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int q = tid / 32;             // this warp's sub-chunk
  const int lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n_chunks = (n_tok + C - 1) / C;

  if (tid == 0) {
    mbar_init(full_rkw, 1);
    mbar_init(full_v, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    prefetch_tensormap(&mr);
    prefetch_tensormap(&mk);
    prefetch_tensormap(&mv);
    prefetch_tensormap(&mw);
    load_rkw(sm, &mr, &mk, &mw, full_rkw, 0, bh);
    load_v(sm, &mv, full_v, 0, bh);
  }

  // this lane's channels of u, for the bonus; the entries of A's diagonal
  // blocks above their diagonal stay zero
  float ul[D / 16];
#pragma unroll
  for (int e = 0; e < D / 16; ++e)
    ul[e] = u[h * D + (D / 16) * (lane & 15) + e];
  for (int j = tid; j < 8 * 72; j += NTHREADS) sm.ad(0, 0)[j] = 0.f;

  // the state: warp q < D / 16 holds rows 16 q + g and 16 q + g + 8 as an
  // m16 accumulator (columns 8 nt + 2 tig, + 1)
  const bool owns_state = q < D / 16;
  const int sr0 = 16 * q + g;
  float st[D / 2];      // [4 nt + 2 i + j]: row sr0 + 8 i, column 8 nt +
                        // 2 tig + j
  const float* s_in = s0 + size_t(bh) * D * D;
  if (owns_state) {
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x = ld2(s_in + (sr0 + 8 * i) * D + 8 * nt + 2 * tig);
        st[4 * nt + 2 * i] = x.x;
        st[4 * nt + 2 * i + 1] = x.y;
      }
    store_state(sm, st, sr0, tig);
  }

  for (int n = 0; n < n_chunks; ++n) {
    mbar_wait(full_rkw, n & 1);

    // ---- walkers, one thread per channel of sub-chunk q: w = exp(max(
    // log_w, -30)) in place; forwards, Q_t = r_t times the decay from the
    // start of t's half (token 0 or 8) to t - 1; backwards, E_i = k_i
    // prod_{i < j <= 15} w_j on the second half and k_i prod_{i < j <= 7}
    // w_j on the first (token 8 is the reference point of the 8 x 8 block
    // below the diagonal), and the halves' decays U and L
    for (int c = lane; c < D; c += 32) {
      float wv[SUB], kv[SUB], rv[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        wv[j] = *sm.w(SUB * q + j, c);
        kv[j] = Smem<D>::bf(sm.k(), SUB * q + j, c);
        rv[j] = Smem<D>::bf(sm.r(), SUB * q + j, c);
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        wv[j] = expf(fmaxf(wv[j], LOG_W_MIN));
        *sm.w(SUB * q + j, c) = wv[j];
      }
      // forwards, Q_t from the start of t's half
      float run = 1.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j == SUB / 2) run = 1.f;
        *sm.qh(SUB * q + j, c) = rv[j] * run;
        run *= wv[j];
      }
      run = 1.f;
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        if (j == SUB / 2 - 1) {
          sm.tab(T_WUP + q)[c] = run;
          run = 1.f;
        }
        *sm.e(SUB * q + j, c) = kv[j] * run;
        run *= wv[j];
      }
      sm.tab(T_WLO + q)[c] = run;
    }
    fence_proxy_async();    // w's generic writes before a later TMA write
    __syncthreads();

    // ---- the table of decay products, one thread per channel; read
    // after the next barrier
    if (tid < D) build_table<D>(sm.tab(0), tid);

    // ---- A's two diagonal 8 x 8 blocks of sub-chunk q, the pairs inside
    // 8 tokens, on CUDA cores (half_pairs): lanes 16 h .. 16 h + 15 take
    // half h, each its CPL = D / 16 adjacent channels.
    {
      constexpr int CPL = D / 16;
      const int half = lane >> 4, sl = lane & 15;
      const int rb = SUB * q + 8 * half;
      const int c0 = CPL * sl;
      float rr[8][CPL], ww[8][CPL];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        load_bf<CPL>(sm.r() + swz((rb + t) * G::RB + 2 * c0, G::MB), rr[t]);
        load_f<CPL>(sm.w(rb + t, c0), ww[t]);
      }
      float* ad = sm.ad(q, half);
      half_pairs<CPL>(
          rr, ww, ul, sl,
          [&](int i, float (&kd)[CPL]) {
            load_bf<CPL>(sm.k() + swz((rb + i) * G::RB + 2 * c0, G::MB), kd);
          },
          [&](int t, int i, float x) { ad[t * 9 + i] = x; });
    }

    // ---- Q_t = r_t prod_{start <= j < t} w_j from the sub-chunk's start,
    // in the A-fragment layout: rows g and g + 8, columns 16 kk + 2 tig
    // (+1, +8, +9).  q2: rows g + 8 from token 8 on (the walkers' Q), the
    // reference point of the 8 x 8 block below the diagonal; times the
    // first half's decay, Q
    float qv[NK][8];     // [kk][4 half + 2 row + col]
    float q2[NK][4];     // [kk][2 half + col]
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {     // columns c0 and c0 + 8
        const int c = 16 * kk + 2 * tig + 8 * half;
        const float2 a = ld2(sm.qh(SUB * q + g, c));
        const float2 b = ld2(sm.qh(SUB * q + g + 8, c));
        const float2 lo = ld2(sm.tab(T_WLO + q) + c);
        q2[kk][2 * half] = b.x;
        q2[kk][2 * half + 1] = b.y;
        qv[kk][4 * half + 0] = a.x;
        qv[kk][4 * half + 1] = a.y;
        qv[kk][4 * half + 2] = b.x * lo.x;
        qv[kk][4 * half + 3] = b.y * lo.y;
      }
    __syncthreads();     // r, k, w read, the table and A's blocks stored
    if (tid == 0 && n + 1 < n_chunks)
      load_rkw(sm, &mr, &mk, &mw, full_rkw, n + 1, bh);

    // ---- o = (Q prod_{x < q} W_x) S: three products with S split
    float acc_o[D / 2];   // the layout of st, rows 16 q + g (+ 8)
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc_o[j] = 0.f;
    // A regs: (row g, c0..), (row g + 8, c0..), (g, c0 + 8..), (g + 8,
    // c0 + 8..)
    uint32_t ph[NK][4], pl[NK][4];
    {
      const float* pq = sm.tab(T_PQ + q);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const float2 p0 = ld2(pq + 16 * kk + 2 * tig);
        const float2 p1 = ld2(pq + 16 * kk + 2 * tig + 8);
        split2(qv[kk][0] * p0.x, qv[kk][1] * p0.y, ph[kk][0], pl[kk][0]);
        split2(qv[kk][2] * p0.x, qv[kk][3] * p0.y, ph[kk][1], pl[kk][1]);
        split2(qv[kk][4] * p1.x, qv[kk][5] * p1.y, ph[kk][2], pl[kk][2]);
        split2(qv[kk][6] * p1.x, qv[kk][7] * p1.y, ph[kk][3], pl[kk][3]);
      }
      const uint32_t shi = smem_u32(sm.s_hi()), slo = smem_u32(sm.s_lo());
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        prod<D>(acc_o, ph[kk], shi, kk, lane);
        prod<D>(acc_o, ph[kk], slo, kk, lane);
        prod<D>(acc_o, pl[kk], shi, kk, lane);
      }
    }

    // ---- Q split, for A = Q K'^T
    uint32_t qh[NK][4], ql[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split2(qv[kk][2 * j], qv[kk][2 * j + 1], qh[kk][j], ql[kk][j]);

    // ---- A's blocks left of the diagonal: keys 8 nt + g of sub-chunk a =
    // nt / 2 < q, K'_i = E_i prod_{a < x < q} W_x (times U_a on a's first
    // half, whose E is taken to token 7); three products
    float acc_a[6][4];
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c0 = 16 * kk + 2 * tig;
      uint32_t bh[6][2], bl[6][2];
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        if (nt < 2 * q) {
          const float* f = sm.tab((nt & 1 ? T_FU : T_FL) + pair(nt / 2, q));
          const int key = 8 * nt + g;
          const float2 f0 = ld2(f + c0), f1 = ld2(f + c0 + 8);
          const float2 e0 = ld2(sm.e(key, c0)), e1 = ld2(sm.e(key, c0 + 8));
          split2(e0.x * f0.x, e0.y * f0.y, bh[nt][0], bl[nt][0]);
          split2(e1.x * f1.x, e1.y * f1.y, bh[nt][1], bl[nt][1]);
        }
      }
      // hi.hi, hi.lo, lo.hi over the n-tiles: consecutive products go to
      // different accumulators
#pragma unroll
      for (int nt = 0; nt < 6; ++nt)
        if (nt < 2 * q) mma(acc_a[nt], qh[kk], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 6; ++nt)
        if (nt < 2 * q) mma(acc_a[nt], qh[kk], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 6; ++nt)
        if (nt < 2 * q) mma(acc_a[nt], ql[kk], bh[nt][0], bh[nt][1]);
    }

    // ---- A's 8 x 8 block below the diagonal of sub-chunk q: queries 8..15
    // from token 8 (q2) against keys 0..7 to token 7 (E of the first
    // half); rows g of the A operand are zero
    float acc_x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c0 = 16 * kk + 2 * tig;
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      split2(q2[kk][0], q2[kk][1], ah[1], al[1]);
      split2(q2[kk][2], q2[kk][3], ah[3], al[3]);
      const float2 e0 = ld2(sm.e(SUB * q + g, c0));
      const float2 e1 = ld2(sm.e(SUB * q + g, c0 + 8));
      uint32_t bh0, bl0, bh1, bl1;
      split2(e0.x, e0.y, bh0, bl0);
      split2(e1.x, e1.y, bh1, bl1);
      mma3(acc_x, ah, al, bh0, bh1, bl0, bl1);
    }

    // ---- o += A v over the keys 0 .. 16 q + 15: A split, v exact
    mbar_wait(full_v, n & 1);
    const uint32_t vaddr = smem_u32(sm.v());
#pragma unroll
    for (int kk2 = 0; kk2 < 4; ++kk2) {
      if (kk2 <= q) {
        float a4[8];     // A regs' pairs, as in the products above
        if (kk2 < q) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a4[j] = acc_a[2 * kk2][j];
            a4[4 + j] = acc_a[2 * kk2 + 1][j];
          }
        } else {
          const float* ad0 = sm.ad(q, 0);
          const float* ad1 = sm.ad(q, 1);
          a4[0] = ad0[g * 9 + 2 * tig];       // row g, keys 0..7
          a4[1] = ad0[g * 9 + 2 * tig + 1];
          a4[2] = acc_x[2];                   // row g + 8, keys 0..7
          a4[3] = acc_x[3];
          a4[4] = 0.f;                        // row g, keys 8..15
          a4[5] = 0.f;
          a4[6] = ad1[g * 9 + 2 * tig];       // row g + 8, keys 8..15
          a4[7] = ad1[g * 9 + 2 * tig + 1];
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split2(a4[2 * j], a4[2 * j + 1], ah[j], al[j]);
        prod<D>(acc_o, ah, vaddr, kk2, lane);
        prod<D>(acc_o, al, vaddr, kk2, lane);
      }
    }

    // ---- the output rows of this sub-chunk
    {
      const size_t obase = size_t(bh) * n_tok;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = n * C + SUB * q + g + 8 * i;
        if (t < n_tok) {
          __nv_bfloat16* orow = o + (obase + t) * D + 2 * tig;
#pragma unroll
          for (int nt = 0; nt < NN; ++nt)
            *reinterpret_cast<uint32_t*>(orow + 8 * nt) =
                pack_bf16(acc_o[4 * nt + 2 * i], acc_o[4 * nt + 2 * i + 1]);
        }
      }
    }

    // ---- the state's rows c: S <- exp(L_C) S + Kd^T v, Kd_i = E_i
    // prod_{x > a(i)} W_x (times U_a on a's first half); two products per
    // k-step (Kd split, v exact)
    if (owns_state) {
      const float tot0 = sm.tab(T_TOT)[sr0], tot1 = sm.tab(T_TOT)[sr0 + 8];
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        st[4 * nt] *= tot0;
        st[4 * nt + 1] *= tot0;
        st[4 * nt + 2] *= tot1;
        st[4 * nt + 3] *= tot1;
      }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk2 = 0; kk2 < 4; ++kk2) {
        const float* gl = sm.tab(T_GL + kk2);
        const float* gu = sm.tab(T_GU + kk2);
        // (factor of row sr0, of row sr0 + 8) for keys 0..7 and 8..15
        const float f[4] = {gl[sr0], gl[sr0 + 8], gu[sr0], gu[sr0 + 8]};
        const int i0 = 16 * kk2 + 2 * tig;
        // A regs: (row c = sr0, keys i0, i0 + 1), (row sr0 + 8, same),
        // (row sr0, keys i0 + 8, + 9), (row sr0 + 8, same)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = sr0 + 8 * (j & 1);
          const int key = i0 + 8 * (j >> 1);
          split2(*sm.e(key, ci) * f[j], *sm.e(key + 1, ci) * f[j],
                 ah[kk2][j], al[kk2][j]);
        }
      }
#pragma unroll
      for (int kk2 = 0; kk2 < 4; ++kk2) {
        prod<D>(st, ah[kk2], vaddr, kk2, lane);
        prod<D>(st, al[kk2], vaddr, kk2, lane);
      }
    }
    __syncthreads();     // every read of v, E, Q, A and S is done
    if (tid == 0 && n + 1 < n_chunks) load_v(sm, &mv, full_v, n + 1, bh);
    if (owns_state) store_state(sm, st, sr0, tig);
  }

  if (owns_state) {
    float* s_out = sT + size_t(bh) * D * D;
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(s_out + (sr0 + 8 * i) * D + 8 * nt +
                                   2 * tig) =
            make_float2(st[4 * nt + 2 * i], st[4 * nt + 2 * i + 1]);
  }
}

// the 3-d map (D, T, B H) of a contiguous tensor, boxes of `box` columns by
// C rows of one head, swizzled over box * elem bytes
cudaError_t make_rwkv_map(CUtensorMap* map, const void* ptr,
                          CUtensorMapDataType type, int elem, int D, int T,
                          int BH, int box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(T), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * elem,
                                 cuuint64_t(T) * D * elem};
  const cuuint32_t boxd[3] = {cuuint32_t(box), cuuint32_t(C), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const int span = box * elem;
  const CUtensorMapSwizzle sw = span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* o,
                   void* sT, int B, int H, int T, cudaStream_t stream) {
  using G = Geo<D>;
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(G::SMEM));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mr, mk, mv, mw;
  cudaError_t e = make_rwkv_map(&mr, r, BF, 2, D, T, B * H, D);
  if (e == cudaSuccess) e = make_rwkv_map(&mk, k, BF, 2, D, T, B * H, D);
  if (e == cudaSuccess) e = make_rwkv_map(&mv, v, BF, 2, D, T, B * H, D);
  if (e == cudaSuccess)
    e = make_rwkv_map(&mw, lw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, T,
                      B * H, G::CBW);
  if (e != cudaSuccess) return e;
  rwkv6_sm90_kernel<D><<<B * H, NTHREADS, G::SMEM, stream>>>(
      mr, mk, mv, mw, static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(sT), H, T);
  return cudaGetLastError();
}

}  // namespace

// r/k/v/o: (B, H, T, D) bf16; lw: (B, H, T, D) f32; u: (H, D) f32; s0, sT:
// (B, H, D, D) f32; all contiguous, r/k/v/lw 16-byte aligned (TMA).  D in
// {16, 32, 64}.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int rwkv6_sm90(const void* r, const void* k, const void* v,
                          const void* lw, const void* u, const void* s0,
                          void* o, void* sT, int B, int H, int T, int D,
                          void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch<16>(r, k, v, lw, u, s0, o, sT, B, H, T, st));
    case 32: return int(launch<32>(r, k, v, lw, u, s0, o, sT, B, H, T, st));
    case 64: return int(launch<64>(r, k, v, lw, u, s0, o, sT, B, H, T, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
