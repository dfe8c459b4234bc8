// RWKV-6 backward for Hopper (sm_90a), bf16 r/k/v/do, in the chunked form
// on the tensor cores: the gradients of K6's recurrence for training.
//
// Replaces the reference's _rwkv6_bwd (src/repro/kernels/rwkv6/ops.py:
// 90-96), the vjp of the chunked XLA form _xla_chunked (ops.py:23-67), for
// bf16 inputs of at least ops.SM90_MIN_T tokens; f32 inputs and shorter
// calls keep the sequential rwkv6_bwd.cu.  log_w is taken as given (the
// vjp of _xla_chunked has no clamp): w = exp(log_w), which may underflow
// to 0.  Prior art for the three-pass split: flash-linear-attention's
// chunked RWKV-6 backward (fla/ops/rwkv6/chunk.py); nothing is taken from
// it but the split.
//
// Per (batch, head), chunks n of C = 64 tokens, S_n the f32 state (Dk x Dv)
// before chunk n (S_0 = s0), G_n the cotangent of S_n (G_N = dsT after the
// last chunk), inside a chunk L the inclusive cumulative log-decay, Lx = L
// - log_w, L_C its total, e^{L_C} = W_n:
//
//   S_{n+1} = W_n . S_n + U_n,   U_n = (k . e^{L_C - L})^T v
//   G_n     = W_n . G_{n+1} + V_n,   V_n = (r . e^{Lx})^T do
//
// and, with dA[t][i] = do_t . v_i and A the forward's intra-chunk matrix
// (A[t][i] = sum_c r_t k_i e^{Lx_t - L_i} for i < t, r_t . u . k_t on the
// diagonal), G' = G_{n+1}, S = S_n:
//
//   dr_t = e^{Lx_t} . (S do_t) + sum_{i<t} dA[t][i] k_i e^{Lx_t - L_i}
//          + u k_t (v_t . do_t)
//   dk_i = e^{L_C - L_i} . (G' v_i) + sum_{t>i} dA[t][i] r_t e^{Lx_t - L_i}
//          + u r_i (v_i . do_i)
//   dv_i = sum_{t>=i} A[t][i] do_t + (k_i . e^{L_C - L_i}) G'
//   du   = sum over b and t of r_t k_t (v_t . do_t)
//
// dlog_w in the chunked form.  log_w_j enters L_t for t >= j and Lx_t for
// t > j, so dlog_w_j = sum_{t>=j} dL_t + sum_{t>j} dLx_t.  Through the
// exponents above, dLx_t = r_t (dr_t - bonus_t) and dL_i = -k_i (dk_i -
// bonus_i), and L_C (in every L_t's sum, t = C - 1) takes d/dL_C of S_{n+1}
// = e^{L_C} S + sum_i k_i e^{L_C - L_i} v_i^T, which is S_{n+1} itself:
//
//   dlog_w_j[c] = sum_j' G'[c][j'] S_{n+1}[c][j']
//                 + sum_{t>j} r_t (dr_t - bonus_t) - sum_{t>=j} k_t (dk_t - bonus_t)
//
// a reverse cumulative sum inside the chunk plus the chunk-end term; it is
// the unclamped vjp's value at any decay (tests/test_torch_rwkv6_bwd_
// chunked.py holds the same arithmetic against jax.vjp on the CPU).
//
// Four kernels, no atomics (two runs are bit-equal):
//   1. chunk_update, one block per (b, h, chunk): W_n, U_n and V_n from
//      running products of w over the chunk (prefix and suffix, in [0, 1])
//      and two split products each.
//   2. scan, one thread per (b, h, state element): S_{n+1} = W_n S_n + U_n
//      forwards and G_n = W_n G_{n+1} + V_n backwards, in place over U and
//      V: the state before every chunk (and after the last) and the
//      cotangent after every chunk; ds0 = G_0.  Elementwise, so the
//      sequential walk over chunks is spread over D^2 threads a head.
//   3. chunk_grads, one block of four warps per (b, h, chunk): 4,096 blocks
//      at rwkv6-7b's training shape.  Warp q owns sub-chunk q (16 tokens).
//      The decay factors are the forward kernel's (rwkv6_sm90.cu): running
//      products inside halves of 8 tokens, reference points at half and
//      sub-chunk boundaries, a table of products over sub-chunks (chunk.cuh),
//      so every factor is a product of w's in [0, 1].  On mma.sync:
//        dA = do v^T (bf16 operands, exact);
//        A's blocks across halves (the forward's products);
//        XR = f (PQ . (do S^T) + dA K^) + [2nd half] dA Kk   (dr = pq XR + ...)
//        XK = h (GQ . (v G'^T) + dA^T Q^) + [1st half] dA^T Qr (dk = ek XK + ...)
//        dv = A^T do + Kd G'
//      with K^, Q^, Kd the decay-scaled k and r of each block pair.  The
//      pairs inside 8 tokens are CUDA-core sums: A's by the forward's
//      half_pairs, dr's and dk's by running products in the last pass, one
//      thread per channel and part of the chunk, which also forms the
//      bonus, dlog_w's reverse sums and du's part.
//   4. du_reduce: du = the parts summed over b and chunks in order.
//
// Precision.  Every product with an f32 operand splits it into bf16 hi +
// lo (three products for two split operands, two against do or v, exact
// in bf16), as the forward does: one bf16 rounding puts dr, dk, dv, dlog_w
// and ds0 past the check's tolerance (the CPU test above).
//
// What bounds it.  At rwkv6-7b's training shape (B 1, H 64, T 4096, D 64)
// the function moves r, k, v, do, dr, dk, dv (bf16), log_w and dlog_w
// (f32) and s0, dsT, ds0: 369 MB, 0.110 ms at 3.35 TB/s.  The chunked
// products (dA, A, the three brackets, dv, U, V: about 12 C x D x D-sized
// products a chunk, 1.3e10 FLOP) take 0.013 ms at the bf16 rate, three
// times that as split products run them: bound by bytes.  Its scratch,
// S_n and G_n (B, H, T / 64, D, D) f32, is 67 MB each.  Measured, the
// gradients kernel takes two thirds of the time: one block of four warps
// on an SM (200 KB of shared memory a block), its phases serialised by
// barriers.
#include "../../flash_attention/csrc/sm90.cuh"
#include "chunk.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int C = 64;                 // tokens per chunk
constexpr int SUB = 16;               // tokens per sub-chunk (one warp)
constexpr int NTHREADS = 128;         // four warps, one per sub-chunk

// shared geometry for head dim D.  bf16 tiles (r, k, v, do, and the split
// S and G' as D x D) have rows of RB = 2 D bytes, swizzled by swz() so that
// ldmatrix reads are free of bank conflicts; f32 matrices are row-major
// with a padded stride.
template <int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64, "head dim");
  static constexpr int RB = 2 * D;
  static constexpr uint32_t MB = RB / 16 - 1;
  static constexpr int TILE = C * RB;
  static constexpr int STILE = D * RB;
  static constexpr int NK = D / 16;   // k-steps over channels
  static constexpr int NN = D / 8;    // n-tiles over channels
  static constexpr int ES = D + 8;    // stride of Qr, Kk, XR, XK (floats)
  static constexpr int CS = C + 4;    // stride of dA and A (floats)
  // r, k, v, do; f32 w, Qr, Kk (the chunk_update kernel's share: 85 KB at
  // D = 64, two blocks an SM); S hi, S lo, G' hi, G' lo; f32 XR, XK, dA,
  // A, the table
  static constexpr int OFF_W = 4 * TILE;
  static constexpr int OFF_QR = OFF_W + C * D * 4;
  static constexpr int OFF_KK = OFF_QR + C * ES * 4;
  static constexpr int OFF_S = OFF_KK + C * ES * 4;
  static constexpr int OFF_XR = OFF_S + 4 * STILE;
  static constexpr int OFF_XK = OFF_XR + C * ES * 4;
  static constexpr int OFF_DA = OFF_XK + C * ES * 4;
  static constexpr int OFF_A = OFF_DA + C * CS * 4;
  static constexpr int OFF_TAB = OFF_A + C * CS * 4;
  static constexpr int OFF_DU = OFF_TAB + T_ROWS * D * 4;
  static constexpr size_t SMEM = 1024 + OFF_DU + NTHREADS * 4;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

template <int D>
struct Smem {
  using G = Geo<D>;
  uint8_t* base;
  __device__ uint8_t* tile(int x) const { return base + x * G::TILE; }
  __device__ uint8_t* r() const { return tile(0); }
  __device__ uint8_t* k() const { return tile(1); }
  __device__ uint8_t* v() const { return tile(2); }
  __device__ uint8_t* dout() const { return tile(3); }
  // 0: S hi, 1: S lo, 2: G' hi, 3: G' lo
  __device__ uint8_t* st(int x) const {
    return base + G::OFF_S + x * G::STILE;
  }
  __device__ float bf(const uint8_t* t, int row, int c) const {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
        t + swz(row * G::RB + c * 2, G::MB)));
  }
  __device__ float* w() const {
    return reinterpret_cast<float*>(base + G::OFF_W);
  }
  __device__ float* qr() const {
    return reinterpret_cast<float*>(base + G::OFF_QR);
  }
  __device__ float* kk() const {
    return reinterpret_cast<float*>(base + G::OFF_KK);
  }
  __device__ float* xr() const {
    return reinterpret_cast<float*>(base + G::OFF_XR);
  }
  __device__ float* xk() const {
    return reinterpret_cast<float*>(base + G::OFF_XK);
  }
  __device__ float* da() const {
    return reinterpret_cast<float*>(base + G::OFF_DA);
  }
  __device__ float* a() const {
    return reinterpret_cast<float*>(base + G::OFF_A);
  }
  __device__ float* tab(int row) const {
    return reinterpret_cast<float*>(base + G::OFF_TAB) + row * D;
  }
  __device__ float* du() const {
    return reinterpret_cast<float*>(base + G::OFF_DU);
  }
};

// the A fragment (m16k16) of rows r0.. of a bf16 tile, columns 16 kk..,
// through ldmatrix
template <int D>
__device__ __forceinline__ void frag_a(const uint8_t* tile, int r0, int kk,
                                       int lane, uint32_t (&a)[4]) {
  using G = Geo<D>;
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = 16 * kk + (lane >> 4) * 8;
  ldsm_x4(smem_u32(tile) + swz(row * G::RB + col * 2, G::MB), a);
}

// the B fragments (k16 x n8) of n-tiles n0 / 8 and n0 / 8 + 1 at k-step kk
// from a bf16 tile whose rows are n and columns k: b[0], b[1] and b[2],
// b[3]
template <int D>
__device__ __forceinline__ void frag_b_rows_n(const uint8_t* tile, int n0,
                                              int kk, int lane,
                                              uint32_t (&b)[4]) {
  using G = Geo<D>;
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  const int col = 16 * kk + ((lane >> 3) & 1) * 8;
  ldsm_x4(smem_u32(tile) + swz(row * G::RB + col * 2, G::MB), b);
}

// acc (m16 x D, [4 nt + j]) += a b, b rows 16 kk.. of a bf16 tile whose
// rows are k and columns the D n's, through ldmatrix.trans
template <int D>
__device__ __forceinline__ void prod_rows_k(float (&acc)[D / 2],
                                            const uint32_t (&a)[4],
                                            const uint8_t* tile, int kk,
                                            int lane) {
  using G = Geo<D>;
  const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < G::NN / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_t(smem_u32(tile) + swz(row * G::RB + (16 * np + (lane >> 4) * 8) * 2,
                                   G::MB),
              b);
    mma(&acc[8 * np], a, b[0], b[1]);
    mma(&acc[8 * np + 4], a, b[2], b[3]);
  }
}

// acc (m16 x D) += a b^T with a an exact bf16 A fragment and b the split
// D x D tile pair (hi at x, lo at x + 1) whose rows are the n's: two
// products
template <int D>
__device__ __forceinline__ void prod_exact_split(float (&acc)[D / 2],
                                                 const uint32_t (&a)[4],
                                                 const Smem<D>& sm, int x,
                                                 int kk, int lane) {
#pragma unroll
  for (int np = 0; np < Geo<D>::NN / 2; ++np) {
    uint32_t bh[4], bl[4];
    frag_b_rows_n<D>(sm.st(x), 16 * np, kk, lane, bh);
    frag_b_rows_n<D>(sm.st(x + 1), 16 * np, kk, lane, bl);
    mma(&acc[8 * np], a, bh[0], bh[1]);
    mma(&acc[8 * np + 4], a, bh[2], bh[3]);
    mma(&acc[8 * np], a, bl[0], bl[1]);
    mma(&acc[8 * np + 4], a, bl[2], bl[3]);
  }
}

// an A fragment built from f32 values, split: elt(row, col) for rows g, g +
// 8 and columns 2 tig, +1, +8, +9 of the 16 x 16 block
template <class Elt>
__device__ __forceinline__ void frag_a_f32(Elt elt, int g, int tig,
                                           uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = g + 8 * (j & 1), col = 2 * tig + 8 * (j >> 1);
    split2(elt(row, col), elt(row, col + 1), ah[j], al[j]);
  }
}

// a B fragment (k16 x n8) built from f32 values, split: elt(k, n) for k =
// 2 tig, +1 (b0) and 2 tig + 8, +9 (b1), n = g
template <class Elt>
__device__ __forceinline__ void frag_b_f32(Elt elt, int g, int tig,
                                           uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    split2(elt(2 * tig + 8 * j, g), elt(2 * tig + 8 * j + 1, g), bh[j],
           bl[j]);
}

// the n rows of (C, D) bf16 from `row0` into a swizzled tile; rows past
// `rows` are zeros
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  using G = Geo<D>;
  constexpr int CH = G::RB / 16;      // 16-byte chunks a row
  for (int e = threadIdx.x; e < C * CH; e += NTHREADS) {
    const int t = e / CH, ch = e % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + t < rows)
      x = *reinterpret_cast<const uint4*>(src + size_t(row0 + t) * D + ch * 8);
    *reinterpret_cast<uint4*>(tile + swz(t * G::RB + ch * 16, G::MB)) = x;
  }
}

// a (D, D) f32 state into the hi and lo tiles of its split
template <int D>
__device__ __forceinline__ void load_split(uint8_t* hi, uint8_t* lo,
                                           const float* src) {
  using G = Geo<D>;
  for (int e = threadIdx.x; e < D * D / 2; e += NTHREADS) {
    const int row = (2 * e) / D, col = (2 * e) % D;
    const float2 x = ld2(src + 2 * e);
    uint32_t h, l;
    split2(x.x, x.y, h, l);
    const uint32_t off = swz(row * G::RB + col * 2, G::MB);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

__device__ __forceinline__ void store_bf2(__nv_bfloat16* p, float x,
                                          float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// ------------------------------------------------------------ 1. updates
// W_n, U_n = (k . suffix)^T v and V_n = (r . prefix)^T do of one chunk:
// one thread per channel walks the prefix and suffix products of w; warps
// then take the (U or V, 16 channels) row tiles of the two products, each
// with the scaled operand split and v / do exact.  U and V (B, H, nc + 1,
// D, D) and (B, H, nc, D, D) f32; W (B, H, nc, D).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
chunk_update_kernel(const __nv_bfloat16* __restrict__ r,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ lw,
                    const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ W, float* __restrict__ U,
                    float* __restrict__ V, int n_tok, int nc) {
  using G = Geo<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<D> sm{smem_raw +
                   ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u)};
  const int bh = blockIdx.x / nc, n = blockIdx.x % nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const size_t seq = size_t(bh) * n_tok * D;
  load_rows<D>(sm.r(), r + seq, n * C, n_tok);
  load_rows<D>(sm.k(), k + seq, n * C, n_tok);
  load_rows<D>(sm.v(), v + seq, n * C, n_tok);
  load_rows<D>(sm.dout(), dout + seq, n * C, n_tok);
  __syncthreads();
  // the scaled operands, f32, in Qr (r . prefix) and Kk (k . suffix)
  if (tid < D) {
    const int c = tid;
    float run = 1.f;
    for (int t = 0; t < C; ++t) {
      const float wv = n * C + t < n_tok
                           ? expf(lw[seq + size_t(n * C + t) * D + c])
                           : 1.f;
      sm.w()[t * D + c] = wv;
      sm.qr()[t * G::ES + c] = sm.bf(sm.r(), t, c) * run;
      run *= wv;
    }
    W[(size_t(bh) * nc + n) * D + c] = run;
    run = 1.f;
    for (int t = C - 1; t >= 0; --t) {
      sm.kk()[t * G::ES + c] = sm.bf(sm.k(), t, c) * run;
      run *= sm.w()[t * D + c];
    }
  }
  __syncthreads();
  for (int task = warp; task < 2 * G::NK; task += NTHREADS / 32) {
    const bool is_u = task < G::NK;
    const int c0 = 16 * (is_u ? task : task - G::NK);
    const float* op = is_u ? sm.kk() : sm.qr();
    const uint8_t* rhs = is_u ? sm.v() : sm.dout();
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int kt = 0; kt < C / 16; ++kt) {
      // rows c0.. (channels), k = tokens 16 kt..: the transposed operand
      uint32_t ah[4], al[4];
      frag_a_f32(
          [&](int row, int col) {
            return op[(16 * kt + col) * G::ES + c0 + row];
          },
          g, tig, ah, al);
      prod_rows_k<D>(acc, ah, rhs, kt, lane);
      prod_rows_k<D>(acc, al, rhs, kt, lane);
    }
    float* out = (is_u ? U + (size_t(bh) * (nc + 1) + n) * D * D
                       : V + (size_t(bh) * nc + n) * D * D);
#pragma unroll
    for (int nt = 0; nt < G::NN; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(out + (c0 + g + 8 * i) * D + 8 * nt +
                                   2 * tig) =
            make_float2(acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
  }
}

// --------------------------------------------------------------- 2. scan
// one thread per (b, h, c, j): S forwards over U (in place, U[n] <- S_n,
// U[nc] <- S_nc), G backwards over V (V[n] <- G_{n+1}), ds0 <- G_0.  The
// loads of SCAN_BATCH chunks are issued before their chain of FMAs, so
// each thread keeps that many in flight (one at a time, the scan waits
// on a load a chunk: 0.72 ms at the training shape, chip call 16)
constexpr int SCAN_BATCH = 16;

__global__ void __launch_bounds__(256)
scan_kernel(const float* __restrict__ W, float* __restrict__ U,
            float* __restrict__ V, const float* __restrict__ s0,
            const float* __restrict__ dsT, float* __restrict__ ds0, int D,
            int nc, int64_t n_elems) {
  const int64_t e = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n_elems) return;
  const int64_t dd = int64_t(D) * D;
  const int64_t bh = e / dd, ij = e % dd;
  const int c = int(ij / D);
  const float* w = W + bh * nc * D + c;
  float* u = U + bh * (nc + 1) * dd + ij;
  float s = s0 != nullptr ? s0[e] : 0.f;
  for (int n0 = 0; n0 < nc; n0 += SCAN_BATCH) {
    float x[SCAN_BATCH], wx[SCAN_BATCH];
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j)
      if (n0 + j < nc) {
        x[j] = u[(n0 + j) * dd];
        wx[j] = w[(n0 + j) * D];
      }
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j)
      if (n0 + j < nc) {
        u[(n0 + j) * dd] = s;
        s = fmaf(wx[j], s, x[j]);
      }
  }
  u[nc * dd] = s;
  float* vv = V + bh * nc * dd + ij;
  float gc = dsT != nullptr ? dsT[e] : 0.f;
  for (int n0 = nc - 1; n0 >= 0; n0 -= SCAN_BATCH) {
    float x[SCAN_BATCH], wx[SCAN_BATCH];
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j)
      if (n0 - j >= 0) {
        x[j] = vv[(n0 - j) * dd];
        wx[j] = w[(n0 - j) * D];
      }
#pragma unroll
    for (int j = 0; j < SCAN_BATCH; ++j)
      if (n0 - j >= 0) {
        vv[(n0 - j) * dd] = gc;
        gc = fmaf(wx[j], gc, x[j]);
      }
  }
  if (ds0 != nullptr) ds0[e] = gc;
}

// ---------------------------------------------------------- 3. gradients
// Sb (B, H, nc + 1, D, D): the state before each chunk and after the last;
// Ga (B, H, nc, D, D): the cotangent of the state after each chunk;
// du_part (B, H, nc, D)
template <int D>
__global__ void __launch_bounds__(NTHREADS)
chunk_grads_kernel(const __nv_bfloat16* __restrict__ r,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ lw, const float* __restrict__ u,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ Sb, const float* __restrict__ Ga,
                   __nv_bfloat16* __restrict__ dr,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float* __restrict__ dlw,
                   float* __restrict__ du_part, int H, int n_tok, int nc) {
  using G = Geo<D>;
  constexpr int NK = G::NK, NN = G::NN, ES = G::ES, CS = G::CS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<D> sm{smem_raw +
                   ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u)};
  const int bh = blockIdx.x / nc, n = blockIdx.x % nc;
  const int h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, q = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const size_t seq = size_t(bh) * n_tok * D;
  const int t0 = n * C;
  const size_t dd = size_t(D) * D;
  const float* S_before = Sb + (size_t(bh) * (nc + 1) + n) * dd;
  const float* S_after = S_before + dd;
  const float* Gp = Ga + (size_t(bh) * nc + n) * dd;

  // ---- loads: the bf16 tiles, log_w, the split S and G', A zeroed
  load_rows<D>(sm.r(), r + seq, t0, n_tok);
  load_rows<D>(sm.k(), k + seq, t0, n_tok);
  load_rows<D>(sm.v(), v + seq, t0, n_tok);
  load_rows<D>(sm.dout(), dout + seq, t0, n_tok);
  for (int e = tid; e < C * D; e += NTHREADS)
    sm.w()[e] = t0 + e / D < n_tok ? lw[seq + size_t(t0) * D + e] : 0.f;
  load_split<D>(sm.st(0), sm.st(1), S_before);
  load_split<D>(sm.st(2), sm.st(3), Gp);
  for (int e = tid; e < C * CS; e += NTHREADS) sm.a()[e] = 0.f;
  float ul[D / 16];
#pragma unroll
  for (int e = 0; e < D / 16; ++e)
    ul[e] = u[h * D + (D / 16) * (lane & 15) + e];
  __syncthreads();

  // ---- walkers, one thread per channel of sub-chunk q: w = exp(log_w)
  // in place (unclamped); Qr_t = r_t times the decay from the start of
  // t's half to t - 1, Kk_i = k_i times the decay from i + 1 to the end of
  // i's half; the halves' decays into the table
  for (int c = lane; c < D; c += 32) {
    float run = 1.f;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int t = SUB * q + j;
      if (j == SUB / 2) {
        sm.tab(T_WLO + q)[c] = run;
        run = 1.f;
      }
      const float wv = expf(sm.w()[t * D + c]);
      sm.w()[t * D + c] = wv;
      sm.qr()[t * ES + c] = sm.bf(sm.r(), t, c) * run;
      run *= wv;
    }
    sm.tab(T_WUP + q)[c] = run;
    run = 1.f;
#pragma unroll
    for (int j = SUB - 1; j >= 0; --j) {
      const int t = SUB * q + j;
      if (j == SUB / 2 - 1) run = 1.f;
      sm.kk()[t * ES + c] = sm.bf(sm.k(), t, c) * run;
      run *= sm.w()[t * D + c];
    }
  }
  __syncthreads();

  // ---- the table (one thread per channel); dA's rows of sub-chunk q
  // (do v^T for the keys up to q's end, exact); A's pairs inside halves
  if (tid < D) build_table<D>(sm.tab(0), tid);
  {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      frag_a<D>(sm.dout(), SUB * q, kk, lane, a);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np <= q) {
          uint32_t b[4];
          frag_b_rows_n<D>(sm.v(), 16 * np, kk, lane, b);
          mma(acc[2 * np], a, b[0], b[1]);
          mma(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (nt < 2 * q + 2)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(
              sm.da() + (SUB * q + g + 8 * i) * CS + 8 * nt + 2 * tig) =
              make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
  {
    constexpr int CPL = D / 16;
    const int half = lane >> 4, sl = lane & 15;
    const int rb = SUB * q + 8 * half;
    const int c0 = CPL * sl;
    float rr[8][CPL], ww[8][CPL];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      load_bf<CPL>(sm.r() + swz((rb + t) * G::RB + 2 * c0, G::MB), rr[t]);
      load_f<CPL>(sm.w() + (rb + t) * D + c0, ww[t]);
    }
    float* ad = sm.a() + rb * CS + rb;
    half_pairs<CPL>(
        rr, ww, ul, sl,
        [&](int i, float (&kd)[CPL]) {
          load_bf<CPL>(sm.k() + swz((rb + i) * G::RB + 2 * c0, G::MB), kd);
        },
        [&](int t, int i, float x) { ad[t * CS + i] = x; });
  }
  __syncthreads();

  // ---- A's blocks across halves, rows of q (the forward's products):
  // keys of sub-chunk a < q with reference point q's start, and keys 0..7
  // of q for its rows 8..15 with reference point token 8
  {
    const float* lo_q = sm.tab(T_WLO + q);
    // Q rows g and g + 8 (the latter times the first half's decay),
    // columns 16 kk + 2 tig (+1, +8, +9): split
    uint32_t qh[NK][4], ql[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      frag_a_f32(
          [&](int row, int col) {
            const int c = 16 * kk + col;
            const float x = sm.qr()[(SUB * q + row) * ES + c];
            return row >= 8 ? x * lo_q[c] : x;
          },
          g, tig, qh[kk], ql[kk]);
    float acc_a[6][4];
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        if (nt < 2 * q) {
          const float* f = sm.tab((nt & 1 ? T_FU : T_FL) + pair(nt / 2, q));
          uint32_t bh[2], bl[2];
          frag_b_f32(
              [&](int kc, int key) {
                const int c = 16 * kk + kc;
                return sm.kk()[(8 * nt + key) * ES + c] * f[c];
              },
              g, tig, bh, bl);
          mma3(acc_a[nt], qh[kk], ql[kk], bh[0], bh[1], bl[0], bl[1]);
        }
      }
    float acc_x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      frag_a_f32(
          [&](int row, int col) {
            return row >= 8 ? sm.qr()[(SUB * q + row) * ES + 16 * kk + col]
                            : 0.f;
          },
          g, tig, ah, al);
      frag_b_f32(
          [&](int kc, int key) {
            return sm.kk()[(SUB * q + key) * ES + 16 * kk + kc];
          },
          g, tig, bh, bl);
      mma3(acc_x, ah, al, bh[0], bh[1], bl[0], bl[1]);
    }
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
      if (nt < 2 * q)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(
              sm.a() + (SUB * q + g + 8 * i) * CS + 8 * nt + 2 * tig) =
              make_float2(acc_a[nt][2 * i], acc_a[nt][2 * i + 1]);
    *reinterpret_cast<float2*>(sm.a() + (SUB * q + g + 8) * CS + SUB * q +
                               2 * tig) = make_float2(acc_x[2], acc_x[3]);
  }

  // ---- XR, rows of q: f (PQ_q . (do S^T) + sum over keys of earlier
  // sub-chunks of dA K^), plus on rows 8..15 dA Kk over keys 0..7 of q
  {
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      frag_a<D>(sm.dout(), SUB * q, kk, lane, a);
      prod_exact_split<D>(acc, a, sm, 0, kk, lane);
    }
    const float* pq = sm.tab(T_PQ + q);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[4 * nt + j] *= pq[8 * nt + 2 * tig + (j & 1)];
#pragma unroll
    for (int kk2 = 0; kk2 < 3; ++kk2) {
      if (kk2 < q) {
        uint32_t ah[4], al[4];
        frag_a_f32(
            [&](int row, int col) {
              return sm.da()[(SUB * q + row) * CS + 16 * kk2 + col];
            },
            g, tig, ah, al);
        const float* fl = sm.tab(T_FL + pair(kk2, q));
        const float* fu = sm.tab(T_FU + pair(kk2, q));
#pragma unroll
        for (int nt = 0; nt < NN; ++nt) {
          uint32_t bh[2], bl[2];
          frag_b_f32(
              [&](int key, int cn) {
                const int c = 8 * nt + cn;
                return sm.kk()[(16 * kk2 + key) * ES + c] *
                       (key < 8 ? fl[c] : fu[c]);
              },
              g, tig, bh, bl);
          mma3(&acc[4 * nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
        }
      }
    }
    const float* lo_q = sm.tab(T_WLO + q);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      acc[4 * nt + 2] *= lo_q[8 * nt + 2 * tig];
      acc[4 * nt + 3] *= lo_q[8 * nt + 2 * tig + 1];
    }
    {
      uint32_t ah[4], al[4];
      frag_a_f32(
          [&](int row, int col) {
            return row >= 8 && col < 8
                       ? sm.da()[(SUB * q + row) * CS + SUB * q + col]
                       : 0.f;
          },
          g, tig, ah, al);
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        uint32_t bh[2], bl[2];
        frag_b_f32(
            [&](int key, int cn) {
              return key < 8 ? sm.kk()[(SUB * q + key) * ES + 8 * nt + cn]
                             : 0.f;
            },
            g, tig, bh, bl);
        mma3(&acc[4 * nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(sm.xr() + (SUB * q + g + 8 * i) * ES +
                                   8 * nt + 2 * tig) =
            make_float2(acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
  }

  // ---- XK, keys of q: h (GQ_q . (v G'^T) + sum over rows of later
  // sub-chunks of dA^T Q^), plus on keys 0..7 dA^T Qr over rows 8..15 of q
  {
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      frag_a<D>(sm.v(), SUB * q, kk, lane, a);
      prod_exact_split<D>(acc, a, sm, 2, kk, lane);
    }
    const float* gq = sm.tab(T_GU + q);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[4 * nt + j] *= gq[8 * nt + 2 * tig + (j & 1)];
#pragma unroll
    for (int kk2 = 1; kk2 < 4; ++kk2) {
      if (kk2 > q) {
        uint32_t ah[4], al[4];
        frag_a_f32(
            [&](int row, int col) {
              return sm.da()[(16 * kk2 + col) * CS + SUB * q + row];
            },
            g, tig, ah, al);
        const float* fu = sm.tab(T_FU + pair(q, kk2));
        const float* lo = sm.tab(T_WLO + kk2);
#pragma unroll
        for (int nt = 0; nt < NN; ++nt) {
          uint32_t bh[2], bl[2];
          frag_b_f32(
              [&](int row, int cn) {
                const int c = 8 * nt + cn;
                const float x = sm.qr()[(16 * kk2 + row) * ES + c] * fu[c];
                return row >= 8 ? x * lo[c] : x;
              },
              g, tig, bh, bl);
          mma3(&acc[4 * nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
        }
      }
    }
    const float* up_q = sm.tab(T_WUP + q);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      acc[4 * nt] *= up_q[8 * nt + 2 * tig];
      acc[4 * nt + 1] *= up_q[8 * nt + 2 * tig + 1];
    }
    {
      uint32_t ah[4], al[4];
      frag_a_f32(
          [&](int row, int col) {
            return row < 8 && col >= 8
                       ? sm.da()[(SUB * q + col) * CS + SUB * q + row]
                       : 0.f;
          },
          g, tig, ah, al);
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        uint32_t bh[2], bl[2];
        frag_b_f32(
            [&](int row, int cn) {
              return row >= 8 ? sm.qr()[(SUB * q + row) * ES + 8 * nt + cn]
                              : 0.f;
            },
            g, tig, bh, bl);
        mma3(&acc[4 * nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(sm.xk() + (SUB * q + g + 8 * i) * ES +
                                   8 * nt + 2 * tig) =
            make_float2(acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
  }
  __syncthreads();     // A, XR and XK complete

  // ---- dv, keys of q: A^T do over rows from q's start (A split, do
  // exact), plus Kd G' (Kd = Kk h GQ, both split)
  {
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int kk2 = 0; kk2 < 4; ++kk2) {
      if (kk2 >= q) {
        uint32_t ah[4], al[4];
        frag_a_f32(
            [&](int row, int col) {
              return sm.a()[(16 * kk2 + col) * CS + SUB * q + row];
            },
            g, tig, ah, al);
        prod_rows_k<D>(acc, ah, sm.dout(), kk2, lane);
        prod_rows_k<D>(acc, al, sm.dout(), kk2, lane);
      }
    }
    const float* gl = sm.tab(T_GL + q);
    const float* gu = sm.tab(T_GU + q);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      uint32_t ah[4], al[4];
      frag_a_f32(
          [&](int row, int col) {
            const int c = 16 * kc + col;
            return sm.kk()[(SUB * q + row) * ES + c] *
                   (row < 8 ? gl[c] : gu[c]);
          },
          g, tig, ah, al);
      prod_rows_k<D>(acc, ah, sm.st(2), kc, lane);
      prod_rows_k<D>(acc, ah, sm.st(3), kc, lane);
      prod_rows_k<D>(acc, al, sm.st(2), kc, lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + SUB * q + g + 8 * i;
      if (t < n_tok) {
#pragma unroll
        for (int nt = 0; nt < NN; ++nt)
          store_bf2(dv + seq + size_t(t) * D + 8 * nt + 2 * tig,
                    acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
      }
    }
  }

  // ---- the last pass, one thread per channel c and part p of the chunk
  // (C / NP tokens, whole halves): the pairs inside halves by running
  // products, dr and dk, their dlog_w terms R = r (dr - bonus) and K =
  // k (dk - bonus) in place of XR and XK, and du's part
  constexpr int NP = NTHREADS / D;
  constexpr int PT = C / NP;
  const int c = tid % D, p = tid / D;
  const float uc = u[h * D + c];
  float du_acc = 0.f;
  for (int h0 = PT * p; h0 < PT * (p + 1); h0 += 8) {
    float wv[8], rv[8], kv[8], sr[8], sk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wv[j] = sm.w()[(h0 + j) * D + c];
      rv[j] = sm.bf(sm.r(), h0 + j, c);
      kv[j] = sm.bf(sm.k(), h0 + j, c);
      sr[j] = sk[j] = 0.f;
    }
    // sr_t = sum_{i < t} dA[t][i] k_i prod_{i < m < t} w_m; sk alike
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float run = kv[i];
#pragma unroll
      for (int t = i + 1; t < 8; ++t) {
        sr[t] = fmaf(sm.da()[(h0 + t) * CS + h0 + i], run, sr[t]);
        run *= wv[t];
      }
    }
#pragma unroll
    for (int t = 7; t >= 0; --t) {
      float run = rv[t];
#pragma unroll
      for (int i = t - 1; i >= 0; --i) {
        sk[i] = fmaf(sm.da()[(h0 + t) * CS + h0 + i], run, sk[i]);
        run *= wv[i];
      }
    }
    float pq = 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float vdo = sm.da()[(h0 + j) * CS + h0 + j];
      float* xr = sm.xr() + (h0 + j) * ES + c;
      const float gr = fmaf(pq, *xr, sr[j]);
      *xr = rv[j] * gr;
      pq *= wv[j];
      const int t = t0 + h0 + j;
      if (t < n_tok) dr[seq + size_t(t) * D + c] =
          __float2bfloat16_rn(fmaf(uc * kv[j], vdo, gr));
      du_acc = fmaf(rv[j] * kv[j], vdo, du_acc);
    }
    float ek = 1.f;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      const float vdo = sm.da()[(h0 + j) * CS + h0 + j];
      float* xk = sm.xk() + (h0 + j) * ES + c;
      const float gk = fmaf(ek, *xk, sk[j]);
      *xk = kv[j] * gk;
      ek *= wv[j];
      const int t = t0 + h0 + j;
      if (t < n_tok) dk[seq + size_t(t) * D + c] =
          __float2bfloat16_rn(fmaf(uc * rv[j], vdo, gk));
    }
  }
  sm.du()[tid] = du_acc;
  __syncthreads();     // R and K of every part

  // dlog_w_j = sum_j' G'[c][j'] S_{n+1}[c][j'] + sum_{t > j} R_t -
  // sum_{t >= j} K_t, walked backwards from the parts after this one
  float tail = 0.f;
  for (int j = 0; j < D; ++j)
    tail = fmaf(Gp[c * D + j], S_after[c * D + j], tail);
  float sR = 0.f, sK = 0.f;
  for (int t = C - 1; t >= PT * (p + 1); --t) {
    sR += sm.xr()[t * ES + c];
    sK += sm.xk()[t * ES + c];
  }
  for (int t = PT * (p + 1) - 1; t >= PT * p; --t) {
    sK += sm.xk()[t * ES + c];
    if (t0 + t < n_tok) dlw[seq + size_t(t0 + t) * D + c] = tail + sR - sK;
    sR += sm.xr()[t * ES + c];
  }
  if (p == 0) {
    float acc = 0.f;
    for (int pp = 0; pp < NP; ++pp) acc += sm.du()[pp * D + c];
    du_part[(size_t(bh) * nc + n) * D + c] = acc;
  }
}

// ---------------------------------------------------------------- 4. du
// du[h][c] = sum over b, then chunks, of du_part[b][h][n][c], in order
__global__ void du_reduce_kernel(const float* __restrict__ du_part,
                                 float* __restrict__ du, int B, int H, int D,
                                 int nc) {
  const int h = blockIdx.x;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b)
      for (int n = 0; n < nc; ++n)
        acc += du_part[((size_t(b) * H + h) * nc + n) * D + c];
    du[h * D + c] = acc;
  }
}

template <int D>
size_t update_smem() {
  return 1024 + Geo<D>::OFF_S;
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0,
                   const void* dout, const void* dsT, void* dr, void* dk,
                   void* dv, void* dlw, void* du, void* ds0, void* W, void* U,
                   void* V, void* du_part, int B, int H, int T,
                   cudaStream_t st) {
  using G = Geo<D>;
  static bool configured = false;   // the attributes are per kernel, once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_update_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(update_smem<D>()));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(chunk_grads_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(G::SMEM));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nc = (T + C - 1) / C;
  const auto* rp = static_cast<const __nv_bfloat16*>(r);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lwp = static_cast<const float*>(lw);
  float* Wp = static_cast<float*>(W);
  float* Up = static_cast<float*>(U);
  float* Vp = static_cast<float*>(V);
  chunk_update_kernel<D><<<B * H * nc, NTHREADS, update_smem<D>(), st>>>(
      rp, kp, vp, lwp, dop, Wp, Up, Vp, T, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t n_elems = int64_t(B) * H * D * D;
  scan_kernel<<<unsigned((n_elems + 255) / 256), 256, 0, st>>>(
      Wp, Up, Vp, static_cast<const float*>(s0),
      static_cast<const float*>(dsT), static_cast<float*>(ds0), D, nc,
      n_elems);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_grads_kernel<D><<<B * H * nc, NTHREADS, G::SMEM, st>>>(
      rp, kp, vp, lwp, static_cast<const float*>(u), dop, Up, Vp,
      static_cast<__nv_bfloat16*>(dr), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dlw),
      static_cast<float*>(du_part), H, T, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  du_reduce_kernel<<<H, D, 0, st>>>(static_cast<const float*>(du_part),
                                    static_cast<float*>(du), B, H, D, nc);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, dout, dr, dk, dv: (B, H, T, D) bf16; lw, dlw: (B, H, T, D) f32;
// u, du: (H, D) f32; s0, dsT, ds0: (B, H, D, D) f32 or null (s0 and dsT
// zeros; ds0 not written); scratch: W (B, H, nc, D), U (B, H, nc + 1, D,
// D), V (B, H, nc, D, D) and du_part (B, H, nc, D) f32, nc = ceil(T / 64);
// all contiguous and 16-byte aligned.  D in {16, 32, 64}.  Launches four
// kernels on `stream` without synchronising and returns the first error.
extern "C" int rwkv6_bwd_sm90(const void* r, const void* k, const void* v,
                              const void* lw, const void* u, const void* s0,
                              const void* dout, const void* dsT, void* dr,
                              void* dk, void* dv, void* dlw, void* du,
                              void* ds0, void* W, void* U, void* V,
                              void* du_part, int B, int H, int T, int D,
                              void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RWKV6_BWD_SM90_LAUNCH(DIM)                                          \
  int(launch<DIM>(r, k, v, lw, u, s0, dout, dsT, dr, dk, dv, dlw, du, ds0, \
                  W, U, V, du_part, B, H, T, st))
  switch (D) {
    case 16: return RWKV6_BWD_SM90_LAUNCH(16);
    case 32: return RWKV6_BWD_SM90_LAUNCH(32);
    case 64: return RWKV6_BWD_SM90_LAUNCH(64);
    default: return int(cudaErrorInvalidValue);
  }
#undef RWKV6_BWD_SM90_LAUNCH
}

extern "C" const char* rwkv6_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
