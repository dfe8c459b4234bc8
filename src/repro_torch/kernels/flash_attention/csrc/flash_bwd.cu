// Flash-attention backward on f32 FMAs (sm_90a): GQA, causal
// (bottom-right) or sliding window; dq, dk, dv from q, k, v, out, the f32
// log-sum-exp and the output's gradient, for f32 inputs at every head dim;
// bf16 inputs go to the tensor-core kernels of flash_bwd_sm90.cu.
//
// Replaces the backward of K4 (flash_attention_pallas, src/repro/kernels/
// flash_attention/kernel.py:95), which JAX runs as the XLA blockwise
// ops._xla_flash_bwd (src/repro/kernels/flash_attention/ops.py:94-150).
// Same function: p is recomputed per tile from the saved lse,
// p = exp(s - lse), with D = rowsum(do * o) in f32, dv = p^T do,
// ds = p (do v^T - D), dq = scale ds k, dk = scale ds^T q.
//
// Deterministic, with no atomics: four kernels, each output element
// summed by one thread in a fixed order.
//   1. rowdot: D = rowsum(do * o), one warp per query row.
//   2. dkdv: one block per (b, q-head, tile of 64 keys); it loops over the
//      query tiles the mask allows, keeps its dk and dv tiles in registers
//      and writes them, in f32, as that query head's part of its KV head's
//      gradients.  One block per query head rather than per KV head gives
//      g times more blocks, and the grid puts every head's first key tile
//      (the most query tiles under a causal mask) first, so the longest
//      blocks start first and the SMs finish together.
//   3. dkdv_reduce: dk, dv = the sum of the g parts of each KV head, in
//      head order.
//   4. dq: one block per (b, q-head, tile of 64 queries), longest tiles
//      first; it loops over the key tiles the mask allows, with its dq tile
//      in registers.
// Both main kernels recompute the BT x BT score tile and do.v^T in
// registers (MT x MT per thread), put p and ds in shared memory, and
// accumulate the products over the tile from there.  Tiles are 64 x 64 up
// to head dim 128.  At head dim 256 the four (64, 257) f32 tiles of q, do,
// k and v alone would take 263 KB of the 227 KB a block may use, and the
// dk and dv accumulators of a 64-key tile 128 f32 registers a thread each:
// the D 256 instance takes tiles of 32 x 32 (2 x 2 a thread), 137 KB of
// shared memory and 64 accumulator registers, and so does D 160
// (pixtral-12b; 83 KB, 40 registers), as every head dim above 128.
// Probabilities are masked to exact zeros, so a row with no allowed key
// (lse = -inf) gives zero gradients, never exp(-inf - -inf).
//
// What bounds it.  At the training path's shape (B 1, Hq 16, Hkv 2,
// T = S = 4096, D 128, causal) the work is five T x S x D products halved
// by the mask, about 1.7e11 FLOP: 2.6 ms at the card's 67 TFLOP/s f32
// rate, while the bytes that must move (q, k, v, o, do, dq, dk, dv in f32)
// are about 151 MB, 0.045 ms: bound by operations.  It runs on f32 FMAs fed
// from shared memory (TF32 tensor cores would not hold f32's tolerance),
// so it is bound by FMA issue and shared-memory reads.  The training paths
// run bf16; f32 is the checks' and the f32 cuts' type.
#include <algorithm>

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;   // 16 x 16 threads, MT x MT micro-tile each

// queries and keys per tile at head dim d; p and ds tiles have row stride
// tile + 1
__host__ __device__ constexpr int tile(int d) { return d > 128 ? 32 : 64; }

// a (rows x D) tile of a (.., len, D) tensor into shared memory as f32 with
// row stride D + 1 (conflict-free column reads); rows past `len` are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int len, float mul) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (r0 + r < len) x = src[size_t(r0 + r) * D + c] * mul;
    dst[r * DP + c] = x;
  }
}

__device__ __forceinline__ bool allowed(int qi, int kj, int Tq, int S,
                                        int offset, int causal,
                                        int has_window, int window) {
  const int qpos = qi + offset;
  return qi < Tq && kj < S && (!causal || kj <= qpos) &&
         (!has_window || kj > qpos - window);
}

// s = (q scale) k^T and dp = do v^T over one BT x BT tile (MT = BT / 16):
// rows ty*MT+i of Qs/dOs, rows tx+16j of Ks/Vs
template <int D, int MT>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float (&s)[MT][MT],
                                            float (&dp)[MT][MT]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[MT], ov[MT], kv[MT], vv[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      qv[i] = Qs[(ty * MT + i) * DP + d];
      ov[i] = dOs[(ty * MT + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      kv[j] = Ks[(tx + 16 * j) * DP + d];
      vv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

__global__ void __launch_bounds__(NTHREADS)
rowdot_kernel(const float* __restrict__ dout, const float* __restrict__ out,
              float* __restrict__ Dsum, int64_t rows, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = int64_t(blockIdx.x) * (NTHREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(dout[r * D + c], out[r * D + c], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) Dsum[r] = acc;
}

// grid (Hq, key tiles, B); pdk / pdv are (B, Hq, S, D) f32
template <int D>
__global__ void __launch_bounds__(NTHREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ Dsum,
            float* __restrict__ pdk, float* __restrict__ pdv, int Hq,
            int Hkv, int Tq, int S, float scale, int causal, int has_window,
            int window) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  constexpr int BQ = tile(D), BK = tile(D), MT = BK / 16, PP = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;               // BK x DP
  float* Vs = Ks + BK * DP;       // BK x DP
  float* Qs = Vs + BK * DP;       // BQ x DP, pre-scaled
  float* dOs = Qs + BQ * DP;      // BQ x DP
  float* Ps = dOs + BQ * DP;      // BQ x PP
  float* dSs = Ps + BQ * PP;      // BQ x PP
  float* Ls = dSs + BQ * PP;      // BQ
  float* Dl = Ls + BQ;            // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;      // bottom-right alignment

  const size_t kvoff = (size_t(b) * Hkv + hk) * size_t(S) * D;
  load_tile<D, BK>(Ks, k + kvoff, k0, S, 1.f);
  load_tile<D, BK>(Vs, v + kvoff, k0, S, 1.f);

  float adk[MT][NC], adv[MT][NC];   // keys ty*MT+i, columns tx+16c
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  // the query rows that may see a key of this tile
  const int k_last = min(k0 + BK, S) - 1;
  const int q_lo = causal ? max(0, k0 - offset) : 0;
  const int q_hi = has_window ? min(Tq, k_last + window - offset) : Tq;

  const size_t qoff = (size_t(b) * Hq + h) * size_t(Tq);
  for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
    __syncthreads();            // the last tile's reads are done
    load_tile<D, BQ>(Qs, q + qoff * D, q0, Tq, scale);
    load_tile<D, BQ>(dOs, dout + qoff * D, q0, Tq, 1.f);
    for (int r = tid; r < BQ; r += NTHREADS) {
      const bool in = q0 + r < Tq;
      Ls[r] = in ? lse[qoff + q0 + r] : -INFINITY;
      Dl[r] = in ? Dsum[qoff + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[MT][MT], dp[MT][MT];
    score_tiles<D, MT>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = ty * MT + i;
      const float L = Ls[r];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = L > -INFINITY && allowed(q0 + r, k0 + c, Tq, S,
                                                 offset, causal,
                                                 has_window, window);
        const float p = ok ? expf(s[i][j] - L) : 0.f;
        Ps[r * PP + c] = p;
        dSs[r * PP + c] = p * (dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[MT], sv[MT], ov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        pv[i] = Ps[qq * PP + ty * MT + i];
        sv[i] = dSs[qq * PP + ty * MT + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ov[c] = dOs[qq * DP + tx + 16 * c];
        qv[c] = Qs[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adv[i][c] = fmaf(pv[i], ov[c], adv[i][c]);
          adk[i][c] = fmaf(sv[i], qv[c], adk[i][c]);
        }
    }
  }

  const size_t poff = (size_t(b) * Hq + h) * size_t(S) * D;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = k0 + ty * MT + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pdk[poff + size_t(r) * D + tx + 16 * c] = adk[i][c];
      pdv[poff + size_t(r) * D + tx + 16 * c] = adv[i][c];
    }
  }
}

// dk[b, hk] = sum over gi of pdk[b, hk * g + gi], in order of gi; dv alike
__global__ void __launch_bounds__(NTHREADS)
dkdv_reduce_kernel(const float* __restrict__ pdk,
                   const float* __restrict__ pdv, float* __restrict__ dk,
                   float* __restrict__ dv, int64_t head_elems, int64_t n,
                   int g) {
  for (int64_t i = int64_t(blockIdx.x) * NTHREADS + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * NTHREADS) {
    const int64_t bh = i / head_elems;      // b * Hkv + hk
    const int64_t e = i - bh * head_elems;
    const int64_t p0 = bh * g * head_elems + e;
    float sk = 0.f, sv = 0.f;
    for (int gi = 0; gi < g; ++gi) {
      sk += pdk[p0 + gi * head_elems];
      sv += pdv[p0 + gi * head_elems];
    }
    dk[i] = sk;
    dv[i] = sv;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ Dsum,
          float* __restrict__ dq, int Hq, int Hkv, int Tq, int S, float scale,
          int causal, int has_window, int window) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  constexpr int BQ = tile(D), BK = tile(D), MT = BK / 16, PP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x DP, pre-scaled
  float* dOs = Qs + BQ * DP;      // BQ x DP
  float* Ks = dOs + BQ * DP;      // BK x DP
  float* Vs = Ks + BK * DP;       // BK x DP
  float* dSs = Vs + BK * DP;      // BQ x PP
  float* Ls = dSs + BQ * PP;      // BQ
  float* Dl = Ls + BQ;            // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // grid (Hq, query tiles, B): the last query tile (the most key tiles
  // under a causal mask) first
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = S - Tq;

  const size_t qoff = (size_t(b) * Hq + h) * size_t(Tq);
  const size_t kvoff = (size_t(b) * Hkv + hk) * size_t(S) * D;
  load_tile<D, BQ>(Qs, q + qoff * D, q0, Tq, scale);
  load_tile<D, BQ>(dOs, dout + qoff * D, q0, Tq, 1.f);
  for (int r = tid; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < Tq;
    Ls[r] = in ? lse[qoff + q0 + r] : -INFINITY;
    Dl[r] = in ? Dsum[qoff + q0 + r] : 0.f;
  }

  float acc[MT][NC];              // queries ty*MT+i, columns tx+16c
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // the keys any real query row of this tile may see
  const int qpos_lo = q0 + offset;
  const int qpos_hi = min(q0 + BQ, Tq) - 1 + offset;
  int k_end = S;
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, qpos_lo - window + 1);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();              // the last tile's reads are done
    load_tile<D, BK>(Ks, k + kvoff, k0, S, 1.f);
    load_tile<D, BK>(Vs, v + kvoff, k0, S, 1.f);
    __syncthreads();

    float s[MT][MT], dp[MT][MT];
    score_tiles<D, MT>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = ty * MT + i;
      const float L = Ls[r];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = L > -INFINITY && allowed(q0 + r, k0 + c, Tq, S,
                                                 offset, causal, has_window,
                                                 window);
        const float p = ok ? expf(s[i][j] - L) : 0.f;
        dSs[r * PP + c] = p * (dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[MT], kv[NC];
#pragma unroll
      for (int i = 0; i < MT; ++i) sv[i] = dSs[(ty * MT + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = q0 + ty * MT + i;
    if (r >= Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[(qoff + r) * D + tx + 16 * c] = acc[i][c] * scale;
  }
}

constexpr size_t dkdv_smem(int d) {
  return sizeof(float) * (size_t(4) * tile(d) * (d + 1) +
                          size_t(2) * tile(d) * (tile(d) + 1) + 2 * tile(d));
}
constexpr size_t dq_smem(int d) {
  return sizeof(float) * (size_t(4) * tile(d) * (d + 1) +
                          size_t(tile(d)) * (tile(d) + 1) + 2 * tile(d));
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* Dsum, void* part, void* dq, void* dk, void* dv,
                   int B, int Hq, int Hkv, int Tq, int S, float scale,
                   int causal, int has_window, int window, cudaStream_t st) {
  constexpr int BT = tile(D);
  constexpr size_t smem_kv = dkdv_smem(D);
  constexpr size_t smem_q = dq_smem(D);
  static bool configured = false;   // the attributes are per kernel, once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_kv));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_q));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(Dsum);
  const int64_t rows = int64_t(B) * Hq * Tq;
  rowdot_kernel<<<unsigned((rows + 7) / 8), NTHREADS, 0, st>>>(
      dop, static_cast<const float*>(out), Dp, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (S > 0) {
    float* pdk = static_cast<float*>(part);
    float* pdv = pdk + size_t(B) * Hq * S * D;
    dim3 gkv(Hq, (S + BT - 1) / BT, B);
    dkdv_kernel<D><<<gkv, NTHREADS, smem_kv, st>>>(
        qp, kp, vp, dop, lp, Dp, pdk, pdv, Hq, Hkv, Tq, S, scale, causal,
        has_window, window);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    // a grid-stride loop; the cap only bounds the grid
    const int64_t n = int64_t(B) * Hkv * S * D;
    const int64_t blocks = std::min<int64_t>((n + NTHREADS - 1) / NTHREADS,
                                             4096);
    dkdv_reduce_kernel<<<unsigned(blocks), NTHREADS, 0, st>>>(
        pdk, pdv, static_cast<float*>(dk), static_cast<float*>(dv),
        int64_t(S) * D, n, Hq / Hkv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  dim3 gq(Hq, (Tq + BT - 1) / BT, B);
  dq_kernel<D><<<gq, NTHREADS, smem_q, st>>>(
      qp, kp, vp, dop, lp, Dp, static_cast<float*>(dq), Hq, Hkv, Tq, S, scale,
      causal, has_window, window);
  return cudaGetLastError();
}

}  // namespace

// f32 only (dtype 0; bf16 goes to flash_bwd_sm90.cu, whose interface this
// shares).  q, out, dout, dq (B, Hq, T, D); k, v, dk, dv (B, Hkv, S, D);
// lse and the scratch Dsum (B, Hq, T) f32; the scratch `part` (2, B, Hq,
// S, D) f32 (the per-query-head dk and dv: hg, the query heads a part
// sums, is 1); all contiguous; D in {32, 64, 128, 160, 256}.  Launches
// the four kernels on `stream` without synchronising and returns the first
// error.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         void* Dsum, void* part, void* dq, void* dk, void* dv,
                         int B, int Hq, int Hkv, int Tq, int S, int D,
                         float scale, int causal, int has_window, int window,
                         int dtype, int hg, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Tq <= 0 || S < 0 || Hq % Hkv != 0 ||
      dtype != 0 || hg != 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(DIM)                                               \
  int(launch<DIM>(q, k, v, out, dout, lse, Dsum, part, dq, dk, dv, B, Hq,  \
                  Hkv, Tq, S, scale, causal, has_window, window, st))
  switch (D) {
    case 32: return FLASH_BWD_LAUNCH(32);
    case 64: return FLASH_BWD_LAUNCH(64);
    case 128: return FLASH_BWD_LAUNCH(128);
    case 160: return FLASH_BWD_LAUNCH(160);
    case 256: return FLASH_BWD_LAUNCH(256);
    default: return int(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_LAUNCH
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
