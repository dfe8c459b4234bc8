// Building blocks of the chunked RWKV-6 kernels on the tensor cores, the
// forward (rwkv6_sm90.cu) and the backward (rwkv6_bwd_sm90.cu): mma.sync
// with split-bf16 operands, swizzled shared tiles, the table of decay
// products over sub-chunks and the pairs inside 8 tokens on CUDA cores.
//
// A chunk of 64 tokens is four sub-chunks of 16, each two halves of 8.
// Every decay factor is a product of w = exp(log_w) over a run of tokens,
// so it lies in [0, 1] and no exponent can overflow: running products
// inside a half, a half's or a sub-chunk's whole decay across them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// rows of the table of per-channel decay products over sub-chunks, W_x the
// decay over sub-chunk x and U_x over its second half (tokens 8..15):
constexpr int T_PQ = 0;     // [q]: prod_{x < q} W_x
constexpr int T_FU = 4;     // [pair(a, q)]: prod_{a < x < q} W_x
constexpr int T_FL = 10;    //   the same times U_a
constexpr int T_GU = 16;    // [a]: prod_{x > a} W_x
constexpr int T_GL = 20;    //   the same times U_a
constexpr int T_TOT = 24;   // prod_x W_x
constexpr int T_WUP = 25;   // [x]: U_x
constexpr int T_WLO = 29;   // [x]: the decay over tokens 0..7 of x
constexpr int T_ROWS = 33;

// the index of sub-chunk pair a < q among (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
__device__ __forceinline__ int pair(int a, int q) {
  return 3 * a - a * (a - 1) / 2 + q - a - 1;
}

__device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16 pairs hi and lo with hi + lo = (x, y) to about 2^-17
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the three products of two split operands, a_hi b_hi + a_hi b_lo + a_lo
// b_hi, into d
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, ah, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, al, bh0, bh1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// N adjacent bf16 (N = 1, 2, 4) as floats, from a 2 N-byte aligned address
template <int N>
__device__ __forceinline__ void load_bf(const uint8_t* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

// N adjacent floats (N = 1, 2, 4) from a 4 N-byte aligned address
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *p;
  }
}

// one butterfly step of a reduce-scatter over lanes `mask` apart: a lane
// with `upper` set keeps slots N .. 2N - 1 of `in`, its partner 0 .. N - 1,
// each adding the other's copy of the slots it keeps
template <int N>
__device__ __forceinline__ void reduce_half(const float (&in)[2 * N],
                                            float (&out)[N], int upper,
                                            int mask) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float keep = upper ? in[N + j] : in[j];
    const float send = upper ? in[j] : in[N + j];
    out[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}


// The pairs inside one half of 8 tokens, the bonus on the diagonal:
// entry (t, i), i <= t, of A is sum_c r_t[c] k_i[c] prod_{i < m < t} w_m[c]
// (u[c] instead of the product on the diagonal).  The 16 lanes of a half
// (sl = 0..15) each hold CPL adjacent channels: the half's 8 rows of r and
// w in rr and ww, u in ul; kload(i, kd) brings key i's k.  Every key i
// walks the later tokens with the running decay kd (k_i at token i + 1),
// summing the lane's channels' terms of all 36 entries; a butterfly over
// the 16 lanes then reduces and scatters them, 3 a lane, to store(t, i,
// value).
template <int CPL, class KLoad, class Store>
__device__ __forceinline__ void half_pairs(const float (&rr)[8][CPL],
                                           const float (&ww)[8][CPL],
                                           const float (&ul)[CPL], int sl,
                                           KLoad kload, Store store) {
  float v[48];
#pragma unroll
  for (int j = 0; j < 48; ++j) v[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float kd[CPL];
    kload(i, kd);
    float b = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) b = fmaf(rr[i][e] * ul[e], kd[e], b);
    v[i * (i + 1) / 2 + i] = b;
#pragma unroll
    for (int t = i + 1; t < 8; ++t) {
      float a = v[t * (t + 1) / 2 + i];
#pragma unroll
      for (int e = 0; e < CPL; ++e) a = fmaf(rr[t][e], kd[e], a);
      v[t * (t + 1) / 2 + i] = a;
      if (t < 7) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) kd[e] *= ww[t][e];
      }
    }
  }
  // entry (t, i), i <= t, is slot t (t + 1) / 2 + i of 48; each step
  // keeps half the slots and adds the partner's
  float v24[24], v12[12], v6[6], v3[3];
  reduce_half<24>(v, v24, sl & 8, 8);
  reduce_half<12>(v24, v12, sl & 4, 4);
  reduce_half<6>(v12, v6, sl & 2, 2);
  reduce_half<3>(v6, v3, sl & 1, 1);
  const int base = 24 * ((sl >> 3) & 1) + 12 * ((sl >> 2) & 1) +
                   6 * ((sl >> 1) & 1) + 3 * (sl & 1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int slot = base + j;
    if (slot < 36) {
      int t = 0;
      while ((t + 1) * (t + 2) / 2 <= slot) ++t;
      store(t, slot - t * (t + 1) / 2, v3[j]);
    }
  }
}

// The table's products from its rows T_WUP and T_WLO, for channel c of a
// table of D floats a row
template <int D>
__device__ __forceinline__ void build_table(float* tab, int c) {
  float up[4], wq[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    up[x] = tab[(T_WUP + x) * D + c];
    wq[x] = tab[(T_WLO + x) * D + c] * up[x];
  }
  float p = 1.f;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    tab[(T_PQ + x) * D + c] = p;
    p *= wq[x];
  }
  tab[T_TOT * D + c] = p;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float f = 1.f;
#pragma unroll
    for (int x = a + 1; x < 4; ++x) {
      tab[(T_FU + pair(a, x)) * D + c] = f;
      tab[(T_FL + pair(a, x)) * D + c] = f * up[a];
      f *= wq[x];
    }
    float gq = 1.f;
#pragma unroll
    for (int x = a + 1; x < 4; ++x) gq *= wq[x];
    tab[(T_GU + a) * D + c] = gq;
    tab[(T_GL + a) * D + c] = gq * up[a];
  }
}

}  // namespace
