// What K7's CUDA sources share: the f32 steps of the reverse scan
// (rglru_bwd.cu, rglru_bwd_sm90.cu), and the 16-byte stores and the TMA
// map of a (B, T, D) tensor of the TMA kernels (rglru_sm90.cu,
// rglru_bwd_sm90.cu).
#pragma once

#include "../../flash_attention/csrc/sm90.cuh"
#include "../../csrc/convert.cuh"

namespace {

// The backward's steps, per channel, last token first (ops._rglru_bwd):
//
//   lam_t = dh_t + carry,   carry = a_t * lam_t,
//   dlog_a_t = lam_t * h_{t-1} * a_t
//
// each one IEEE operation rounded to nearest.  The _rn intrinsics are never
// contracted into an FMA, so the two backward kernels, which schedule these
// steps differently, round at the same places and agree bit for bit.
__device__ __forceinline__ float bwd_lam(float dh, float carry) {
  return __fadd_rn(dh, carry);
}
__device__ __forceinline__ float bwd_carry(float a, float lam) {
  return __fmul_rn(a, lam);
}
__device__ __forceinline__ float bwd_dlog_a(float lam, float hp, float a) {
  return __fmul_rn(__fmul_rn(lam, hp), a);
}

// 8 f32 values into device memory in the type of `dst`, of which the first
// `room` lie inside the row: two 16-byte stores for f32 (the second only
// when room >= 8: an f32 row may end 4 channels into the group), one for
// bf16 (rows of a multiple of 8 channels)
__device__ __forceinline__ void store8(float* dst, const float4& a,
                                       const float4& b, int room) {
  reinterpret_cast<float4*>(dst)[0] = a;
  if (room >= 8) reinterpret_cast<float4*>(dst)[1] = b;
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float4& a,
                                       const float4& b, int) {
  const __nv_bfloat162 p[4] = {__floats2bfloat162_rn(a.x, a.y),
                               __floats2bfloat162_rn(a.z, a.w),
                               __floats2bfloat162_rn(b.x, b.y),
                               __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}

// The 3-d map (D, T, B) of a contiguous (B, T, D) tensor of `elem`-byte
// values, boxes of `box_c` channels by `box_t` tokens of one batch row,
// unswizzled: a box lands row-major, token by token.  Elements outside the
// tensor (a box that starts before token 0 or runs past T or D) arrive as
// zeros.
inline cudaError_t make_rglru_map(CUtensorMap* map, const void* ptr,
                                  CUtensorMapDataType type, int elem, int D,
                                  int T, int B, int box_c, int box_t) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(T), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * elem,
                                 cuuint64_t(T) * D * elem};
  const cuuint32_t box[3] = {cuuint32_t(box_c), cuuint32_t(box_t), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
