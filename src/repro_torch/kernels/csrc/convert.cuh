// The port's CUDA sources that take f32 and bf16 tensors read every value
// as f32 (to_f32) and round each f32 result to nearest into the output's
// type once (from_f32).  Included inside no namespace; the helpers have
// internal linkage, one copy in each library.
#pragma once

#include <cuda_bf16.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace
