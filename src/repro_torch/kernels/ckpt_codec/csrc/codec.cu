// Checkpoint codec for Hopper (sm_90a): blockwise int8 quantize (K1), the
// same fused with an XOR against the previous codes (K2), and dequantize
// (K3), over the flattened (nb, 256) layout with one f32 scale per row.
//
// Replaces quantize_pallas, quantize_delta_pallas and dequantize_pallas
// (src/repro/kernels/ckpt_codec/kernel.py:54, :74, :98; bodies
// _quantize_kernel :23, _quantize_delta_kernel :31, _dequantize_kernel :41).
// The Pallas kernels walk (64, 256) tiles in VMEM, one grid step each.
// Here, in K1 and K2, one warp owns one 256-value row: each lane loads 8
// consecutive values (16 or 32 bytes), the row's absmax is reduced over
// the warp with shuffles, and each lane writes its 8 codes as one 8-byte
// store.  Warps walk the rows in a grid-stride loop.  K3 needs no
// reduction, so a warp takes RPT = 16 rows a trip and issues all their
// loads (32 coalesced 4-byte code loads and 16 scales a lane: 4 KB of
// codes a warp) before any store; each store is 4 values a lane, 512
// contiguous bytes a warp in f32, streamed past the caches (st.global.cs:
// the output is not read again here).  With one row a trip (8 code bytes
// and a scale a lane, then 1 KB of stores) at most 16 KB of reads would
// be in flight an SM, too few to cover HBM's latency at 3.35 TB/s.  K3's
// grid is the CTAs that fit on the card at once.
//
// What bounds it.  One pass over device memory with O(1) work per byte: at
// the training path's largest leaf (1.62 G f32 values) K1 moves 8.1 GB,
// 2.4 ms at 3.35 TB/s; K2 11.4 GB, 3.4 ms; K3 8.1 GB.  The design issues
// wide, coalesced loads and stores and keeps nothing but the row in
// registers.
//
// Bit-exact to the host codec (blocks.quantize_np / dequantize_np): the
// scale is absmax / 127 in f32 (1 for an all-zero row), x / scale is an
// IEEE division (__fdiv_rn, never a reciprocal multiply), rounding is half
// to even (rintf), and dequantize multiplies in f32 (__fmul_rn) before the
// one cast to the output type.  Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;        // values per quantization block (one scale)
constexpr int VPL = 8;            // values per lane: 32 lanes x 8 = BLOCK
constexpr int WARPS = 8;          // rows in flight per CUDA block
constexpr int NTHREADS = WARPS * 32;
constexpr int MAX_GRID = 132 * 32;

template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float (&v)[VPL]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[VPL]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec8<__half> {
  __device__ static void load(const __half* p, float (&v)[VPL]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

union Codes8 {
  uint2 u;
  int8_t c[VPL];
};

// the row's scale: absmax over the warp's 256 values / 127, or 1
__device__ __forceinline__ float row_scale(const float (&v)[VPL]) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m > 0.f ? __fdiv_rn(m, 127.0f) : 1.0f;
}

__device__ __forceinline__ Codes8 quantize8(const float (&v)[VPL], float s) {
  Codes8 out;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
    out.c[i] = static_cast<int8_t>(static_cast<int>(r));
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * WARPS;
  for (int64_t r = int64_t(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < nb;
       r += stride) {
    const int64_t off = r * BLOCK + lane * VPL;
    float v[VPL];
    Vec8<T>::load(x + off, v);
    const float s = row_scale(v);
    *reinterpret_cast<uint2*>(q + off) = quantize8(v, s).u;
    if (lane == 0) scales[r] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
quantize_delta_kernel(const T* __restrict__ x, const int8_t* __restrict__ prev,
                      int8_t* __restrict__ delta, float* __restrict__ scales,
                      int8_t* __restrict__ q, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * WARPS;
  for (int64_t r = int64_t(blockIdx.x) * WARPS + (threadIdx.x >> 5); r < nb;
       r += stride) {
    const int64_t off = r * BLOCK + lane * VPL;
    float v[VPL];
    Vec8<T>::load(x + off, v);
    const uint2 p = *reinterpret_cast<const uint2*>(prev + off);
    const float s = row_scale(v);
    const uint2 c = quantize8(v, s).u;
    *reinterpret_cast<uint2*>(q + off) = c;
    *reinterpret_cast<uint2*>(delta + off) = make_uint2(c.x ^ p.x, c.y ^ p.y);
    if (lane == 0) scales[r] = s;
  }
}

// four values of T from four f32 results: one 16-byte (f32) or 8-byte
// streaming store (K3's; K1 and K2 load values with Vec8 and store codes)
template <typename T>
struct Store4;

template <>
struct Store4<float> {
  __device__ static void st(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Store4<__nv_bfloat16> {
  __device__ static void st(__nv_bfloat16* p, const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b)));
  }
};

template <>
struct Store4<__half> {
  __device__ static void st(__half* p, const float (&v)[4]) {
    const __half2 a = __floats2half2_rn(v[0], v[1]);
    const __half2 b = __floats2half2_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b)));
  }
};

constexpr int RPT = 16;           // rows a warp dequantizes per trip

// Lane l's j-th word of a trip holds the codes at 128 j + 4 l .. + 3 of
// the trip's RPT rows (row j / 2): a warp's load j is 128 contiguous
// bytes, its store j 128 contiguous values.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * WARPS * RPT;
  for (int64_t r0 = (int64_t(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * RPT;
       r0 < nb; r0 += stride) {
    const int64_t off = r0 * BLOCK + 4 * lane;
    const int rows = nb - r0 < RPT ? int(nb - r0) : RPT;
    uint32_t w[2 * RPT];
    float s[RPT];
#pragma unroll
    for (int j = 0; j < 2 * RPT; ++j)
      if (j / 2 < rows)
        w[j] = __ldg(reinterpret_cast<const uint32_t*>(q + off + 128 * j));
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (j < rows) s[j] = __ldg(scales + r0 + j);
#pragma unroll
    for (int j = 0; j < 2 * RPT; ++j)
      if (j / 2 < rows) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __fmul_rn(float(static_cast<int8_t>(w[j] >> (8 * i))),
                           s[j / 2]);
        Store4<T>::st(out + off + 128 * j, v);
      }
  }
}

int grid_for(int64_t nb) {
  const int64_t g = (nb + WARPS - 1) / WARPS;
  return int(g < MAX_GRID ? g : MAX_GRID);
}

template <typename T>
cudaError_t run_quantize(const void* x, void* q, void* s, int64_t nb,
                         cudaStream_t st) {
  quantize_kernel<T><<<grid_for(nb), NTHREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), nb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_quantize_delta(const void* x, const void* prev, void* d,
                               void* s, void* q, int64_t nb, cudaStream_t st) {
  quantize_delta_kernel<T><<<grid_for(nb), NTHREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(prev),
      static_cast<int8_t*>(d), static_cast<float*>(s),
      static_cast<int8_t*>(q), nb);
  return cudaGetLastError();
}

// the CTAs of one kernel that fit on the card at once
template <typename K>
int resident_ctas(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <typename T>
cudaError_t run_dequantize(const void* q, const void* s, void* out,
                           int64_t nb, cudaStream_t st) {
  static int resident = 0;   // per output type, once
  if (resident == 0) resident = resident_ctas(dequantize_kernel<T>);
  if (resident == 0) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorUnknown;
  }
  const int64_t need = (nb + WARPS * RPT - 1) / (WARPS * RPT);
  dequantize_kernel<T><<<int(need < resident ? need : resident), NTHREADS, 0,
                         st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<T*>(out), nb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Every pointer is
// contiguous and 16-byte aligned; x / out are (nb, 256) of dtype, codes
// (nb, 256) int8, scales (nb,) f32.  Each launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int ckpt_quantize(const void* x, void* q, void* scales,
                             long long nb, int dtype, void* stream) {
  if (nb <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(run_quantize<float>(x, q, scales, nb, st));
    case 1: return int(run_quantize<__nv_bfloat16>(x, q, scales, nb, st));
    case 2: return int(run_quantize<__half>(x, q, scales, nb, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int ckpt_quantize_delta(const void* x, const void* prev,
                                   void* delta, void* scales, void* q,
                                   long long nb, int dtype, void* stream) {
  if (nb <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(run_quantize_delta<float>(x, prev, delta, scales, q, nb, st));
    case 1:
      return int(run_quantize_delta<__nv_bfloat16>(x, prev, delta, scales, q,
                                                   nb, st));
    case 2:
      return int(run_quantize_delta<__half>(x, prev, delta, scales, q, nb,
                                            st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int ckpt_dequantize(const void* q, const void* scales, void* out,
                               long long nb, int dtype, void* stream) {
  if (nb <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(run_dequantize<float>(q, scales, out, nb, st));
    case 1: return int(run_dequantize<__nv_bfloat16>(q, scales, out, nb, st));
    case 2: return int(run_dequantize<__half>(q, scales, out, nb, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* ckpt_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
