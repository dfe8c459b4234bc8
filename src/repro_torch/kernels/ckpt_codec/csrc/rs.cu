// Reed-Solomon parity encode over GF(2^8) for Hopper (sm_90a): K5.
//
// Replaces rs_encode_pallas (src/repro/kernels/ckpt_codec/rs_kernel.py:87;
// body _make_encode_kernel :76).  P = C . D over GF(2^8) with the field
// polynomial 0x11D: D is (k, stride) bytes (a shard payload split into k
// rows, rs.split_rows), C the (m, k) generator rs.rs_generator_matrix
// (row 0 all ones, a pure XOR; m <= 2), P the (m, stride) parity.
//
// The Pallas kernel unrolls the field products over compile-time
// coefficients on int32 lanes.  Here the coefficients are runtime
// arguments (a 512-byte kernel parameter) and each thread multiplies 16
// bytes at a time, four to a 32-bit word: xtime (multiply by x) on a
// packed word is a masked shift plus 0x1D on each byte whose top bit was
// set, and a product by c is the Russian-peasant loop over c's bits (the
// coefficients g^i of row 1 are powers of two for i < 8, so it costs i
// xtimes).  The loop's branch depends on c only, the same across a warp.
//
// Layout.  A work item is one 16-byte-aligned chunk of one parity row, so
// every full chunk is one 16-byte store, and only the first and last chunk
// of a row, which the row's own alignment cuts, store byte by byte.  The
// data rows of an arbitrary stride are not 16-byte aligned: a thread reads
// the two aligned 16-byte granules around its 16 columns of each row (the
// second is its neighbour's first, an L1 hit) and funnel-shifts them into
// place; a granule that lies wholly outside the data is not read.  Blocks
// alternate between the parity rows over the same columns, so the second
// row's reads of the data find it in L2.
//
// What bounds it.  Bytes: k * stride read, m * stride written (at k = 4,
// m = 2 and the RWKV state's 136,314,884 bytes, 204.5 MB, 0.061 ms at
// 3.35 TB/s); the GF work is a few integer operations a byte.
//
// Bit-exact to rs.rs_encode_np (integer arithmetic only).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_K = 256;
constexpr int MAX_M = 2;

struct Coef {
  uint8_t c[MAX_M][MAX_K];
};

// multiply each of the four bytes of x by x (the field element) mod 0x11D
__device__ __forceinline__ uint32_t xtime4(uint32_t x) {
  const uint32_t top = (x >> 7) & 0x01010101u;
  return ((x & 0x7f7f7f7fu) << 1) ^ (top * 0x1du);
}

__device__ __forceinline__ uint32_t gf_mul4(uint32_t x, uint32_t c) {
  uint32_t acc = 0;
  while (true) {
    if (c & 1u) acc ^= x;
    c >>= 1;
    if (!c) break;
    x = xtime4(x);
  }
  return acc;
}

__device__ __forceinline__ uint4 granule(uintptr_t g, uintptr_t lo,
                                         uintptr_t hi) {
  if (g + 16 <= lo || g >= hi) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(g);
}

// the 16 bytes at data[off .. off + 16) as four little-endian words;
// bytes outside [lo, hi) are unspecified (the caller never stores them)
__device__ __forceinline__ void load16(uintptr_t addr, uintptr_t lo,
                                       uintptr_t hi, uint32_t (&x)[4]) {
  const uintptr_t ga = addr & ~uintptr_t(15);
  const int sh = int(addr & 15);
  const uint4 a = granule(ga, lo, hi);
  const uint4 b = granule(ga + 16, lo, hi);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int s = sh >> 2;
  const uint32_t bits = uint32_t(sh & 3) * 8;
  uint32_t y[5];
#pragma unroll
  for (int q = 0; q < 5; ++q)
    y[q] = s == 0 ? w[q] : s == 1 ? w[q + 1] : s == 2 ? w[q + 2] : w[q + 3];
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = __funnelshift_r(y[q], y[q + 1], bits);
}

__global__ void __launch_bounds__(NTHREADS)
rs_encode_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ par,
                 int k, int m, long long stride, long long nq,
                 const Coef coef) {
  const int j = blockIdx.x % m;
  const long long q = (long long)(blockIdx.x / m) * NTHREADS + threadIdx.x;
  if (q >= nq) return;
  const uintptr_t row = reinterpret_cast<uintptr_t>(par) + j * stride;
  const uintptr_t chunk = (row & ~uintptr_t(15)) + 16 * q;
  const long long col0 = (long long)(chunk - row);      // may be < 0
  if (col0 >= stride) return;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(data);
  const uintptr_t hi = lo + uintptr_t(k) * stride;
  uint32_t acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < k; ++i) {
    uint32_t x[4];
    load16(lo + i * stride + col0, lo, hi, x);
    const uint32_t c = coef.c[j][i];
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[w] ^= gf_mul4(x[w], c);
  }
  if (col0 >= 0 && col0 + 16 <= stride) {
    *reinterpret_cast<uint4*>(chunk) = make_uint4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    return;
  }
  uint8_t* out = reinterpret_cast<uint8_t*>(chunk);
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const long long col = col0 + b;
    if (col >= 0 && col < stride)
      out[b] = uint8_t(acc[b >> 2] >> (8 * (b & 3)));
  }
}

}  // namespace

// data: (k, stride) uint8, parity: (m, stride) uint8, both contiguous;
// coef: the (m, k) generator, row-major, on the host.  1 <= k <= 256,
// 1 <= m <= 2.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int rs_encode(const void* data, void* parity, int k, int m,
                         long long stride, const uint8_t* coef,
                         void* stream) {
  if (k < 1 || k > MAX_K || m < 1 || m > MAX_M || stride < 1)
    return int(cudaErrorInvalidValue);
  Coef c = {};
  for (int j = 0; j < m; ++j)
    for (int i = 0; i < k; ++i) c.c[j][i] = coef[j * k + i];
  const long long nq = (stride + 15) / 16 + 1;   // chunks a row may touch
  const long long blocks = (nq + NTHREADS - 1) / NTHREADS * m;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  rs_encode_kernel<<<unsigned(blocks), NTHREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(parity), k, m,
      stride, nq, c);
  return int(cudaGetLastError());
}

extern "C" const char* rs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
