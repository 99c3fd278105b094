// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point (loaded with ctypes, see
// ops/kernels/_build.py) that launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise on
// a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

// finite "minus infinity" of the TPU kernels (ops/pallas/common.py NEG_INF):
// (-1e30) - (-1e30) is 0, never NaN
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers (ops/kernels/common.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

// 16 bytes of T (4 f32 or 8 bf16) as floats, and back (round to nearest
// even for bf16)
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum, or max of non-negative values (0 is the identity of
// both); every thread gets the result. `red` holds NT / 32 floats of shared
// memory. Ends with a barrier so the caller may reduce again with the same
// buffer.
template <int NT, bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < NT / 32 ? red[lane] : 0.0f;
    t = kMax ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// K0, the counter-hash dropout keep mask of the TPU kernels
// (ops/pallas/common.py:44-79: mix32, keep_threshold, counter_keep_mask), in
// native uint32 arithmetic. A pure function of (seed, salt, row, col), so
// forward and backward regenerate the same mask from the seed and nothing is
// stored. The caller computes keep_hash0 once per (seed, salt) and the
// threshold min(int(keep_prob * 2^32), 2^32 - 1) on the host.
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t keep_hash0(uint32_t seed, uint32_t salt) {
  return mix32(seed ^ (salt * 0x9E3779B9u));
}

// The dropout seed of a launch: read through `seed_ptr` (a device int32,
// e.g. a row of the seed buffer a CUDA graph's replays refill) when it is
// given, else the launch argument `seed`. Both give the same mask.
__device__ __forceinline__ uint32_t dropout_seed(uint32_t seed,
                                                 const uint32_t* seed_ptr) {
  return seed_ptr != nullptr ? __ldg(seed_ptr) : seed;
}

__device__ __forceinline__ bool counter_keep(uint32_t h0, uint32_t row,
                                             uint32_t col,
                                             uint32_t threshold) {
  return mix32(mix32(h0 ^ row) ^ col) < threshold;
}

}  // namespace stf
