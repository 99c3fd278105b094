// Dropout with JAX's threefry bits: the port of the JAX package's `Dropout`
// op, simple_tensorflow_tpu/ops/nn_ops.py:_dropout_lower (:388-398). That op
// is composed XLA, not Pallas: u = jax.random.uniform(key, x.shape), keep =
// u < keep_prob, out = where(keep, x / kp, 0) with kp = keep_prob in x's
// dtype. This kernel draws the same bits as JAX 0.9.0 in its partitionable
// threefry mode, so a seeded step drops the same elements as the JAX
// program:
//   (y0, y1) = threefry2x32(key, (hi, lo) of the element's flat index)
//   u        = bitcast((y0 ^ y1) >> 9 | 0x3F800000) - 1     (f32 in [0, 1))
//   keep     = u < f32(keep_prob)          (JAX's weak-typed compare)
//   out      = keep ? round_to_T(x / kp) : 0, an IEEE f32 division rounded
//              once (kp = 0.8984375 for keep_prob 0.9 in bf16)
// The backward is the same function of the cotangent with the same key.
//
// What bounds it on the card: integer operations. Threefry-2x32 is twenty
// rounds of add, rotate and xor plus five key injections, about 80 integer
// operations an element, against 4 bytes an element moved in bf16. The
// design: one element per thread in a grid-stride loop, the key schedule in
// registers, coalesced loads and stores. No table or state in memory.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kDoThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py:_threefry2x32_lowering).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0];
  uint32_t b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[i % 2][j]);
      b ^= a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return a ^ b;
}

template <typename T>
__global__ void __launch_bounds__(kDoThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                   uint32_t k0, uint32_t k1, float keep_prob, float kp) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t bits =
        threefry_bits(k0, k1, static_cast<uint32_t>(i >> 32),
                      static_cast<uint32_t>(i & 0xFFFFFFFFll));
    const float u =
        __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    out[i] = u < keep_prob ? from_f32<T>(__fdiv_rn(to_f32(x[i]), kp))
                           : from_f32<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long n, uint32_t k0,
                   uint32_t k1, float keep_prob, float kp, cudaStream_t s) {
  const long long want = (n + kDoThreads - 1) / kDoThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  dropout_kernel<T><<<blocks, kDoThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, k0, k1, keep_prob,
      kp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stf

// x, out (n,) contiguous in one dtype; (k0, k1) the raw threefry key;
// keep_prob the f32 rounding of the keep probability; kp the keep
// probability rounded to x's dtype, widened to f32.
extern "C" int stf_dropout(const void* x, void* out, long long n,
                           unsigned k0, unsigned k1, float keep_prob,
                           float kp, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (dtype == kF32) return launch<float>(x, out, n, k0, k1, keep_prob, kp, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, out, n, k0, k1, keep_prob, kp, s);
  return cudaErrorInvalidValue;
}
