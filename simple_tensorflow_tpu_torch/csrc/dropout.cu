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
// u is (y0 ^ y1) >> 9 times 2^-23 exactly, so the keep test is the integer
// compare (y0 ^ y1) <= limit, limit = 512 * ceil(f32(keep_prob) * 2^23) - 1
// (ops/kernels/dropout.py keep_bits_limit): no shift, or, float subtract or
// float compare an element. The forward has two entries over the same
// kernels: the key as launch arguments (stf_dropout, the eager callers), or
// read through a device pointer (stf_dropout_key, for a CUDA graph whose
// replays must each draw with the run's new key).
//
// The forward also writes the keep mask as bits, for the backward: a uint8
// tensor of ceil(n / 8) bytes, bit e of byte j the element 8j + e, the tail
// of the last byte zero (2 MiB at the FFN shape 16 x 256 x 4096). The
// backward is the JAX VJP of where(mask, x / kp, 0) with the mask saved, as
// the JAX program keeps it: dx = bit ? g / kp : 0, read from those bits. It
// draws nothing.
//
// What bounds the forward on the card: integer instruction issue. Each
// element is twenty rounds of add, rotate and xor plus key injections:
// at least 69 instructions, at 128 lanes a clock an SM. The xors (LOP3)
// and the compare run only on the ALU pipe, 64 lanes a clock an SM; the
// adds can issue on the FMA pipe as IMAD, and so could a rotate (as
// IMAD.WIDE), though here each is one SHF on the ALU. Bytes are 4 an
// element in bf16 (+1/8 for the bits), well under that. The design: the vector path
// gives a thread 8 consecutive elements, one 16-byte load and store in bf16
// (two in f32) and one mask byte, counters in 32 bits (the high index word
// is the constant 0 while n <= 2^32), the key schedule and the injection
// constants hoisted out of the element loop, each rotate one funnel shift.
// The general path (odd n, a misaligned view, n > 2^32) is one element a
// thread with a 64-bit index; a warp ballot packs its 32 keep bits into 4
// mask bytes. The backward is bound by bytes (2 + 2 + 1/8 an element in
// bf16): a thread reads 16 bytes of g and one mask byte and writes 16.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kDoThreads = 256;
constexpr int kVec = 8;  // elements a thread on the vector path

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);  // one SHF.L.W
}

// a + b written as a * one + b with one == 1 known only at run time: an
// IMAD on the FMA pipe. The integer ALU runs the rotates (SHF) and xors
// (LOP3), so the adds are kept off it; left alone, ptxas issues some of
// them there (VIADD, IADD3).
__device__ __forceinline__ uint32_t fma_add(uint32_t a, uint32_t one,
                                            uint32_t b) {
  return a * one + b;
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py:_threefry2x32_lowering), with
// the key schedule and the five injection constants held in registers.
struct Threefry {
  uint32_t k0, k1, one;
  uint32_t inj_a[5];  // ks[(i + 1) % 3]
  uint32_t inj_b[5];  // ks[(i + 2) % 3] + i + 1

  __device__ __forceinline__ Threefry(uint32_t key0, uint32_t key1,
                                      uint32_t one_)
      : k0(key0), k1(key1), one(one_) {
    const uint32_t ks[3] = {key0, key1, key0 ^ key1 ^ 0x1BD11BDAu};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      inj_a[i] = ks[(i + 1) % 3];
      inj_b[i] = ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }

  // y0 ^ y1 of the counter (x0, x1)
  __device__ __forceinline__ uint32_t bits(uint32_t x0, uint32_t x1) const {
    constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t a = fma_add(x0, one, k0);
    uint32_t b = fma_add(x1, one, k1);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a = fma_add(b, one, a);
        b = rotl(b, rot[i % 2][j]) ^ a;
      }
      a = fma_add(a, one, inj_a[i]);
      b = fma_add(b, one, inj_b[i]);
    }
    return a ^ b;
  }
};

// 8 values of T at vector index g (16 bytes of bf16, 32 of f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, uint32_t g,
                                      float (&f)[8]) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p) + g), f);
}
__device__ __forceinline__ void load8(const float* p, uint32_t g,
                                      float (&f)[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p) + 2 * g;
  const uint4 u = __ldg(q), v = __ldg(q + 1);
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  f[4] = __uint_as_float(v.x), f[5] = __uint_as_float(v.y);
  f[6] = __uint_as_float(v.z), f[7] = __uint_as_float(v.w);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, uint32_t g,
                                       const float (&f)[8]) {
  reinterpret_cast<uint4*>(p)[g] = pack16(f);
}
__device__ __forceinline__ void store8(float* p, uint32_t g,
                                       const float (&f)[8]) {
  uint4* q = reinterpret_cast<uint4*>(p) + 2 * g;
  q[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
  q[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                    __float_as_uint(f[6]), __float_as_uint(f[7]));
}

// The key: (k0, k1) as launch arguments, or, where dkey is not null, the
// two words it points at on the device (read once a thread). A CUDA graph
// that captured a launch replays its arguments unchanged; a key read
// through a pointer can change between replays.
__device__ __forceinline__ Threefry make_threefry(const uint32_t* dkey,
                                                  uint32_t k0, uint32_t k1,
                                                  uint32_t one) {
  if (dkey != nullptr) {
    k0 = __ldg(dkey);
    k1 = __ldg(dkey + 1);
  }
  return Threefry(k0, k1, one);
}

// vector path: thread g of the grid-stride walk takes elements 8g .. 8g + 7
template <typename T>
__global__ void __launch_bounds__(kDoThreads)
    dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                       uint8_t* __restrict__ bits, uint32_t groups,
                       const uint32_t* __restrict__ dkey, uint32_t k0,
                       uint32_t k1, uint32_t limit, float kp,
                       uint32_t one) {
  const Threefry tf = make_threefry(dkey, k0, k1, one);
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    float v[kVec];
    load8(x, g, v);
    uint32_t r[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) r[e] = tf.bits(0u, kVec * g + e);
    uint32_t mask = 0;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const bool keep = r[e] <= limit;
      mask |= keep ? 1u << e : 0u;
      const float q = __fdiv_rn(v[e], kp);
      v[e] = keep ? q : 0.0f;
    }
    store8(out, g, v);
    bits[g] = static_cast<uint8_t>(mask);
  }
}

// general path: one element a thread, 64-bit index; each warp walks 32
// consecutive elements together and packs its keep bits with a ballot
template <typename T>
__global__ void __launch_bounds__(kDoThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                   uint8_t* __restrict__ bits, long long n,
                   const uint32_t* __restrict__ dkey, uint32_t k0,
                   uint32_t k1, uint32_t limit, float kp, uint32_t one) {
  const Threefry tf = make_threefry(dkey, k0, k1, one);
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x - lane;
       i0 < n; i0 += stride) {
    const long long i = i0 + lane;
    bool keep = false;
    if (i < n) {
      keep = tf.bits(static_cast<uint32_t>(i >> 32),
                     static_cast<uint32_t>(i & 0xFFFFFFFFll)) <= limit;
      out[i] = keep ? from_f32<T>(__fdiv_rn(to_f32(x[i]), kp))
                    : from_f32<T>(0.0f);
    }
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, keep);
    if ((lane & 7) == 0 && i < n)
      bits[i >> 3] = static_cast<uint8_t>(word >> lane);
  }
}

// backward, vector path: 8 elements of g and their mask byte a thread
template <typename T>
__global__ void __launch_bounds__(kDoThreads)
    dropout_bwd_vec_kernel(const T* __restrict__ g,
                           const uint8_t* __restrict__ bits,
                           T* __restrict__ out, uint32_t groups, float kp) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += stride) {
    float v[kVec];
    load8(g, i, v);
    const uint32_t mask = __ldg(bits + i);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = (mask >> e) & 1u ? __fdiv_rn(v[e], kp) : 0.0f;
    store8(out, i, v);
  }
}

// backward, general path: one element a thread
template <typename T>
__global__ void __launch_bounds__(kDoThreads)
    dropout_bwd_kernel(const T* __restrict__ g,
                       const uint8_t* __restrict__ bits, T* __restrict__ out,
                       long long n, float kp) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const bool keep = (__ldg(bits + (i >> 3)) >> (i & 7)) & 1;
    out[i] = keep ? from_f32<T>(__fdiv_rn(to_f32(g[i]), kp))
                  : from_f32<T>(0.0f);
  }
}

// blocks of a grid-stride launch over `items`, at most 64 an SM of 132
int blocks_for(long long items) {
  const long long want = (items + kDoThreads - 1) / kDoThreads;
  return static_cast<int>(want < 132 * 64 ? want : 132 * 64);
}

// the vector path's preconditions: n a multiple of 8 no larger than 2^32,
// every pointer 16-byte aligned
bool vector_ok(long long n, const void* a, const void* b) {
  return n % kVec == 0 && n <= (1ll << 32) &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* out, void* bits, long long n,
                       const uint32_t* dkey, uint32_t k0, uint32_t k1,
                       uint32_t limit, float kp, bool vec, cudaStream_t s) {
  if (vec) {
    const uint32_t groups = static_cast<uint32_t>(n / kVec);
    dropout_vec_kernel<T><<<blocks_for(groups), kDoThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<uint8_t*>(bits), groups, dkey, k0, k1, limit, kp, 1u);
  } else {
    dropout_kernel<T><<<blocks_for(n), kDoThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<uint8_t*>(bits), n, dkey, k0, k1, limit, kp, 1u);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(const void* x, void* out, void* bits, long long n,
                         const uint32_t* dkey, uint32_t k0, uint32_t k1,
                         uint32_t limit, float kp, int vec, int dtype,
                         cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  if (vec && !vector_ok(n, x, out)) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_fwd<float>(x, out, bits, n, dkey, k0, k1, limit, kp, vec,
                             s);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(x, out, bits, n, dkey, k0, k1, limit,
                                     kp, vec, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* bits, void* out,
                       long long n, float kp, bool vec, cudaStream_t s) {
  if (vec) {
    const uint32_t groups = static_cast<uint32_t>(n / kVec);
    dropout_bwd_vec_kernel<T><<<blocks_for(groups), kDoThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const uint8_t*>(bits),
        static_cast<T*>(out), groups, kp);
  } else {
    dropout_bwd_kernel<T><<<blocks_for(n), kDoThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const uint8_t*>(bits),
        static_cast<T*>(out), n, kp);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace stf

// x, out (n,) contiguous in one dtype; bits (ceil(n / 8),) uint8; (k0, k1)
// the raw threefry key; limit the largest kept y0 ^ y1; kp the keep
// probability rounded to x's dtype, widened to f32; vec 1 for the vector
// path (refused unless n % 8 == 0, n <= 2^32 and x, out 16-byte aligned).
extern "C" int stf_dropout(const void* x, void* out, void* bits, long long n,
                           unsigned k0, unsigned k1, unsigned limit,
                           float kp, int vec, int dtype, void* stream) {
  return stf::dispatch_fwd(x, out, bits, n, nullptr, k0, k1, limit, kp, vec,
                           dtype, static_cast<cudaStream_t>(stream));
}

// The same forward with the key read on the device: key points at the two
// uint32 words (k0, k1), which may change between the replays of a CUDA
// graph that captured this launch. Same kernels, so the same bits as
// stf_dropout for the same key.
extern "C" int stf_dropout_key(const void* x, void* out, void* bits,
                               long long n, const void* key, unsigned limit,
                               float kp, int vec, int dtype, void* stream) {
  if (key == nullptr) return cudaErrorInvalidValue;
  return stf::dispatch_fwd(x, out, bits, n, static_cast<const uint32_t*>(key),
                           0u, 0u, limit, kp, vec, dtype,
                           static_cast<cudaStream_t>(stream));
}

// g, out (n,) contiguous in one dtype; bits the forward's mask bytes; kp as
// above; vec as above (g and out 16-byte aligned).
extern "C" int stf_dropout_bwd(const void* g, const void* bits, void* out,
                               long long n, float kp, int vec, int dtype,
                               void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  if (vec && !vector_ok(n, g, out)) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch_bwd<float>(g, bits, out, n, kp, vec, s);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(g, bits, out, n, kp, vec, s);
  return cudaErrorInvalidValue;
}
