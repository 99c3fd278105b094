// Fused residual + dropout(x + bias): the port of the TPU kernel
// simple_tensorflow_tpu/ops/pallas/dropout_residual.py:_kernel (:41, called
// at :71) and of the dx half of its custom VJP (_dbr_bwd_rule, :99-115).
//
// What it computes over (rows, n), per element (r, c):
//   y   = keep(r, c) ? (x + bias) * scale : 0    in f32, scale = f32(1/kp)
//   out = (residual + y) rounded once to x's dtype,  or y alone without a
//         residual (the backward's dx = keep ? g * scale : 0)
// keep(r, c) is K0 (common.cuh counter_keep) with salt 0 and the GLOBAL row
// and column, so the mask does not depend on how rows are tiled: the TPU's
// 256-row blocks and this kernel's rows draw the same bits, and the backward
// regenerates it from the seed instead of reading a stored mask, as the JAX
// VJP saves nothing. Every f32 step is rounded on its own (__fadd_rn,
// __fmul_rn: no fused multiply-add), as the plain version and XLA's composed
// lowering round.
//
// What bounds it on the card: bytes. At the training shape (4096 x 1024
// bf16) it moves 6 bytes an element (x and residual in, out) and, once the
// row hash is hoisted, does one murmur finalizer and a compare (about 10
// integer operations) an element.
//
// The design. The vector path (ops/kernels/dropout_residual.py
// vectors_per_lane picks it: at least 128 rows, n a multiple of 8 in bf16
// or 4 in f32, every pointer 16-byte aligned, a row of at most 1024
// values: 32 x 4 vectors in bf16, 32 x 8 in f32) gives a row to a warp:
// lane l holds the 16-byte vectors l + 32j of the row (in bf16 the columns
// 8l + 256j + e), NV of them, loaded before any is used. The row hash
// mix32(h0 ^ r) is taken once a row, h0 once a thread, and the bias
// vectors once a thread, reused over the rows it walks. Blocks of 8 warps walk rows grid-stride: at 4096 rows, 512 blocks,
// all resident at once on 132 SMs (the forward without a bias takes 62
// registers, dx 46). Below 128 rows, the general path's wider grid is
// faster. The general path (any n, a misaligned view, few rows) is a 2-D
// grid, blockIdx.y walking rows and 256 threads over columns, one element
// a thread.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kDrThreads = 256;
constexpr int kDrWarps = kDrThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kDrThreads)
    dropout_residual_kernel(const T* __restrict__ x,
                            const T* __restrict__ residual,
                            const T* __restrict__ bias, T* __restrict__ out,
                            int rows, int n, uint32_t seed,
                            const uint32_t* seed_ptr, uint32_t threshold, float scale) {
  const int c = blockIdx.x * kDrThreads + threadIdx.x;
  if (c >= n) return;
  const uint32_t h0 = keep_hash0(dropout_seed(seed, seed_ptr), 0u);
  const float b = bias != nullptr ? to_f32(bias[c]) : 0.0f;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long i = static_cast<long long>(r) * n + c;
    float v = to_f32(x[i]);
    if (bias != nullptr) v = __fadd_rn(v, b);
    const float y = counter_keep(h0, static_cast<uint32_t>(r),
                                 static_cast<uint32_t>(c), threshold)
                        ? __fmul_rn(v, scale)
                        : 0.0f;
    out[i] = from_f32<T>(residual != nullptr
                             ? __fadd_rn(to_f32(residual[i]), y)
                             : y);
  }
}

// vector path: a warp a row, NV 16-byte vectors a lane; kRes and kBias say
// whether a residual and a bias are given (the forward has a residual and
// may have a bias, dx has neither), so a variant holds no registers for
// what it does not read
template <typename T, int NV, bool kRes, bool kBias>
__global__ void __launch_bounds__(kDrThreads)
    dropout_residual_vec_kernel(const T* __restrict__ x,
                                const T* __restrict__ residual,
                                const T* __restrict__ bias,
                                T* __restrict__ out, int rows, int n,
                                uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                                float scale) {
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte vector
  const int lane = threadIdx.x & 31;
  const int nvec = n / kPer;
  const uint32_t h0 = keep_hash0(dropout_seed(seed, seed_ptr), 0u);
  uint4 bv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    bv[j] = kBias && v < nvec
                ? __ldg(reinterpret_cast<const uint4*>(bias) + v)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int r = blockIdx.x * kDrWarps + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * kDrWarps) {
    const long long row = static_cast<long long>(r) * nvec;
    uint4 xv[NV], rv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const long long v = row + lane + 32 * j;
      if (lane + 32 * j < nvec) {
        xv[j] = __ldg(reinterpret_cast<const uint4*>(x) + v);
        if (kRes)
          rv[j] = __ldg(reinterpret_cast<const uint4*>(residual) + v);
      }
    }
    const uint32_t hr = mix32(h0 ^ static_cast<uint32_t>(r));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lane + 32 * j;
      if (v >= nvec) continue;
      float f[kPer], b[kPer], res[kPer];
      unpack16(xv[j], f);
      if (kBias) unpack16(bv[j], b);
      if (kRes) unpack16(rv[j], res);
      const uint32_t hc = hr ^ static_cast<uint32_t>(v * kPer);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        float val = f[e];
        if (kBias) val = __fadd_rn(val, b[e]);
        // the vector's first column is a multiple of kPer: c = c0 | e
        const float y = mix32(hc ^ static_cast<uint32_t>(e)) < threshold
                            ? __fmul_rn(val, scale)
                            : 0.0f;
        f[e] = kRes ? __fadd_rn(res[e], y) : y;
      }
      reinterpret_cast<uint4*>(out)[row + v] = pack16(f);
    }
  }
}

template <typename T>
cudaError_t launch_general(const void* x, const void* residual,
                           const void* bias, void* out, int rows, int n,
                           uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold, float scale,
                           cudaStream_t s) {
  const dim3 grid(cdiv(n, kDrThreads), rows < 65535 ? rows : 65535);
  dropout_residual_kernel<T><<<grid, kDrThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, n, seed, seed_ptr,
      threshold, scale);
  return cudaGetLastError();
}

template <typename T, int NV, bool kRes, bool kBias>
cudaError_t launch_vec(const void* x, const void* residual, const void* bias,
                       void* out, int rows, int n, uint32_t seed,
                       const uint32_t* seed_ptr, uint32_t threshold, float scale, cudaStream_t s) {
  // 8 rows a block, at most 8 blocks an SM of 132
  const int want = cdiv(rows, kDrWarps);
  const int blocks = want < 132 * 8 ? want : 132 * 8;
  dropout_residual_vec_kernel<T, NV, kRes, kBias><<<blocks, kDrThreads, 0,
                                                   s>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, n, seed, seed_ptr,
      threshold, scale);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch_vec(const void* x, const void* residual, const void* bias,
                       void* out, int rows, int n, uint32_t seed,
                       const uint32_t* seed_ptr, uint32_t threshold, float scale, cudaStream_t s) {
  if (residual != nullptr && bias != nullptr)
    return launch_vec<T, NV, true, true>(x, residual, bias, out, rows, n,
                                         seed, seed_ptr, threshold, scale, s);
  if (residual != nullptr)
    return launch_vec<T, NV, true, false>(x, residual, bias, out, rows, n,
                                          seed, seed_ptr, threshold, scale, s);
  if (bias != nullptr) return cudaErrorInvalidValue;  // no caller: dx
  return launch_vec<T, NV, false, false>(x, residual, bias, out, rows, n,
                                         seed, seed_ptr, threshold, scale, s);
}

template <typename T>
cudaError_t launch(const void* x, const void* residual, const void* bias,
                   void* out, int rows, int n, uint32_t seed,
                   const uint32_t* seed_ptr, uint32_t threshold, float scale, int nv, cudaStream_t s) {
  // the vectors a lane of the shipped widths, d_model 512 and 1024: 2 and
  // 4 in bf16, 4 and 8 in f32
  constexpr bool kBf16 = sizeof(T) == 2;
  switch (nv) {
    case 0:
      return launch_general<T>(x, residual, bias, out, rows, n, seed, seed_ptr,
                               threshold, scale, s);
    case 2:
      if constexpr (kBf16)
        return launch_vec<T, 2>(x, residual, bias, out, rows, n, seed, seed_ptr,
                                threshold, scale, s);
      break;
    case 4:
      return launch_vec<T, 4>(x, residual, bias, out, rows, n, seed, seed_ptr,
                              threshold, scale, s);
    case 8:
      if constexpr (!kBf16)
        return launch_vec<T, 8>(x, residual, bias, out, rows, n, seed, seed_ptr,
                                threshold, scale, s);
      break;
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int dropout_residual_entry(const void* x, const void* residual,
                           const void* bias, void* out, int rows, int n,
                           uint32_t seed, const uint32_t* seed_ptr,
                           uint32_t threshold, float scale, int nv, int dtype,
                           cudaStream_t s) {
  if (rows <= 0 || n <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (nv != 0) {
    const int per = dtype == kF32 ? 4 : 8;
    if (n % per != 0 || n / per > 32 * nv || !aligned16(x) ||
        !aligned16(residual) || !aligned16(bias) || !aligned16(out))
      return cudaErrorInvalidValue;
  }
  if (dtype == kF32)
    return launch<float>(x, residual, bias, out, rows, n, seed, seed_ptr,
                         threshold, scale, nv, s);
  return launch<__nv_bfloat16>(x, residual, bias, out, rows, n, seed,
                               seed_ptr, threshold, scale, nv, s);
}

}  // namespace
}  // namespace stf

// x, out (rows, n); residual (rows, n) or null; bias (n,) or null; all in
// one dtype. threshold = min(int(keep_prob * 2^32), 2^32 - 1), scale =
// f32(1 / keep_prob), seed the int32 seed as uint32. nv: 0 for the general
// path, else the vector path's 16-byte vectors a lane (2 or 4 in bf16, 4
// or 8 in f32; refused unless a row is whole vectors, at most 32 * nv of
// them, every pointer is 16-byte aligned, and a bias comes with a
// residual).
extern "C" int stf_dropout_residual(const void* x, const void* residual,
                                    const void* bias, void* out, int rows,
                                    int n, unsigned seed, unsigned threshold,
                                    float scale, int nv, int dtype,
                                    void* stream) {
  return stf::dropout_residual_entry(x, residual, bias, out, rows, n, seed,
                                     nullptr, threshold, scale, nv, dtype,
                                     static_cast<cudaStream_t>(stream));
}

// stf_dropout_residual with the seed read through `seed` (a device pointer
// to the int32 seed) when the kernel starts: what a CUDA graph launches,
// whose replays refill the seed buffer. The same kernels and mask.
extern "C" int stf_dropout_residual_seed_ptr(
    const void* x, const void* residual, const void* bias, void* out,
    int rows, int n, const void* seed, unsigned threshold, float scale,
    int nv, int dtype, void* stream) {
  if (seed == nullptr) return cudaErrorInvalidValue;
  return stf::dropout_residual_entry(
      x, residual, bias, out, rows, n, 0u,
      static_cast<const uint32_t*>(seed), threshold, scale, nv, dtype,
      static_cast<cudaStream_t>(stream));
}
