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
// regenerates it from the seed instead of reading a stored mask. Every f32
// step is rounded on its own (__fadd_rn, __fmul_rn: no fused multiply-add),
// as the plain version and XLA's composed lowering round.
//
// What bounds it on the card: bytes and integer operations are close. At
// the training shape (4096 x 1024 bf16) it moves 6 bytes an element (x and
// residual in, out) and does three murmur finalizers (~30 integer
// operations) an element. The design: a 2-D grid, blockIdx.y walking rows
// and 256 threads over columns, so row and column need no division and
// every load and store is coalesced; the per-(seed, salt) hash is hoisted
// out of the loop. Vectorised 16-byte accesses are later work.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kDrThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDrThreads)
    dropout_residual_kernel(const T* __restrict__ x,
                            const T* __restrict__ residual,
                            const T* __restrict__ bias, T* __restrict__ out,
                            int rows, int n, uint32_t seed,
                            uint32_t threshold, float scale) {
  const int c = blockIdx.x * kDrThreads + threadIdx.x;
  if (c >= n) return;
  const uint32_t h0 = keep_hash0(seed, 0u);
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

template <typename T>
cudaError_t launch(const void* x, const void* residual, const void* bias,
                   void* out, int rows, int n, uint32_t seed,
                   uint32_t threshold, float scale, cudaStream_t s) {
  const dim3 grid(cdiv(n, kDrThreads), rows < 65535 ? rows : 65535);
  dropout_residual_kernel<T><<<grid, kDrThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, n, seed,
      threshold, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stf

// x, out (rows, n); residual (rows, n) or null; bias (n,) or null; all in
// one dtype. threshold = min(int(keep_prob * 2^32), 2^32 - 1), scale =
// f32(1 / keep_prob), seed the int32 seed as uint32.
extern "C" int stf_dropout_residual(const void* x, const void* residual,
                                    const void* bias, void* out, int rows,
                                    int n, unsigned seed, unsigned threshold,
                                    float scale, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return cudaSuccess;
  if (dtype == kF32)
    return launch<float>(x, residual, bias, out, rows, n, seed, threshold,
                         scale, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, residual, bias, out, rows, n, seed,
                                 threshold, scale, s);
  return cudaErrorInvalidValue;
}
