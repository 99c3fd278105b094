// LayerNorm over the last axis, forward and backward: the port of the TPU
// kernels simple_tensorflow_tpu/ops/pallas/layer_norm.py:_fwd_kernel (:29,
// called from _fwd, :71) and _bwd_kernel (:42, called from _ln_bwd_rule,
// :109).
//
// Forward: per row, the f32 mean, then the CENTRED variance in a second
// pass (like _fwd_kernel, not E[x^2] - E[x]^2), rstd = 1 / sqrtf(var + eps)
// with a correctly rounded sqrtf and an IEEE division (not the rsqrtf
// approximation, so the plain PyTorch version agrees to f32 round-off), and
// y = (x - mean) * rstd * gamma + beta cast to x's dtype. gamma/beta are f32.
// The row's mean and rstd are written out (f32) when the caller asks: the
// backward reads them, as _bwd_kernel reads the forward's residuals.
//
// Backward: xhat = (x - mean) * rstd, wdo = dO * gamma,
// dx = (wdo - mean(wdo) - xhat * mean(wdo * xhat)) * rstd in x's dtype;
// dgamma = sum over rows of dO * xhat, dbeta = sum of dO (f32).
//
// What bounds them on the card: bytes. Each element is read and written once
// and takes about eight (forward) or twelve (backward) flops, far below the
// H100's 295 flops per byte ridge. The design: one block of 256 threads per
// row for the forward, three strided passes over the row (sum, centred
// square sum, normalise); the second and third passes re-read the row from
// L1/L2, not from HBM. The TPU backward summed dgamma/dbeta into ONE VMEM
// tile across its sequential grid; CUDA blocks run in no order, so here each
// block of the backward walks a run of rows, keeps its column partial sums
// in shared memory (each thread owns the columns i = tid mod 256, so no
// atomics), and writes them to a (blocks, n) workspace; a second kernel sums
// the workspace over blocks in a fixed order. Both passes are deterministic.
// Vectorised 16-byte loads and several rows per block for narrow rows are
// later work.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kLnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layer_norm_fwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int n, float eps) {
  __shared__ float red[kLnThreads / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * n;
  T* yr = y + static_cast<long long>(blockIdx.x) * n;

  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kLnThreads) s += to_f32(xr[i]);
  const float mean = block_reduce<kLnThreads, false>(s, red) / n;

  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kLnThreads) {
    const float c = to_f32(xr[i]) - mean;
    v += c * c;
  }
  const float var = block_reduce<kLnThreads, false>(v, red) / n;
  const float rstd = 1.0f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < n; i += kLnThreads) {
    const float c = to_f32(xr[i]) - mean;
    yr[i] = from_f32<T>(c * rstd * gamma[i] + beta[i]);
  }
  if (threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

// dx for rows [blockIdx.x * rpb, ...) and this block's column partial sums
// of dO * xhat and dO into part (2, blocks, n).
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layer_norm_bwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const T* __restrict__ dout, T* __restrict__ dx,
                          float* __restrict__ part, int rows, int n,
                          int rpb) {
  __shared__ float red[kLnThreads / 32];
  extern __shared__ float cols[];  // dgamma | dbeta partials, n each
  float* dg = cols;
  float* db = cols + n;
  for (int i = threadIdx.x; i < n; i += kLnThreads) dg[i] = db[i] = 0.0f;

  const int r0 = blockIdx.x * rpb;
  const int r1 = min(rows, r0 + rpb);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + static_cast<long long>(r) * n;
    const T* gr = dout + static_cast<long long>(r) * n;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = threadIdx.x; i < n; i += kLnThreads) {
      const float xhat = (to_f32(xr[i]) - mu) * rs;
      const float g = to_f32(gr[i]);
      const float wdo = g * gamma[i];
      s1 += wdo;
      s2 += wdo * xhat;
      dg[i] += g * xhat;  // column i belongs to this thread alone
      db[i] += g;
    }
    const float c1 = block_reduce<kLnThreads, false>(s1, red) / n;
    const float c2 = block_reduce<kLnThreads, false>(s2, red) / n;
    T* dr = dx + static_cast<long long>(r) * n;
    for (int i = threadIdx.x; i < n; i += kLnThreads) {
      const float xhat = (to_f32(xr[i]) - mu) * rs;
      const float wdo = to_f32(gr[i]) * gamma[i];
      dr[i] = from_f32<T>((wdo - c1 - xhat * c2) * rs);
    }
  }
  float* pg = part + static_cast<long long>(blockIdx.x) * n;
  float* pb = part + static_cast<long long>(gridDim.x + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kLnThreads) {
    pg[i] = dg[i];
    pb[i] = db[i];
  }
}

// dgamma[i] / dbeta[i] = the sum of the blocks' partials, in block order.
__global__ void __launch_bounds__(kLnThreads)
    layer_norm_bwd_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dgamma,
                                 float* __restrict__ dbeta, int blocks,
                                 int n) {
  const int i = blockIdx.x * kLnThreads + threadIdx.x;
  if (i >= n) return;
  float g = 0.0f, b = 0.0f;
  for (int k = 0; k < blocks; ++k) {
    g += part[static_cast<long long>(k) * n + i];
    b += part[static_cast<long long>(blocks + k) * n + i];
  }
  dgamma[i] = g;
  dbeta[i] = b;
}

template <typename T>
cudaError_t run_bwd(const void* x, const float* gamma, const float* mean,
                    const float* rstd, const void* dout, void* dx,
                    float* part, float* dgamma, float* dbeta, int rows,
                    int n, int rpb, cudaStream_t s) {
  const int blocks = cdiv(rows, rpb);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  auto kernel = layer_norm_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, kLnThreads, smem, s>>>(
      static_cast<const T*>(x), gamma, mean, rstd,
      static_cast<const T*>(dout), static_cast<T*>(dx), part, rows, n, rpb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_bwd_reduce_kernel<<<cdiv(n, kLnThreads), kLnThreads, 0, s>>>(
      part, dgamma, dbeta, blocks, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stf

// x, y (rows, n); gamma, beta (n,) f32; mean, rstd (rows,) f32, or both null
// when the caller needs no statistics.
extern "C" int stf_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int rows, int n, float eps,
                                  int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* mo = static_cast<float*>(mean);
  float* ro = static_cast<float*>(rstd);
  if (dtype == kF32) {
    layer_norm_fwd_kernel<float><<<rows, kLnThreads, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(y), mo, ro, n,
        eps);
  } else if (dtype == kBF16) {
    layer_norm_fwd_kernel<__nv_bfloat16><<<rows, kLnThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(y), mo, ro, n, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x, dout, dx (rows, n); gamma (n,) f32; mean, rstd (rows,) f32; part a
// (2, cdiv(rows, rpb), n) f32 workspace; dgamma, dbeta (n,) f32.
extern "C" int stf_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* mean, const void* rstd,
                                  const void* dout, void* dx, void* part,
                                  void* dgamma, void* dbeta, int rows, int n,
                                  int rpb, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return cudaSuccess;
  if (rpb <= 0) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == kF32)
    return run_bwd<float>(x, g, mu, rs, dout, dx, p, dg, db, rows, n, rpb, s);
  if (dtype == kBF16)
    return run_bwd<__nv_bfloat16>(x, g, mu, rs, dout, dx, p, dg, db, rows, n,
                                  rpb, s);
  return cudaErrorInvalidValue;
}
