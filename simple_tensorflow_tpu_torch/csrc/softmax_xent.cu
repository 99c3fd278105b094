// Sparse softmax cross-entropy with label smoothing, forward and backward:
// the port of the TPU kernels simple_tensorflow_tpu/ops/pallas/
// softmax_xent.py:_fwd_kernel (:32, called at :110) and _bwd_kernel (:78,
// called at :151).
//
// Forward, per row of V logits (any float dtype, read as f32): the online
// (max, sum of exp), the label's logit x_y and, with smoothing, the sum of
// the logits; lse = m + log(s) and
//   loss = lse - conf * x_y - low * (sum_x - x_y)   (smoothing > 0),
//   loss = lse - x_y                                (smoothing == 0),
// with conf = 1 - smoothing and low = smoothing / (V - 1): soft targets
// q = low + (conf - low) * onehot. (This is not PyTorch's smoothing
// convention, which spreads smoothing / V over every class.) A label outside
// [0, V) matches no column, as on the TPU.
// Backward: dx = (exp(x - lse) - q) * g in the logits' dtype.
//
// What bounds them on the card: bytes. Each logit is read once (forward) or
// read and written once (backward) and takes a handful of flops. The TPU
// streamed each row in vocab blocks with (m, s) carried in VMEM across a
// sequential grid axis. Here one block of 512 threads owns one row: each
// thread folds its strided columns into a private online (m, s), and the
// block then merges the 512 pairs (the block max M, then sum of s * exp(m -
// M)) — the same value as the sequential recurrence, in another order. The
// backward is one block per row too, writing dx with strided coalesced
// stores. Wider (16-byte) loads and several rows per block are later work.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kXeThreads = 512;

// Block-wide max of any floats (identity kNegInf); every thread gets it.
__device__ __forceinline__ float block_max_any(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kXeThreads / 32 ? red[lane] : kNegInf;
    t = warp_max(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kXeThreads)
    xent_fwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ labels, float* __restrict__ loss,
                    float* __restrict__ lse_out, int V, float conf, float low,
                    int smoothing) {
  __shared__ float red[kXeThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = logits + row * V;
  const int label = labels[row];

  float m = kNegInf, s = 0.0f, xy = 0.0f, sx = 0.0f;
  for (int c = threadIdx.x; c < V; c += kXeThreads) {
    const float x = to_f32(xr[c]);
    if (x > m) {
      s = s * expf(m - x) + 1.0f;
      m = x;
    } else {
      s += expf(x - m);
    }
    sx += x;
    if (c == label) xy = x;
  }
  const float M = block_max_any(m, red);
  const float S = block_reduce<kXeThreads, false>(s * expf(m - M), red);
  const float XY = block_reduce<kXeThreads, false>(xy, red);
  const float SX = smoothing ? block_reduce<kXeThreads, false>(sx, red) : 0.f;
  if (threadIdx.x == 0) {
    const float lse = M + logf(S);
    loss[row] = smoothing ? lse - conf * XY - low * (SX - XY) : lse - XY;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kXeThreads)
    xent_bwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, T* __restrict__ dx, int V,
                    float low, float conf_minus_low, int smoothing) {
  const long long row = blockIdx.x;
  const T* xr = logits + row * V;
  T* dr = dx + row * V;
  const int label = labels[row];
  const float l = lse[row], gr = g[row];
  for (int c = threadIdx.x; c < V; c += kXeThreads) {
    const float p = expf(to_f32(xr[c]) - l);
    const float onehot = c == label ? 1.0f : 0.0f;
    const float q = smoothing ? low + conf_minus_low * onehot : onehot;
    dr[c] = from_f32<T>((p - q) * gr);
  }
}

}  // namespace
}  // namespace stf

// logits (rows, V); labels (rows,) int32; loss, lse (rows,) f32. conf and low
// as the caller formed them (f32 of 1 - smoothing and smoothing / (V - 1)).
extern "C" int stf_softmax_xent_fwd(const void* logits, const void* labels,
                                    void* loss, void* lse, int rows, int V,
                                    float conf, float low, int smoothing,
                                    int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (V <= 0) return cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == kF32) {
    xent_fwd_kernel<float><<<rows, kXeThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, lo, ls, V, conf, low,
        smoothing);
  } else if (dtype == kBF16) {
    xent_fwd_kernel<__nv_bfloat16><<<rows, kXeThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, lo, ls, V, conf, low,
        smoothing);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dx like logits; lse, g (rows,) f32.
extern "C" int stf_softmax_xent_bwd(const void* logits, const void* labels,
                                    const void* lse, const void* g, void* dx,
                                    int rows, int V, float low,
                                    float conf_minus_low, int smoothing,
                                    int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (V <= 0) return cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (dtype == kF32) {
    xent_bwd_kernel<float><<<rows, kXeThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, ls, gg,
        static_cast<float*>(dx), V, low, conf_minus_low, smoothing);
  } else if (dtype == kBF16) {
    xent_bwd_kernel<__nv_bfloat16><<<rows, kXeThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, ls, gg,
        static_cast<__nv_bfloat16*>(dx), V, low, conf_minus_low, smoothing);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
