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
// H100's 295 flops per byte ridge.
//
// Forward, vector path (n = 32 lanes x 16 bytes x nv with nv in 1..4 bf16,
// 1..8 f32: at most 32 values a lane, 16-byte aligned x, y, gamma and beta;
// n in {256, 512, 768, 1024} bf16, {128, 256, ..., 1024} f32): a warp per
// row. The row means divide by n (an IEEE division, as jnp.mean does: n =
// 768, BERT's width, is not a power of two). Lane l reads its share of the row as 16-byte vectors (bf16
// columns 8 l + 256 j + e) and keeps them in registers: the mean and then
// the centred variance are two passes over the registers with warp
// shuffles (no re-read, no barrier, not E[x^2] - E[x]^2), and y goes out
// as 16-byte stores. A block of 8 warps walks rows
// 8 k + w, then every 8 grid-th row; the grid stops at two blocks an SM, so
// at 4096 rows 16 warps an SM each take about two rows, and a 16-row serving
// call is two blocks of one row a warp.
// General path (any other n, or a misaligned view): one block of 256
// threads per row, three strided passes over the row (sum, centred square
// sum, normalise), one element a thread a load; the second and third passes
// re-read the row from L1/L2, not from HBM. Both paths compute the same
// arithmetic in the same order per element; only the sums' order differs.
//
// Backward, vector path (n a multiple of 32 lanes x 16 bytes, at most 32
// values a lane: n in {256, 512, 768, 1024} bf16, {128, 256, ..., 1024}
// f32, 16-byte
// aligned pointers; the wrapper picks it): a warp per row. Lane l reads its
// share of x and dO as 16-byte vectors, neighbouring lanes on neighbouring
// chunks (bf16: columns 8 l + 256 j + e), and keeps them in registers across
// both row sums and the dx pass, so x and dO are read from HBM once. Row
// sums are warp shuffles (no block barrier per row); dx goes out as 16-byte
// stores. Each lane accumulates its columns' dgamma/dbeta partials over the
// warp's rows in its own slots of shared memory (64 partials a lane at n =
// 1024 spill at the 128 registers that keep 16 warps an SM in flight); a
// block of 8 warps walks 16 rows (two a warp: 256 blocks at 4096 rows, two
// blocks an SM), then adds its warps' partials in warp order into one row of
// the (2, blocks, n) workspace.
// General path (any other n, or a misaligned view): a block of 256 threads
// walks 32 rows, one element a thread a load, with two block reductions a
// row and its column partials in shared memory. The TPU backward summed
// dgamma/dbeta into ONE VMEM tile across its sequential grid; CUDA blocks
// run in no order, so a second kernel sums the workspace over blocks in a
// fixed order (8 warps over 32 columns a block, each warp a fixed stride of
// blocks, then the warps in order). Both paths are deterministic: no float
// atomics, the same bits on every run.
#include <algorithm>

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

constexpr int kLnVecWarps = 8;
constexpr int kLnVecThreads = 32 * kLnVecWarps;

// V consecutive f32 of gamma (16-byte aligned) from L1
template <int V>
__device__ __forceinline__ void load_gamma(const float* p, float (&g)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
    g[4 * i] = t.x, g[4 * i + 1] = t.y, g[4 * i + 2] = t.z,
          g[4 * i + 3] = t.w;
  }
}

// The forward's vector path: n == 32 * NV * (16 / sizeof(T)). Warp w of
// block k takes rows 8 k + w, then every 8 gridDim.x-th row; lane l holds
// its NV 16-byte vectors of the row (chunks l + 32 j) in registers through
// the mean, the centred variance and the output.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnVecThreads, 2)
    layer_norm_fwd_vec_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int rows,
                              float eps) {
  constexpr int V = 16 / sizeof(T);  // values in 16 bytes
  constexpr int n = 32 * NV * V;     // / n: an IEEE division
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = blockIdx.x * kLnVecWarps + warp; r < rows;
       r += gridDim.x * kLnVecWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) +
                      static_cast<long long>(r) * (n / V);
    uint4 xv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) xv[j] = __ldg(xr + lane + 32 * j);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[V];
      unpack16(xv[j], f);
#pragma unroll
      for (int e = 0; e < V; ++e) s += f[e];
    }
    const float mean = warp_sum(s) / n;
    float c2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[V];
      unpack16(xv[j], f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = f[e] - mean;
        c2 += c * c;
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(c2) / n + eps);
    uint4* yr = reinterpret_cast<uint4*>(y) + static_cast<long long>(r) *
                                                  (n / V);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[V], g[V], bt[V], o[V];
      unpack16(xv[j], f);
      load_gamma<V>(gamma + V * (lane + 32 * j), g);
      load_gamma<V>(beta + V * (lane + 32 * j), bt);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (f[e] - mean) * rstd * g[e] + bt[e];
      yr[lane + 32 * j] = pack16(o);
    }
    if (lane == 0 && mean_out != nullptr) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

// The vector path: n == 32 * NV * (16 / sizeof(T)). Rows [blockIdx.x * rpb,
// ...) a warp each in turn; dx, and this block's column partial sums of
// dO * xhat and dO into part (2, blocks, n). Each lane keeps its columns'
// partials in its warp's region of shared memory, float4 q of lane l at
// (q * 32 + l): lane-private (no barrier until the block adds its warps) and
// lane-contiguous (no bank conflicts); registers hold only the row.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnVecThreads, 2)
    layer_norm_bwd_vec_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dout, T* __restrict__ dx,
                              float* __restrict__ part, int rows, int rpb) {
  constexpr int V = 16 / sizeof(T);  // values in 16 bytes
  constexpr int n = 32 * NV * V;
  constexpr int Q = V / 4;           // float4 partials of one vector
  extern __shared__ float4 sh4[];    // (2, warps, NV * Q, 32) float4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* shg = sh4 + warp * (n / 4) + lane;
  float4* shb = sh4 + (kLnVecWarps + warp) * (n / 4) + lane;
#pragma unroll
  for (int q = 0; q < NV * Q; ++q)
    shg[32 * q] = shb[32 * q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int r1 = min(rows, static_cast<int>(blockIdx.x + 1) * rpb);
  for (int r = blockIdx.x * rpb + warp; r < r1; r += kLnVecWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) +
                      static_cast<long long>(r) * (n / V);
    const uint4* gr = reinterpret_cast<const uint4*>(dout) +
                      static_cast<long long>(r) * (n / V);
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xv[j] = __ldg(xr + lane + 32 * j);
      gv[j] = __ldg(gr + lane + 32 * j);
    }
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float xf[V], gf[V], gm[V];
      unpack16(xv[j], xf);
      unpack16(gv[j], gf);
      load_gamma<V>(gamma + V * (lane + 32 * j), gm);
#pragma unroll
      for (int c = 0; c < Q; ++c) {
        float4 pg = shg[32 * (j * Q + c)], pb = shb[32 * (j * Q + c)];
        float* fg = reinterpret_cast<float*>(&pg);
        float* fb = reinterpret_cast<float*>(&pb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * c + i;
          const float xhat = (xf[e] - mu) * rs;
          const float wdo = gf[e] * gm[e];
          s1 += wdo;
          s2 += wdo * xhat;
          fg[i] += gf[e] * xhat;
          fb[i] += gf[e];
        }
        shg[32 * (j * Q + c)] = pg;
        shb[32 * (j * Q + c)] = pb;
      }
    }
    const float c1 = warp_sum(s1) / n;
    const float c2 = warp_sum(s2) / n;
    uint4* dr = reinterpret_cast<uint4*>(dx) +
                static_cast<long long>(r) * (n / V);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float xf[V], gf[V], gm[V], o[V];
      unpack16(xv[j], xf);
      unpack16(gv[j], gf);
      load_gamma<V>(gamma + V * (lane + 32 * j), gm);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (xf[e] - mu) * rs;
        o[e] = (gf[e] * gm[e] - c1 - xhat * c2) * rs;
      }
      dr[lane + 32 * j] = pack16(o);
    }
  }

  __syncthreads();
  const float* sh = reinterpret_cast<const float*>(sh4);
  float* pg = part + static_cast<long long>(blockIdx.x) * n;
  float* pb = part + static_cast<long long>(gridDim.x + blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kLnVecThreads) {
    // column i = V (l + 32 j) + e sits in float4 j Q + e / 4 of lane l
    const int v = i / V, e = i % V;
    const int at = ((v / 32 * Q + e / 4) * 32 + v % 32) * 4 + e % 4;
    float g = 0.0f, b = 0.0f;
#pragma unroll
    for (int w = 0; w < kLnVecWarps; ++w) {
      g += sh[w * n + at];
      b += sh[(kLnVecWarps + w) * n + at];
    }
    pg[i] = g;
    pb[i] = b;
  }
}

// dgamma (blockIdx.y 0) or dbeta (1) of columns [32 blockIdx.x, +32): the
// sum of the blocks' partials, warp w over blocks w, w + 8, ..., then the
// warps in order.
__global__ void __launch_bounds__(256)
    layer_norm_bwd_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dgamma,
                                 float* __restrict__ dbeta, int blocks,
                                 int n) {
  __shared__ float red[8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  const float* src =
      part + static_cast<long long>(blockIdx.y) * blocks * n + col;
  float s = 0.0f;
  if (col < n)
    for (int k = warp; k < blocks; k += 8)
      s += src[static_cast<long long>(k) * n];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < n) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][lane];
    (blockIdx.y == 0 ? dgamma : dbeta)[col] = t;
  }
}

// the vector paths' register cap: 32 values a lane (bf16 nv 4, f32 nv 8)
template <typename T>
constexpr int kMaxNv = 32 / (16 / sizeof(T));

template <typename T, int NV>
cudaError_t launch_bwd_vec(const T* x, const float* gamma, const float* mean,
                           const float* rstd, const T* dout, T* dx,
                           float* part, int rows, int rpb, cudaStream_t s) {
  constexpr int n = 32 * NV * (16 / sizeof(T));
  constexpr int smem = 2 * kLnVecWarps * n * sizeof(float);
  auto kernel = layer_norm_bwd_vec_kernel<T, NV>;
  if (smem > 48 * 1024) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
  }
  kernel<<<cdiv(rows, rpb), kLnVecThreads, smem, s>>>(
      x, gamma, mean, rstd, dout, dx, part, rows, rpb);
  return cudaGetLastError();
}

// nv vectors of 16 bytes a lane: the vector path (n == 32 nv 16 /
// sizeof(T)); 0: the general path
template <typename T>
cudaError_t run_bwd(const void* x, const float* gamma, const float* mean,
                    const float* rstd, const void* dout, void* dx,
                    float* part, float* dgamma, float* dbeta, int rows,
                    int n, int rpb, int nv, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dout);
  T* dt = static_cast<T*>(dx);
  cudaError_t e = cudaErrorInvalidValue;
  if (nv == 0) {
    const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
    auto kernel = layer_norm_bwd_kernel<T>;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<cdiv(rows, rpb), kLnThreads, smem, s>>>(
        xt, gamma, mean, rstd, gt, dt, part, rows, n, rpb);
    e = cudaGetLastError();
  } else if (n != 32 * nv * static_cast<int>(16 / sizeof(T)) ||
             nv > kMaxNv<T>) {
    return cudaErrorInvalidValue;
  } else {
#define STF_LN_BWD(NV)                                                     \
  case NV:                                                                 \
    if constexpr (NV <= kMaxNv<T>)                                         \
      e = launch_bwd_vec<T, NV>(xt, gamma, mean, rstd, gt, dt, part, rows, \
                                rpb, s);                                   \
    break;
    switch (nv) {
      STF_LN_BWD(1) STF_LN_BWD(2) STF_LN_BWD(3) STF_LN_BWD(4)
      STF_LN_BWD(5) STF_LN_BWD(6) STF_LN_BWD(7) STF_LN_BWD(8)
      default:
        return cudaErrorInvalidValue;
    }
#undef STF_LN_BWD
  }
  if (e != cudaSuccess) return e;
  layer_norm_bwd_reduce_kernel<<<dim3(cdiv(n, 32), 2), 256, 0, s>>>(
      part, dgamma, dbeta, cdiv(rows, rpb), n);
  return cudaGetLastError();
}

// 16-byte vectors a lane of the vector paths for rows of n values of T,
// or 0 (the general path): n == 32 nv 16 / sizeof(T) with 1 <= nv <=
// kMaxNv (at most 32 values a lane), and every pointer 16-byte aligned
template <typename T>
int vectors_per_lane(int n, uintptr_t ptrs) {
  constexpr int per = 32 * (16 / sizeof(T));
  const int nv = n % per == 0 ? n / per : 0;
  return nv >= 1 && nv <= kMaxNv<T> && ptrs % 16 == 0 ? nv : 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, c = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    n = c > 0 ? c : 132;
  }
  return n;
}

// blocks of the forward's vector path an SM: 16 warps, each walking about
// two rows at 4096 rows (four blocks an SM, a row a warp, ran 9% slower at
// bf16: its 127 registers let two blocks an SM in at a time)
constexpr int kLnFwdBlocksPerSm = 2;

template <typename T>
cudaError_t run_fwd(const void* x, const float* gamma, const float* beta,
                    void* y, float* mean, float* rstd, int rows, int n,
                    float eps, int nv, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  // a vector path only where the rule admits it (the general path takes
  // any row)
  if (nv != 0 && vectors_per_lane<T>(
                     n, reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(y) |
                            reinterpret_cast<uintptr_t>(gamma) |
                            reinterpret_cast<uintptr_t>(beta)) != nv)
    return cudaErrorInvalidValue;
  const int blocks =
      std::min(cdiv(rows, kLnVecWarps), kLnFwdBlocksPerSm * sm_count());
  switch (nv) {
    case 0:
      layer_norm_fwd_kernel<T><<<rows, kLnThreads, 0, s>>>(
          xt, gamma, beta, yt, mean, rstd, n, eps);
      break;
#define STF_LN_FWD(NV)                                              \
  case NV:                                                          \
    if constexpr (NV <= kMaxNv<T>)                                  \
      layer_norm_fwd_vec_kernel<T, NV><<<blocks, kLnVecThreads, 0, s>>>( \
          xt, gamma, beta, yt, mean, rstd, rows, eps);              \
    break;
      STF_LN_FWD(1) STF_LN_FWD(2) STF_LN_FWD(3) STF_LN_FWD(4)
      STF_LN_FWD(5) STF_LN_FWD(6) STF_LN_FWD(7) STF_LN_FWD(8)
#undef STF_LN_FWD
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace stf

// x, y (rows, n); gamma, beta (n,) f32; mean, rstd (rows,) f32, or both null
// when the caller needs no statistics. nv > 0: the vector path with nv
// 16-byte vectors a lane (n == 32 nv 16 / elem, nv in 1..4 bf16, 1..8 f32,
// x, y, gamma and beta 16-byte aligned: layer_norm.py vectors_per_lane's
// rule, refused otherwise); nv == 0: the general path, any n.
extern "C" int stf_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int rows, int n, float eps,
                                  int nv, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* mo = static_cast<float*>(mean);
  float* ro = static_cast<float*>(rstd);
  if (dtype == kF32)
    return run_fwd<float>(x, g, b, y, mo, ro, rows, n, eps, nv, s);
  if (dtype == kBF16)
    return run_fwd<__nv_bfloat16>(x, g, b, y, mo, ro, rows, n, eps, nv,
                                  s);
  return cudaErrorInvalidValue;
}

// x, dout, dx (rows, n); gamma (n,) f32; mean, rstd (rows,) f32; part a
// (2, cdiv(rows, rpb), n) f32 workspace; dgamma, dbeta (n,) f32. nv > 0:
// the vector path with nv 16-byte vectors a lane (n == 32 nv 16 / elem,
// every pointer 16-byte aligned, nv in 1..4 bf16, 1..8 f32); nv == 0:
// the general path.
extern "C" int stf_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* mean, const void* rstd,
                                  const void* dout, void* dx, void* part,
                                  void* dgamma, void* dbeta, int rows, int n,
                                  int rpb, int nv, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return cudaSuccess;
  if (rpb <= 0 || nv < 0) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == kF32)
    return run_bwd<float>(x, g, mu, rs, dout, dx, p, dg, db, rows, n, rpb, nv,
                          s);
  if (dtype == kBF16)
    return run_bwd<__nv_bfloat16>(x, g, mu, rs, dout, dx, p, dg, db, rows, n,
                                  rpb, nv, s);
  return cudaErrorInvalidValue;
}
