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
// sequential grid axis. Here the rows run in parallel and a row's columns
// are split over threads that each fold theirs into a private (m, s, x_y,
// sum_x), merged afterwards — the sequential recurrence's value in another
// order.
// The forward gives a row TPR threads (xent_fwd_threads; ops/kernels/
// softmax_xent.py fwd_threads_per_row states the rule; on an H100 one
// vector a thread ran the small rows fastest, and 256 threads the large
// ones as fast as 512), so a launch has a thread for each vector where one
// block of 512 threads a row left most of them without a column:
// - up to 32 columns (the MNIST head's 10 classes, NSP's 2) a warp owns a
//   row, one column a lane, 8 rows a block. The row max, then the sum of
//   exp(x - max) with the accurate expf, x_y and the sum of x, each by xor
//   shuffles (16, 8, .., 1): the plain version's terms, summed in the tree
//   that reproduced its loss and lse bit for bit at 512 x 10 on an H100,
//   which the f32 MNIST check needs (it holds every variable within 1e-5
//   of the plain run after 3 Adam steps, and a few ulp of lse moved one by
//   2.7e-2);
// - then one thread a 16-byte vector: up to 128 columns in f32 (256 in
//   bf16: seq2seq's 120 words) a group of 8 to 32 lanes of a warp owns a
//   row, 256 / TPR rows a block, the group's values merged by shuffles
//   with no barrier; past that (ResNet's 1000, PTB's 10000, BERT's 30522,
//   the LMs' 32000 and 32768) a row takes 2 to 8 warps of one block, each
//   warp's (m, s) pairs merged by shuffles and the warps' four values
//   through shared memory after one barrier.
// Loads are 16 bytes (4 f32 or 8 bf16) wherever the row is 16-byte
// aligned; a row that is not (bf16 rows of 61,044 bytes at V = 30522)
// takes its unaligned head and its tail element by element and its body in
// 16-byte vectors. Each thread keeps 4 vectors in flight, a vector's max
// folded in before its 4 or 8 exp terms (ex2 on the special-function
// unit; the one-column-a-lane path keeps the accurate expf of the plain
// version's exp). x_y is one load by the row's first thread. No atomics:
// the merge order is fixed, so two launches give the same bits. One launch
// a call.
// The backward is one block of 512 threads per row, writing dx with
// strided coalesced stores.
#include "mma.cuh"

namespace stf {
namespace {

constexpr int kXeThreads = 512;  // the backward's block
constexpr int kXeBlock = 256;    // the forward's block
constexpr int kXeVecs = 4;       // 16-byte loads a forward thread issues at once

// e^x: the accurate expf (kExact: the plain version's exp, term for term)
// or ex2(x log2 e) on the special-function unit (2 ulp; two instructions
// against some ten)
template <bool kExact>
__device__ __forceinline__ float xent_exp(float x) {
  return kExact ? expf(x) : ex2(x * kLog2e);
}

// (m, s) <- the online softmax state of the union of (m, s) and (m2, s2)
template <bool kExact>
__device__ __forceinline__ void xent_merge(float& m, float& s, float m2,
                                           float s2) {
  const float mx = fmaxf(m, m2);
  s = s * xent_exp<kExact>(m - mx) + s2 * xent_exp<kExact>(m2 - mx);
  m = mx;
}

// the forward's running (m, s, sum_x) over one thread's columns
template <bool kExact>
struct XentFold {
  float m = kNegInf, s = 0.0f, sx = 0.0f;

  __device__ __forceinline__ void one(float x) {
    if (x > m) {
      s = s * xent_exp<kExact>(m - x) + 1.0f;
      m = x;
    } else {
      s += xent_exp<kExact>(x - m);
    }
    sx += x;
  }

  template <int N>
  __device__ __forceinline__ void vec(const float (&f)[N]) {
    float mx = f[0];
#pragma unroll
    for (int e = 1; e < N; ++e) mx = fmaxf(mx, f[e]);
    if (mx > m) {
      s *= xent_exp<kExact>(m - mx);
      m = mx;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s += xent_exp<kExact>(f[e] - m);
      sx += f[e];
    }
  }
};

// grid cdiv(rows, kXeBlock / TPR); TPR threads a row (a power of two, 8
// .. kXeBlock). kLane (TPR = 32, V <= 32): one column a lane
template <typename T, int TPR, bool kLane>
__global__ void __launch_bounds__(kXeBlock)
    xent_fwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ labels, float* __restrict__ loss,
                    float* __restrict__ lse_out, int rows, int V, float conf,
                    float low, int smoothing) {
  constexpr int NT = kXeBlock;
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte vector
  const int sub = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / TPR) + threadIdx.x / TPR;
  const bool live = row < rows;
  XentFold<kLane> f;
  float xy = 0.0f;
  if (live) {
    const T* xr = logits + row * V;
    const int label = labels[row];
    if (sub == 0 && label >= 0 && label < V) xy = to_f32(xr[label]);
    if constexpr (kLane) {
      if (sub < V) f.one(to_f32(xr[sub]));
    } else {
      // elements before the first 16-byte boundary, whole vectors, the rest
      const int mis = static_cast<int>(
          (reinterpret_cast<uintptr_t>(xr) & 15) / sizeof(T));
      const int head = mis ? min(PER - mis, V) : 0;
      const int nvec = (V - head) / PER;
      for (int c = sub; c < head; c += TPR) f.one(to_f32(xr[c]));
      const uint4* body = reinterpret_cast<const uint4*>(xr + head);
      int i = sub;
      for (; i + (kXeVecs - 1) * TPR < nvec; i += kXeVecs * TPR) {
        uint4 u[kXeVecs];
#pragma unroll
        for (int j = 0; j < kXeVecs; ++j) u[j] = body[i + j * TPR];
#pragma unroll
        for (int j = 0; j < kXeVecs; ++j) {
          float x[PER];
          unpack16(u[j], x);
          f.vec(x);
        }
      }
      for (; i < nvec; i += TPR) {
        float x[PER];
        unpack16(body[i], x);
        f.vec(x);
      }
      for (int c = head + nvec * PER + sub; c < V; c += TPR)
        f.one(to_f32(xr[c]));
    }
  }
  if constexpr (TPR <= 32) {
    // within a group of lanes: the row max, then the sums of s exp(m - M),
    // x_y and x by xor shuffles
    float mx = f.m;
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    f.s *= xent_exp<kLane>(f.m - mx);
    f.m = mx;
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) {
      f.s += __shfl_xor_sync(0xffffffffu, f.s, o);
      xy += __shfl_xor_sync(0xffffffffu, xy, o);
      f.sx += __shfl_xor_sync(0xffffffffu, f.sx, o);
    }
  } else {
    // the row's warps: (m, s) pairs merged by shuffles in each warp, then
    // the warps' four values through shared memory, one barrier
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, f.m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, f.s, o);
      xy += __shfl_xor_sync(0xffffffffu, xy, o);
      f.sx += __shfl_xor_sync(0xffffffffu, f.sx, o);
      xent_merge<kLane>(f.m, f.s, m2, s2);
    }
    __shared__ float red[NT / 32][4];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[warp][0] = f.m, red[warp][1] = f.s, red[warp][2] = xy,
      red[warp][3] = f.sx;
    }
    __syncthreads();
    if (sub == 0) {
      for (int w = warp + 1; w < warp + TPR / 32; ++w) {
        xent_merge<kLane>(f.m, f.s, red[w][0], red[w][1]);
        xy += red[w][2];
        f.sx += red[w][3];
      }
    }
  }
  if (live && sub == 0) {
    const float lse = f.m + logf(f.s);
    loss[row] = smoothing ? lse - conf * xy - low * (f.sx - xy) : lse - xy;
    lse_out[row] = lse;
  }
}

// a logit's bytes: 4 (f32) or 2 (bf16)
int elem_bytes(int dtype) { return dtype == kBF16 ? 2 : 4; }

template <typename T, int TPR, bool kLane = false>
void launch_fwd(const void* logits, const int* labels, float* loss,
                float* lse, int rows, int V, float conf, float low,
                int smoothing, cudaStream_t s) {
  xent_fwd_kernel<T, TPR, kLane>
      <<<cdiv(rows, kXeBlock / TPR), kXeBlock, 0, s>>>(
          static_cast<const T*>(logits), labels, loss, lse, rows, V, conf,
          low, smoothing);
}

// Threads a row of the forward for V logits of `dtype`: a warp, one column
// a lane, up to 32 columns; past them one thread a 16-byte vector of the
// row, as a power of two from 8 to a block (kXeBlock).
int xent_fwd_threads(int V, int dtype) {
  if (V <= 32) return 32;
  const long long vecs =
      (static_cast<long long>(V) * elem_bytes(dtype) + 15) / 16;
  int tpr = 8;
  while (tpr < kXeBlock && tpr < vecs) tpr *= 2;
  return tpr;
}

template <typename T>
void launch_fwd_tpr(int tpr, const void* logits, const int* labels,
                    float* loss, float* lse, int rows, int V, float conf,
                    float low, int smoothing, cudaStream_t s) {
  if (V <= 32)
    return launch_fwd<T, 32, true>(logits, labels, loss, lse, rows, V, conf,
                                   low, smoothing, s);
  switch (tpr) {
#define STF_XENT_TPR(n)                                                     \
  case n:                                                                  \
    return launch_fwd<T, n>(logits, labels, loss, lse, rows, V, conf, low, \
                            smoothing, s);
    STF_XENT_TPR(8)
    STF_XENT_TPR(16)
    STF_XENT_TPR(32)
    STF_XENT_TPR(64)
    STF_XENT_TPR(128)
    STF_XENT_TPR(256)
#undef STF_XENT_TPR
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
  const int tpr = xent_fwd_threads(V, dtype);
  if (dtype == kF32) {
    launch_fwd_tpr<float>(tpr, logits, lab, lo, ls, rows, V, conf, low,
                          smoothing, s);
  } else if (dtype == kBF16) {
    launch_fwd_tpr<__nv_bfloat16>(tpr, logits, lab, lo, ls, rows, V, conf,
                                  low, smoothing, s);
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
