// Fused optimizer updates over one flat parameter group: Adam, the port of
// the TPU kernel simple_tensorflow_tpu/ops/pallas/fused_update.py:
// _adam_kernel (:59, called at :96), and Momentum (or Nesterov), the port of
// _momentum_kernel (:135, called at :159).
//
// Adam.
// What it computes, elementwise in the update dtype (f32), in the order of
// _adam_kernel:
//   new_m = b1 * m + (1 - b1) * g
//   new_v = b2 * v + (1 - b2) * g^2
//   upd   = alpha * new_m / (sqrt(new_v) + eps)
//   p     = p - upd cast to p's dtype   (bf16: rounded, then subtracted)
// with g widened from the gradient's dtype (the parameter's), b1, b2, eps
// the f32 roundings of the Python floats and 1 - b1, 1 - b2 formed in f32,
// as jnp.asarray(beta1, ud) and (1 - b1) do. alpha = lr * sqrt(1 - b2^t) /
// (1 - b1^t) is a device scalar the caller computes on the stream (no host
// round trip). Every step is an IEEE-rounded f32 operation (__fmul_rn and
// friends: no fused multiply-add), so the kernel matches its plain PyTorch
// version bit for bit.
//
// It updates p, m and v IN PLACE (the JAX kernel returns new arrays): the
// port's optimizer keeps each group's parameters as views into one flat
// buffer, so no concatenate or split runs around it.
//
// What bounds it on the card: bytes. Per element it reads p, g, m, v and
// writes p, m, v (22 bytes for a bf16 parameter, 28 for f32) for about a
// dozen flops. The design: a grid-stride loop of 256-thread blocks, one
// element per thread per step, coalesced. Vectorised loads are later work.
//
// Momentum, elementwise in the update dtype (f32), in _momentum_kernel's
// order:
//   new_acc = mu * acc + g
//   upd     = lr * (g + mu * new_acc)   (Nesterov)
//   upd     = lr * new_acc              (otherwise)
//   p       = p - upd cast to p's dtype
// with g widened from the parameter dtype and lr, mu f32 device scalars.
// Every step is one IEEE-rounded f32 operation, as in Adam, so the kernel
// matches its plain PyTorch version bit for bit; p and acc are updated in
// place. Bytes bound it: per element it reads p, g, acc and writes p, acc
// (14 bytes for a bf16 parameter, 20 for f32) for 3-5 flops. The same
// grid-stride loop of 256-thread blocks as Adam; Nesterov is a template
// parameter, so neither variant carries a branch in its loop.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kUpdateThreads = 256;

template <typename P>
__global__ void __launch_bounds__(kUpdateThreads)
    adam_kernel(P* __restrict__ p, float* __restrict__ m,
                float* __restrict__ v, const P* __restrict__ g,
                const float* __restrict__ alpha_ptr, long long n, float b1,
                float b2, float eps) {
  const float omb1 = __fsub_rn(1.0f, b1);
  const float omb2 = __fsub_rn(1.0f, b2);
  const float alpha = *alpha_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = to_f32(g[i]);
    const float nm = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gi));
    const float nv = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(omb2, __fmul_rn(gi, gi)));
    const float upd = __fdiv_rn(__fmul_rn(alpha, nm),
                                __fadd_rn(__fsqrt_rn(nv), eps));
    p[i] = from_f32<P>(__fsub_rn(to_f32(p[i]), to_f32(from_f32<P>(upd))));
    m[i] = nm;
    v[i] = nv;
  }
}

template <typename P, bool kNesterov>
__global__ void __launch_bounds__(kUpdateThreads)
    momentum_kernel(P* __restrict__ p, float* __restrict__ acc,
                    const P* __restrict__ g, const float* __restrict__ lr_ptr,
                    const float* __restrict__ mu_ptr, long long n) {
  const float lr = *lr_ptr;
  const float mu = *mu_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = to_f32(g[i]);
    const float na = __fadd_rn(__fmul_rn(mu, acc[i]), gi);
    const float upd = kNesterov
                          ? __fmul_rn(lr, __fadd_rn(gi, __fmul_rn(mu, na)))
                          : __fmul_rn(lr, na);
    p[i] = from_f32<P>(__fsub_rn(to_f32(p[i]), to_f32(from_f32<P>(upd))));
    acc[i] = na;
  }
}

int grid_blocks(long long n) {
  const long long want = (n + kUpdateThreads - 1) / kUpdateThreads;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

template <typename P>
void launch_momentum(P* p, float* acc, const P* g, const float* lr,
                     const float* mu, long long n, bool nesterov,
                     cudaStream_t s) {
  if (nesterov) {
    momentum_kernel<P, true><<<grid_blocks(n), kUpdateThreads, 0, s>>>(
        p, acc, g, lr, mu, n);
  } else {
    momentum_kernel<P, false><<<grid_blocks(n), kUpdateThreads, 0, s>>>(
        p, acc, g, lr, mu, n);
  }
}

}  // namespace
}  // namespace stf

// p, g (n,) in the parameter dtype; m, v (n,) f32; alpha a device f32
// scalar. Updates p, m, v in place.
extern "C" int stf_adam_update(void* p, void* m, void* v, const void* g,
                               const void* alpha, long long n, float beta1,
                               float beta2, float eps, int dtype,
                               void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const int blocks = grid_blocks(n);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const float* a = static_cast<const float*>(alpha);
  if (dtype == kF32) {
    adam_kernel<float><<<blocks, kUpdateThreads, 0, s>>>(
        static_cast<float*>(p), mm, vv, static_cast<const float*>(g), a, n,
        beta1, beta2, eps);
  } else if (dtype == kBF16) {
    adam_kernel<__nv_bfloat16><<<blocks, kUpdateThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), mm, vv,
        static_cast<const __nv_bfloat16*>(g), a, n, beta1, beta2, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// p, g (n,) in the parameter dtype; acc (n,) f32; lr, mu device f32
// scalars. Updates p and acc in place.
extern "C" int stf_momentum_update(void* p, void* acc, const void* g,
                                   const void* lr, const void* mu,
                                   long long n, int use_nesterov, int dtype,
                                   void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  float* a = static_cast<float*>(acc);
  const float* l = static_cast<const float*>(lr);
  const float* m = static_cast<const float*>(mu);
  if (dtype == kF32) {
    launch_momentum(static_cast<float*>(p), a, static_cast<const float*>(g),
                    l, m, n, use_nesterov != 0, s);
  } else if (dtype == kBF16) {
    launch_momentum(static_cast<__nv_bfloat16*>(p), a,
                    static_cast<const __nv_bfloat16*>(g), l, m, n,
                    use_nesterov != 0, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
