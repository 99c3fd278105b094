// NumericSummary over many tensors in one launch: the device half of the
// numerics-health plane (simple_tensorflow_tpu_torch/debug/numerics.py).
//
// It replaces no Pallas kernel: the JAX package lowers NumericSummary
// (simple_tensorflow_tpu/ops/numerics.py:23 _numeric_summary_pure) to jnp
// ops that XLA fuses into the step. Done in plain PyTorch each tap costs
// about six launches (isfinite, where, abs-max, sum of squares, zero
// count, stack): with up to 64 taps some 400 nodes in every captured step.
// This kernel summarizes every tap of a step in one launch.
//
// What it computes, per tap t (n elements, each read as f32):
//   out[t] = [nonfinite count, max |x| over the finite elements,
//             sqrt(sum of x^2 over the finite elements),
//             (zeros among the finite elements) / n]
// nonfinites are masked out of the magnitude stats, as in JAX, so the
// summary itself stays finite; a tap of no elements gives zeros. The two
// counts are integers (64-bit), the sum of squares f32 (__fmul_rn and
// __fadd_rn: no contraction), the zero fraction a double quotient
// rounded to f32.
//
// Determinism: no float atomics. The taps' descriptors (pointer, length,
// dtype, first block) travel by value in the kernel's parameters (a
// captured step's addresses are static, so a CUDA graph replays them as
// they are). Tap t owns a fixed run of blocks, each a grid-stride loop in
// a fixed order and a fixed shared-memory tree; each block writes its
// partial, fences, and counts itself done on an integer counter. The block
// that finds itself last reduces the tap's partials in index order, again
// by a fixed tree, writes the row and resets the counter for the next
// launch. The result is the same bits at every run, captured or eager.
// The counters live in one per-device buffer (zeroed once): two launches
// may not run at once on two streams.
//
// What bounds it on the card: bytes. It reads every tapped element once
// (2 bytes for bf16 and f16, 4 for f32) for about 6 operations and writes
// 16 bytes a tap. The design: blocks in proportion to a tap's length (one
// per 8192 elements, at most 1024), 256 threads, scalar coalesced loads.
// Wider loads are later work.
#include <cuda_fp16.h>

#include "common.cuh"

namespace stf {
namespace {

constexpr int kSummaryThreads = 256;
constexpr int kMaxSummaryTaps = 128;  // descriptors in the parameter space

enum SummaryDType : int { kSumF32 = 0, kSumBF16 = 1, kSumF16 = 2 };

struct SummaryTaps {
  const void* ptr[kMaxSummaryTaps];
  long long n[kMaxSummaryTaps];
  int dtype[kMaxSummaryTaps];
  int first_block[kMaxSummaryTaps + 1];  // tap t owns [first[t], first[t+1])
  int count;
};

struct SummaryPartial {
  unsigned long long nonfinite;
  unsigned long long zeros;
  float max_abs;
  float sum_sq;
};

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  if (dtype == kSumBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  if (dtype == kSumF16) {
    return __half2float(static_cast<const __half*>(p)[i]);
  }
  return static_cast<const float*>(p)[i];
}

// the block's four statistics reduced by one fixed tree; thread 0 holds
// the result
__device__ __forceinline__ void block_reduce(unsigned long long& nf,
                                             unsigned long long& zr,
                                             float& mx, float& ss) {
  __shared__ unsigned long long s_nf[kSummaryThreads];
  __shared__ unsigned long long s_zr[kSummaryThreads];
  __shared__ float s_mx[kSummaryThreads];
  __shared__ float s_ss[kSummaryThreads];
  const int tid = threadIdx.x;
  s_nf[tid] = nf, s_zr[tid] = zr, s_mx[tid] = mx, s_ss[tid] = ss;
  __syncthreads();
  for (int off = kSummaryThreads / 2; off > 0; off >>= 1) {
    if (tid < off) {
      s_nf[tid] += s_nf[tid + off];
      s_zr[tid] += s_zr[tid + off];
      s_mx[tid] = fmaxf(s_mx[tid], s_mx[tid + off]);
      s_ss[tid] = __fadd_rn(s_ss[tid], s_ss[tid + off]);
    }
    __syncthreads();
  }
  nf = s_nf[0], zr = s_zr[0], mx = s_mx[0], ss = s_ss[0];
  __syncthreads();  // the arrays are reused by a second reduction
}

__global__ void __launch_bounds__(kSummaryThreads)
    numeric_summary_kernel(const SummaryTaps taps, float* __restrict__ out,
                           SummaryPartial* __restrict__ partials,
                           unsigned int* __restrict__ done) {
  __shared__ int s_tap;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int block = blockIdx.x;
  if (tid == 0) {
    int t = 0;
    while (t + 1 < taps.count && taps.first_block[t + 1] <= block) ++t;
    s_tap = t;
  }
  __syncthreads();
  const int t = s_tap;
  const int first = taps.first_block[t];
  const int nblocks = taps.first_block[t + 1] - first;
  const int b = block - first;
  const long long n = taps.n[t];
  const void* p = taps.ptr[t];
  const int dtype = taps.dtype[t];

  unsigned long long nf = 0, zr = 0;
  float mx = 0.0f, ss = 0.0f;
  const long long stride = static_cast<long long>(nblocks) * kSummaryThreads;
  for (long long i = static_cast<long long>(b) * kSummaryThreads + tid;
       i < n; i += stride) {
    const float x = load_f32(p, dtype, i);
    if (isfinite(x)) {
      const float a = fabsf(x);
      mx = fmaxf(mx, a);
      ss = __fadd_rn(ss, __fmul_rn(a, a));
      zr += (x == 0.0f);
    } else {
      ++nf;
    }
  }
  block_reduce(nf, zr, mx, ss);
  if (tid == 0) {
    partials[block] = SummaryPartial{nf, zr, mx, ss};
    __threadfence();
    const unsigned int prev = atomicAdd(&done[t], 1u);
    s_last = prev == static_cast<unsigned int>(nblocks - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the tap's last block: its partials in index order, then the tree
  __threadfence();
  nf = 0, zr = 0, mx = 0.0f, ss = 0.0f;
  for (int j = tid; j < nblocks; j += kSummaryThreads) {
    const SummaryPartial* q = partials + first + j;
    nf += __ldcg(&q->nonfinite);
    zr += __ldcg(&q->zeros);
    mx = fmaxf(mx, __ldcg(&q->max_abs));
    ss = __fadd_rn(ss, __ldcg(&q->sum_sq));
  }
  block_reduce(nf, zr, mx, ss);
  if (tid == 0) {
    float* row = out + 4 * static_cast<long long>(t);
    row[0] = static_cast<float>(nf);
    row[1] = mx;
    row[2] = __fsqrt_rn(ss);
    row[3] = n > 0 ? static_cast<float>(static_cast<double>(zr) /
                                        static_cast<double>(n))
                   : 0.0f;
    done[t] = 0u;  // ready for the next launch
  }
}

}  // namespace
}  // namespace stf

// taps: ptrs, lengths, dtype codes (0 f32, 1 bf16, 2 f16) and blocks of
// `count` tensors (count <= 128); out: (count, 4) f32; partials: one
// 24-byte record per block; done: `count` zeroed uint32 counters.
extern "C" int stf_numeric_summary(const unsigned long long* ptrs,
                                   const long long* lengths,
                                   const int* dtypes, const int* blocks,
                                   int count, float* out, void* partials,
                                   unsigned int* done, void* stream) {
  using namespace stf;
  if (count < 1 || count > kMaxSummaryTaps) return cudaErrorInvalidValue;
  SummaryTaps taps;
  int total = 0;
  for (int t = 0; t < count; ++t) {
    taps.ptr[t] = reinterpret_cast<const void*>(ptrs[t]);
    taps.n[t] = lengths[t];
    taps.dtype[t] = dtypes[t];
    taps.first_block[t] = total;
    total += blocks[t];
  }
  taps.first_block[count] = total;
  taps.count = count;
  numeric_summary_kernel<<<total, kSummaryThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      taps, out, static_cast<SummaryPartial*>(partials), done);
  return static_cast<int>(cudaGetLastError());
}
