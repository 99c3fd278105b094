// Decode attention against the gathered paged KV cache: the port of the TPU
// kernels simple_tensorflow_tpu/ops/pallas/decode_attention.py:_decode_kernel
// (:57, one query per sequence) and _decode_block_kernel (:108, a Kq-query
// block with causal_offset, the page-block prefill shape).
//
// What it computes, per (batch b, head h): for each query j < kq,
//   s[l] = (q_j . k_l) * sm_scale (+ bias[b, l]),
//   s[l] = NEG_INF where l >= length[b] (+ j + 1 with causal_offset),
//   out_j = sum_l softmax(s)[l] v_l, with the sum l guarded to 1 when 0, so
//   a query with no live position returns zeros.
// Scores, the running max/sum and the accumulator stay f32 for f32 and bf16
// inputs alike (the composed reference decode_attention_xla's arithmetic;
// the TPU kernel additionally rounded p to bf16 before P.V).
//
// What bounds it on the card: bytes. Each cache row (D values of K and of V)
// is read once per (b, h) and takes 4 * kq * D flops; at kq <= 16 that is
// below the ridge. The TPU walked the kv axis as a sequential grid
// dimension with (m, l, acc) in VMEM; CUDA blocks run in no order.
//
// kq == 1 (decode_attention_kernel): one block of 128 threads owns one
// (b, h) and walks the kv positions in a loop of 64-row tiles up to the
// row's length. Each tile is staged in shared memory as f32 (K rows padded
// to D + 1 floats so the per-thread dot products are bank-conflict free),
// scored, folded into the online softmax, and accumulated into a shared f32
// accumulator. Rows past L are zero filled and masked, so any L and D <= 256
// work.
//
// kq > 1 (the query block), split-K flash-decoding: at the prefill shape
// (B <= 4, 16 heads) one block per (b, h) left 16-64 of the 132 SMs busy,
// each walking L serially. Here the L axis is split across blocks:
// decode_block_split_kernel, grid (cdiv(L, kSplitL), B*H), scores one
// chunk of kSplitL = 32 positions for all kq queries and writes the
// chunk's partial (m_c, l_c, acc_c) per query to an f32 workspace that the
// wrapper allocates; chunks wholly past the block's horizon (length + kq
// with causal_offset) exit at once and are never read. K and V rows are
// staged with 16-byte loads (a head's D values are contiguous); lane l of
// every warp scores position l of the chunk for the warp's queries with
// float4 dot products, the softmax max and sum are warp reductions, and
// the block takes two barriers a chunk. decode_block_combine_kernel merges
// the partials of each (b, h, j): m = max m_c, w_c = exp(m_c - m),
// l = sum w_c l_c, acc = sum w_c acc_c, out = acc / (l == 0 ? 1 : l).
// The finite NEG_INF: a chunk wholly masked for query j (but live for a
// later query of the block) would otherwise give m_c = NEG_INF and p =
// exp(0) = 1 at every masked position, which only a real m elsewhere
// zeroes; a length == 0 row (no causal_offset) has none. So the split
// kernel sets p = 0 at every masked position: such a chunk writes l_c = 0,
// acc_c = 0, m_c = NEG_INF, and a row with no live position returns zeros.
// Tensor-core products and reading the page table directly instead of a
// gathered view are later work.
#include "common.cuh"

namespace stf {
namespace {

constexpr int kDaThreads = 128;
constexpr int kDaWarps = kDaThreads / 32;

constexpr int kDaTile = 64;  // kv rows a tile of the kq == 1 kernel

template <int KQ>
__host__ __device__ inline size_t da_smem_floats(int d) {
  constexpr int BL = kDaTile;
  // q (KQ, D) | k (BL, D+1) | v (BL, D) | s/p (KQ, BL) | acc (KQ, D) | m, l,
  // alpha (KQ each)
  return static_cast<size_t>(KQ) * d + static_cast<size_t>(BL) * (d + 1) +
         static_cast<size_t>(BL) * d + static_cast<size_t>(KQ) * BL +
         static_cast<size_t>(KQ) * d + 3 * KQ;
}

template <typename T, int KQ>
__global__ void __launch_bounds__(kDaThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            const float* __restrict__ bias,
                            T* __restrict__ out, int kq, int L, int H, int D,
                            float scale, int causal) {
  constexpr int BL = kDaTile;
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* q_sh = smem;
  float* k_sh = q_sh + KQ * D;
  float* v_sh = k_sh + BL * DP;
  float* s_sh = v_sh + BL * D;
  float* acc_sh = s_sh + KQ * BL;
  float* m_sh = acc_sh + KQ * D;
  float* l_sh = m_sh + KQ;
  float* a_sh = l_sh + KQ;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row = static_cast<long long>(H) * D;  // position stride
  const int length = lengths[b];
  // the furthest position ANY query of this block may read
  const int end = min(length + (causal ? kq : 0), L);

  const T* qb = q + static_cast<long long>(b) * kq * row + h * D;
  const T* kb = k + static_cast<long long>(b) * L * row + h * D;
  const T* vb = v + static_cast<long long>(b) * L * row + h * D;
  const float* bb = bias ? bias + static_cast<long long>(b) * L : nullptr;

  for (int i = tid; i < kq * D; i += kDaThreads) {
    const int j = i / D, d = i - j * D;
    q_sh[i] = to_f32(qb[j * row + d]);
    acc_sh[i] = 0.0f;
  }
  for (int j = tid; j < kq; j += kDaThreads) {
    m_sh[j] = kNegInf;
    l_sh[j] = 0.0f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < end; t0 += BL) {
    const int nl = min(BL, L - t0);
    for (int i = tid; i < BL * D; i += kDaThreads) {
      const int l = i / D, d = i - l * D;
      float kv = 0.0f, vv = 0.0f;
      if (l < nl) {
        const long long off = (t0 + l) * row + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      k_sh[l * DP + d] = kv;
      v_sh[l * D + d] = vv;
    }
    __syncthreads();

    // scores: lanes of a warp take consecutive positions of one query
    for (int i = tid; i < kq * BL; i += kDaThreads) {
      const int j = i / BL, l = i - j * BL;
      const int pos = t0 + l;
      const int allowed = length + (causal ? j + 1 : 0);
      float s = kNegInf;
      if (l < nl) {
        const float* qj = q_sh + j * D;
        const float* kl = k_sh + l * DP;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot += qj[d] * kl[d];
        s = dot * scale;
        if (bb != nullptr) s += bb[pos];  // bias before the mask
        if (pos >= allowed) s = kNegInf;
      }
      s_sh[j * BL + l] = s;
    }
    __syncthreads();

    // online softmax: one warp per query
    for (int j = warp; j < kq; j += kDaWarps) {
      float* sj = s_sh + j * BL;
      float mx = kNegInf;
      for (int l = lane; l < BL; l += 32) mx = fmaxf(mx, sj[l]);
      mx = warp_max(mx);
      const float m_prev = m_sh[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int l = lane; l < BL; l += 32) {
        const float p = expf(sj[l] - m_new);
        sj[l] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_sh[j] = alpha;
        l_sh[j] = alpha * l_sh[j] + sum;
        m_sh[j] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    for (int i = tid; i < kq * D; i += kDaThreads) {
      const int j = i / D, d = i - j * D;
      const float* pj = s_sh + j * BL;
      float a = acc_sh[i] * a_sh[j];
      for (int l = 0; l < nl; ++l) a += pj[l] * v_sh[l * D + d];
      acc_sh[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + static_cast<long long>(b) * kq * row + h * D;
  for (int i = tid; i < kq * D; i += kDaThreads) {
    const int j = i / D, d = i - j * D;
    const float lj = l_sh[j];
    ob[j * row + d] = from_f32<T>(acc_sh[i] / (lj == 0.0f ? 1.0f : lj));
  }
}

template <typename T, int KQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const float* bias, void* out, int B,
                   int kq, int L, int H, int D, float scale, int causal,
                   cudaStream_t s) {
  const size_t smem = da_smem_floats<KQ>(D) * sizeof(float);
  auto kernel = decode_attention_kernel<T, KQ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * H, kDaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, bias, static_cast<T*>(out), kq, L,
      H, D, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kq > 1: split-K over the kv axis, then a merge of the partials
// ---------------------------------------------------------------------------

constexpr int kSplitL = 32;  // kv positions a block (one a lane)
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kCombineThreads = 64;

// 4 consecutive elements as f32: 16 bytes of f32, 8 of bf16
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// Rows [0, rows) of a (rows, D) slice with row stride `stride` into f32
// rows of 4 * d4 floats at stride `ds`: zeros past D and at rows >=
// `valid`. `vec` (D % 4 == 0, pointers aligned) takes 4 elements a load.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ds, const T* src,
                                           long long stride, int rows,
                                           int valid, int D, int d4,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * d4; i += kSplitThreads) {
      const int r = i / d4, c = i - r * d4;
      *reinterpret_cast<float4*>(dst + r * ds + 4 * c) =
          r < valid ? load4(src + r * stride + 4 * c)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    const int w = 4 * d4;
    for (int i = threadIdx.x; i < rows * w; i += kSplitThreads) {
      const int r = i / w, e = i - r * w;
      dst[r * ds + e] =
          r < valid && e < D ? to_f32(src[r * stride + e]) : 0.0f;
    }
  }
}

template <int KQ>
inline size_t split_smem_floats(int d4) {
  // q (KQ, ds) | k (kSplitL, ds) | v (kSplitL, 4 d4) | p (KQ, kSplitL); the
  // 4 floats of padding in ds keep 8 lanes' float4 reads of K rows in 8
  // bank groups
  const size_t ds = 4 * static_cast<size_t>(d4) + 4;
  return KQ * ds + kSplitL * ds + kSplitL * 4 * static_cast<size_t>(d4) +
         KQ * kSplitL;
}

// grid (cdiv(L, kSplitL), B*H): the partial (m_c, l_c, acc_c) of chunk c
// for every query of (b, h). Warp w scores queries w, w + 4, ...; lane l
// position c0 + l. ws_acc is (B*H, chunks, kq, 4 d4), ws_ml (B*H, chunks,
// kq) float2 (m_c, l_c).
template <typename T, int KQ>
__global__ void __launch_bounds__(kSplitThreads)
    decode_block_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ lengths,
                              const float* __restrict__ bias,
                              float* __restrict__ ws_acc,
                              float2* __restrict__ ws_ml, int kq, int L,
                              int H, int D, int d4, float scale, int causal,
                              int vec) {
  constexpr int QW = KQ / kSplitWarps;  // queries a warp
  extern __shared__ float4 smem4[];
  const int ds = 4 * d4 + 4;
  float* q_sh = reinterpret_cast<float*>(smem4);
  float* k_sh = q_sh + KQ * ds;
  float* v_sh = k_sh + kSplitL * ds;
  float* p_sh = v_sh + kSplitL * 4 * d4;

  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int length = lengths[b];
  // the furthest position ANY query of the block may read; chunks past it
  // write nothing and the merge never reads them
  const int horizon = min(length + (causal ? kq : 0), L);
  const int c0 = chunk * kSplitL;
  if (c0 >= horizon) return;

  const long long row = static_cast<long long>(H) * D;  // position stride
  const long long kv0 = (static_cast<long long>(b) * L + c0) * row + h * D;
  stage_rows(q_sh, ds, q + static_cast<long long>(b) * kq * row + h * D, row,
             KQ, kq, D, d4, vec);
  stage_rows(k_sh, ds, k + kv0, row, kSplitL, L - c0, D, d4, vec);
  stage_rows(v_sh, 4 * d4, v + kv0, row, kSplitL, L - c0, D, d4, vec);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = c0 + lane;
  float dot[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) dot[i] = 0.0f;
  const float4* k4 = reinterpret_cast<const float4*>(k_sh + lane * ds);
  for (int c = 0; c < d4; ++c) {
    const float4 kv = k4[c];
#pragma unroll
    for (int i = 0; i < QW; ++i)
      dot[i] = dot4(reinterpret_cast<const float4*>(
                        q_sh + (warp + kSplitWarps * i) * ds)[c],
                    kv, dot[i]);
  }
  const float bv = bias != nullptr && pos < L
                       ? bias[static_cast<long long>(b) * L + pos]
                       : 0.0f;
  const long long base =
      (static_cast<long long>(bh) * gridDim.x + chunk) * kq;
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int j = warp + kSplitWarps * i;
    if (j >= kq) break;  // the same for every lane of the warp
    const bool live = pos < min(length + (causal ? j + 1 : 0), L);
    const float s = live ? dot[i] * scale + bv : kNegInf;  // bias, then mask
    const float m_c = warp_max(s);
    // p = 0 at masked positions: a chunk wholly masked for query j writes
    // l_c = 0 and acc_c = 0 (exp(NEG_INF - NEG_INF) would be 1)
    const float p = live ? expf(s - m_c) : 0.0f;
    const float l_c = warp_sum(p);
    p_sh[j * kSplitL + lane] = p;
    if (lane == 0) ws_ml[base + j] = make_float2(m_c, l_c);
  }
  __syncthreads();

  // acc_c[j] = sum over the chunk's positions of p[j][l] v[l]
  const int nl = min(kSplitL, horizon - c0);
  for (int i = threadIdx.x; i < kq * d4; i += kSplitThreads) {
    const int j = i / d4, c = i - j * d4;
    const float* pj = p_sh + j * kSplitL;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int l = 0; l < nl; ++l)
      axpy4(pj[l], reinterpret_cast<const float4*>(v_sh + l * 4 * d4)[c], a);
    reinterpret_cast<float4*>(ws_acc + (base + j) * 4 * d4)[c] = a;
  }
}

// grid (B*H, kq): out[b, j, h] = sum_c w_c acc_c / (l == 0 ? 1 : l) with
// w_c = exp(m_c - max m_c), l = sum_c w_c l_c over the chunks the split
// kernel wrote (those below the block's horizon)
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_block_combine_kernel(const float* __restrict__ ws_acc,
                                const float2* __restrict__ ws_ml,
                                const int* __restrict__ lengths,
                                T* __restrict__ out, int kq, int L, int H,
                                int D, int d4, int n_chunks, int causal) {
  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int horizon = max(0, min(lengths[b] + (causal ? kq : 0), L));
  const int n_live = cdiv(horizon, kSplitL);
  const long long base = static_cast<long long>(bh) * n_chunks * kq + j;
  float m = kNegInf;
  for (int c = 0; c < n_live; ++c) m = fmaxf(m, ws_ml[base + c * kq].x);
  float l = 0.0f;
  for (int c = 0; c < n_live; ++c) {
    const float2 ml = ws_ml[base + c * kq];
    l += expf(ml.x - m) * ml.y;
  }
  const float denom = l == 0.0f ? 1.0f : l;
  T* ob = out + ((static_cast<long long>(b) * kq + j) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float a = 0.0f;
    for (int c = 0; c < n_live; ++c)
      a += expf(ws_ml[base + c * kq].x - m) *
           ws_acc[(base + c * kq) * 4 * d4 + d];
    ob[d] = from_f32<T>(a / denom);
  }
}

template <typename T, int KQ>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* lengths, const float* bias, void* out,
                         float* ws, int B, int kq, int L, int H, int D,
                         float scale, int causal, cudaStream_t s) {
  const int d4 = cdiv(D, 4);
  const int n_chunks = cdiv(L, kSplitL);
  const int BH = B * H;
  if (BH > 65535) return cudaErrorInvalidValue;  // grid.y
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(
      ws + static_cast<size_t>(BH) * n_chunks * kq * 4 * d4);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = D % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % align == 0;
  const size_t smem = split_smem_floats<KQ>(d4) * sizeof(float);
  auto kernel = decode_block_split_kernel<T, KQ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(n_chunks, BH), kSplitThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, bias, ws_acc, ws_ml, kq, L, H, D,
      d4, scale, causal, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_block_combine_kernel<T><<<dim3(BH, kq), kCombineThreads, 0, s>>>(
      ws_acc, ws_ml, lengths, static_cast<T*>(out), kq, L, H, D, d4,
      n_chunks, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, const float* bias, void* out,
                     float* ws, int B, int kq, int L, int H, int D,
                     float scale, int causal, cudaStream_t s) {
  if (kq == 1)
    return launch<T, 1>(q, k, v, lengths, bias, out, B, kq, L, H, D, scale,
                        causal, s);
  if (ws == nullptr) return cudaErrorInvalidValue;
  if (kq <= 4)
    return launch_split<T, 4>(q, k, v, lengths, bias, out, ws, B, kq, L, H,
                              D, scale, causal, s);
  if (kq <= 16)
    return launch_split<T, 16>(q, k, v, lengths, bias, out, ws, B, kq, L, H,
                               D, scale, causal, s);
  if (kq <= 64)
    return launch_split<T, 64>(q, k, v, lengths, bias, out, ws, B, kq, L, H,
                               D, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace stf

// q (B, kq, H, D), k/v (B, L, H, D), out like q, all contiguous; lengths
// (B,) int32; bias (B, L) f32 or null. kq <= 64, D <= 256. For kq > 1,
// workspace holds B * H * cdiv(L, split_l) * kq * (4 * cdiv(D, 4) + 2) f32
// and split_l must be the kernel's kSplitL (the wrapper's SPLIT_L).
extern "C" int stf_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    const void* bias, void* out,
                                    void* workspace, int B, int kq, int L,
                                    int H, int D, float scale, int causal,
                                    int split_l, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (D <= 0 || D > 256 || L <= 0) return cudaErrorInvalidValue;
  if (kq > 1 && split_l != kSplitL) return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  const float* bi = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(workspace);
  if (dtype == kF32)
    return dispatch<float>(q, k, v, len, bi, out, ws, B, kq, L, H, D, scale,
                           causal, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, len, bi, out, ws, B, kq, L, H, D,
                                   scale, causal, s);
  return cudaErrorInvalidValue;
}
