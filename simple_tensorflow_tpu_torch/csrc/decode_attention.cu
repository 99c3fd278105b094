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
// dimension with (m, l, acc) in VMEM; CUDA blocks run in no order, and a
// single (b, h) has too few bytes to keep a block busy for long.
//
// kq == 1 (decode_one_kernel), in-block split-K flash-decoding. The serving
// decode step's kernel: one query per (b, h), so each K/V byte takes two
// flops and only the number of bytes in flight, and the latency of walking
// L, set the time. A block of 8 warps owns one (b, h) and a slice of L:
//   - A group of G lanes scores one position: its row of D values is
//     C = D * elem / 16 chunks of 16 bytes, lane i of the group loads
//     chunks i (and i + 32 past 32 chunks) of K and V with one 16-byte
//     load each, neighbouring lanes on neighbouring bytes; G is the
//     smallest of 4, 8, 16, 32 that covers C (f32 D = 64: 16 lanes, two
//     positions a warp). The lane's q chunk lives in registers; the dot
//     product is the lane's chunk and a shuffle reduction over the group.
//   - Group g of the block's NG takes positions t0 + u NG + g, U = 4 of
//     them at once: their K, V and bias loads are all issued before the
//     first is used (8 warps x 4 positions x 2 rows of D values in flight
//     a block), then one max, one rescale and U exps update the group's
//     (m, l, acc) in registers. Positions past the row's end take p = 0.
//   - The NG partials merge once, in shared memory behind one barrier:
//     m = max m_g, w_g = exp(m_g - m), l = sum w_g l_g, acc = sum w_g acc_g.
//   - Across blocks only where B * H blocks leave SMs idle (B = 1 and 4 at
//     16 heads): the wrapper's one_split_len cuts L into splits of a
//     multiple of 64 positions, grid (B*H, splits); each block writes its
//     merged partial to the f32 workspace and decode_block_combine_kernel
//     merges them. Splits wholly past the row's end exit and are never read.
// Rows that are not whole 16-byte chunks (D % (16 / elem) != 0) or
// misaligned pointers load element by element into the same chunks. p = 0
// at masked positions (not exp(NEG_INF - m)), so a row with no live
// position writes l = 0, acc = 0 and returns zeros, as the split note
// below explains for the query block.
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

// ---------------------------------------------------------------------------
// kq == 1: in-block split-K flash-decoding
// ---------------------------------------------------------------------------

constexpr int kOneWarps = 8;
constexpr int kOneThreads = 32 * kOneWarps;

// Chunk c (16 bytes: 4 f32 or 8 bf16 values, elements c E .. c E + E - 1)
// of a row of D values; zeros past D. VEC: one 16-byte load (D % E == 0,
// the row 16-byte aligned); else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int c,
                                            int D) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(row) + c);
  } else {
    constexpr int E = 16 / sizeof(T);
    uint4 r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int e = 0; e < E; ++e)
      t[e] = c * E + e < D ? row[c * E + e] : from_f32<T>(0.0f);
    return r;
  }
}

// grid (B*H, n_split); block (b, h, split) walks positions [split * split_l,
// +split_l) up to the row's end. A group of G lanes (16 bytes a lane, NC
// chunks a lane) scores one position: 32 / G groups a warp, NG a block.
// Group g takes positions t0 + u NG + g, U at a time with their K and V
// loads in flight together, and keeps its own (m, l, acc) in registers;
// the NG partials merge once in shared memory. One split: the block writes
// out; several: its partial (m, l, acc) goes to ws for the combine kernel.
template <typename T, int G, int NC, bool VEC>
__global__ void __launch_bounds__(kOneThreads)
    decode_one_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ lengths,
                      const float* __restrict__ bias, T* __restrict__ out,
                      float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                      int L, int H, int D, int split_l, float scale,
                      int causal) {
  constexpr int E = 16 / sizeof(T);    // values a chunk
  constexpr int P = 32 / G;            // groups a warp
  constexpr int NG = kOneWarps * P;    // groups a block
  constexpr int W = G * NC * E;        // row values a group covers (>= D)
  constexpr int U = 4 / NC;            // positions a group has in flight
  __shared__ float sh_acc[NG][W];
  __shared__ float sh_m[NG], sh_l[NG];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  // live positions [0, end): p = 0 past it, and a row with none is zeros
  const int end = max(0, min(lengths[b] + (causal ? 1 : 0), L));
  const int l0 = split * split_l;
  const int l1 = min(l0 + split_l, end);
  if (gridDim.y > 1 && l0 >= end) return;  // the merge never reads it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % G;                 // lane within its group
  const int grp = warp * P + lane / G;
  const int C = cdiv(D, E);                // chunks a row
  const long long row = static_cast<long long>(H) * D;  // position stride
  const T* kb = k + static_cast<long long>(b) * L * row + h * D;
  const T* vb = v + static_cast<long long>(b) * L * row + h * D;
  const float* bb = bias != nullptr ? bias + static_cast<long long>(b) * L
                                    : nullptr;

  float qf[NC][E], acc[NC][E];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = gl + G * i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (c < C) raw = load_chunk<T, VEC>(q + b * row + h * D, c, D);
    unpack16(raw, qf[i]);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.0f;
  }
  float m = kNegInf, lsum = 0.0f;

  // the loop bound is the warp's first position of the step: uniform
  for (int t0 = l0; t0 + warp * P < l1; t0 += NG * U) {
    uint4 kr[U][NC], vr[U][NC];
    float bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = t0 + u * NG + grp;
      bv[u] = bb != nullptr && pos < l1 ? __ldg(bb + pos) : 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = gl + G * i;
        kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
        if (pos < l1 && c < C) {
          kr[u][i] = load_chunk<T, VEC>(kb + pos * row, c, D);
          vr[u][i] = load_chunk<T, VEC>(vb + pos * row, c, D);
        }
      }
    }
    float s[U];
    float mt = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        float kf[E];
        unpack16(kr[u][i], kf);
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[i][e], kf[e], dot);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int pos = t0 + u * NG + grp;
      s[u] = kNegInf;
      if (pos < l1) {
        s[u] = dot * scale + bv[u];  // bias, then the mask
        mt = fmaxf(mt, s[u]);
      }
    }
    // a step with no live position keeps mt == m: alpha 1, every p 0
    const float alpha = expf(m - mt);
    lsum *= alpha;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = t0 + u * NG + grp < l1 ? expf(s[u] - mt) : 0.0f;
      lsum += p;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        float vf[E];
        unpack16(vr[u][i], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
      }
    }
    m = mt;
  }

  // merge the block's NG partials: m = max m_g, w_g = exp(m_g - m),
  // l = sum w_g l_g, acc = sum w_g acc_g (a group that saw no live
  // position has l_g = 0 and acc_g = 0)
  if (gl == 0) {
    sh_m[grp] = m;
    sh_l[grp] = lsum;
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) sh_acc[grp][(gl + G * i) * E + e] = acc[i][e];
  __syncthreads();
  float mm = kNegInf;
#pragma unroll
  for (int g = 0; g < NG; ++g) mm = fmaxf(mm, sh_m[g]);
  float l = 0.0f;
#pragma unroll
  for (int g = 0; g < NG; ++g) l += expf(sh_m[g] - mm) * sh_l[g];
  const int n_split = gridDim.y;
  const long long part = static_cast<long long>(bh) * n_split + split;
  for (int d = threadIdx.x; d < D; d += kOneThreads) {
    float a = 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g) a += expf(sh_m[g] - mm) * sh_acc[g][d];
    if (n_split == 1)
      out[b * row + h * D + d] = from_f32<T>(a / (l == 0.0f ? 1.0f : l));
    else
      ws_acc[part * (4 * cdiv(D, 4)) + d] = a;
  }
  if (n_split > 1 && threadIdx.x == 0) ws_ml[part] = make_float2(mm, l);
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
// w_c = exp(m_c - max m_c), l = sum_c w_c l_c over the chunks of chunk_len
// positions the split kernel wrote (those below the block's horizon). It
// also merges the Kq = 1 kernel's splits (kq 1, chunk_len its split_l).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_block_combine_kernel(const float* __restrict__ ws_acc,
                                const float2* __restrict__ ws_ml,
                                const int* __restrict__ lengths,
                                T* __restrict__ out, int kq, int L, int H,
                                int D, int d4, int n_chunks, int chunk_len,
                                int causal) {
  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int horizon = max(0, min(lengths[b] + (causal ? kq : 0), L));
  const int n_live = cdiv(horizon, chunk_len);
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
  // raised once to the largest size asked so far (a process-wide
  // attribute): a call at a shape already seen, such as a CUDA graph's
  // capture after its eager warm-up, makes no attribute call
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<dim3(n_chunks, BH), kSplitThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, bias, ws_acc, ws_ml, kq, L, H, D,
      d4, scale, causal, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_block_combine_kernel<T><<<dim3(BH, kq), kCombineThreads, 0, s>>>(
      ws_acc, ws_ml, lengths, static_cast<T*>(out), kq, L, H, D, d4,
      n_chunks, kSplitL, causal);
  return cudaGetLastError();
}

template <typename T, int G, int NC, bool VEC>
cudaError_t launch_one_kernel(const void* q, const void* k, const void* v,
                              const int* lengths, const float* bias,
                              void* out, float* ws_acc, float2* ws_ml,
                              int BH, int n_split, int L, int H, int D,
                              int split_l, float scale, int causal,
                              cudaStream_t s) {
  decode_one_kernel<T, G, NC, VEC><<<dim3(BH, n_split), kOneThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, bias, static_cast<T*>(out), ws_acc,
      ws_ml, L, H, D, split_l, scale, causal);
  return cudaGetLastError();
}

// kq == 1: cdiv(L, split_l) splits of the cache axis a (b, h); more than
// one writes partials to ws and merges them with the combine kernel.
// Groups of G = 4 ... 32 lanes, the fewest that cover a row's 16-byte
// chunks (two chunks a lane past 32); a row that is not whole 16-byte
// chunks, or a misaligned pointer, loads element by element.
template <typename T>
cudaError_t launch_one(const void* q, const void* k, const void* v,
                       const int* lengths, const float* bias, void* out,
                       float* ws, int B, int L, int H, int D, int split_l,
                       float scale, int causal, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  if (split_l <= 0) return cudaErrorInvalidValue;
  const int n_split = cdiv(L, split_l);
  const int BH = B * H;
  const int d4 = cdiv(D, 4);
  if (n_split > 65535) return cudaErrorInvalidValue;  // grid.y
  if (n_split > 1 && ws == nullptr) return cudaErrorInvalidValue;
  float2* ws_ml = n_split > 1
                      ? reinterpret_cast<float2*>(
                            ws + static_cast<size_t>(BH) * n_split * 4 * d4)
                      : nullptr;
  const int C = cdiv(D, E);
  const bool vec = D % E == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  cudaError_t e;
  if (!vec)
    e = launch_one_kernel<T, 32, 2, false>(q, k, v, lengths, bias, out, ws,
                                           ws_ml, BH, n_split, L, H, D,
                                           split_l, scale, causal, s);
  else if (C <= 4)
    e = launch_one_kernel<T, 4, 1, true>(q, k, v, lengths, bias, out, ws,
                                         ws_ml, BH, n_split, L, H, D, split_l,
                                         scale, causal, s);
  else if (C <= 8)
    e = launch_one_kernel<T, 8, 1, true>(q, k, v, lengths, bias, out, ws,
                                         ws_ml, BH, n_split, L, H, D, split_l,
                                         scale, causal, s);
  else if (C <= 16)
    e = launch_one_kernel<T, 16, 1, true>(q, k, v, lengths, bias, out, ws,
                                          ws_ml, BH, n_split, L, H, D,
                                          split_l, scale, causal, s);
  else if (C <= 32)
    e = launch_one_kernel<T, 32, 1, true>(q, k, v, lengths, bias, out, ws,
                                          ws_ml, BH, n_split, L, H, D,
                                          split_l, scale, causal, s);
  else
    e = launch_one_kernel<T, 32, 2, true>(q, k, v, lengths, bias, out, ws,
                                          ws_ml, BH, n_split, L, H, D,
                                          split_l, scale, causal, s);
  if (e != cudaSuccess || n_split == 1) return e;
  decode_block_combine_kernel<T><<<dim3(BH, 1), kCombineThreads, 0, s>>>(
      ws, ws_ml, lengths, static_cast<T*>(out), 1, L, H, D, d4, n_split,
      split_l, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, const float* bias, void* out,
                     float* ws, int B, int kq, int L, int H, int D,
                     int split_l, float scale, int causal, cudaStream_t s) {
  if (kq == 1)
    return launch_one<T>(q, k, v, lengths, bias, out, ws, B, L, H, D, split_l,
                         scale, causal, s);
  if (ws == nullptr || split_l != kSplitL) return cudaErrorInvalidValue;
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
// (B,) int32; bias (B, L) f32 or null. kq <= 64, D <= 256. split_l: for
// kq > 1 the kernel's kSplitL (the wrapper's SPLIT_L); for kq == 1 the
// positions a block walks (the wrapper's one_split_len). workspace holds
// B * H * cdiv(L, split_l) * kq * (4 * cdiv(D, 4) + 2) f32; null for kq ==
// 1 with split_l >= L.
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
  const int* len = static_cast<const int*>(lengths);
  const float* bi = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(workspace);
  if (dtype == kF32)
    return dispatch<float>(q, k, v, len, bi, out, ws, B, kq, L, H, D,
                           split_l, scale, causal, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, len, bi, out, ws, B, kq, L, H, D,
                                   split_l, scale, causal, s);
  return cudaErrorInvalidValue;
}
