// FlashAttention-2 forward and backward over (B*H, S, D): the port of the TPU
// kernels simple_tensorflow_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (:102, called at :180), _bwd_dkdv_kernel (:210, called at :352) and
// _bwd_dq_kernel (:264, called at :383), with their dropout branch, and the
// C entry points of all flash kernels. bf16 runs on tensor cores: the
// forward in flash_fwd_mma.cu, dK/dV and dQ in flash_bwd_mma.cu. The
// CUDA-core kernels here run f32: TF32 tensor cores would fail the f32
// training check's limits (1e-5 on the loss, 1e-4 on the gradients).
//
// What they compute, per head bh (bias row b = bh / H):
//   s = (q . k) * sm_scale (+ bias[b, key]), then NEG_INF where key >= kv_len
//   or (causal) key > query — the bias is added BEFORE the mask;
//   forward: online softmax over k-tiles (m, l, acc), o = acc / l and
//   lse = m + log(l) with l == 0 -> 1;
//   dkdv: p = exp(s - lse), dP = dO . V^T, dV += p^T . dO,
//   dS = p * (dP - delta) * sm_scale, dK += dS^T . Q;
//   dq: the same p and dS, dQ += dS . K.
// Dropout (rate > 0), in the TPU kernels' order: keep = K0 (common.cuh
// counter_keep) of (seed, salt = bh, GLOBAL query row, GLOBAL key column),
// so the 64 x 64 tiles here draw the mask the TPU's 128 x 128 blocks draw,
// and the backward regenerates it; inv = f32(1 / keep_prob).
//   forward: l sums the UNDROPPED p; only the p stored for P.V is
//   keep ? p * inv : 0;
//   backward: dV takes keep ? p * inv : 0, dP becomes keep ? dP * inv : 0,
//   and dS = p_undropped * (dP - delta) * scale, delta = rowsum(dO . O) of
//   the dropped O.
// All sums are f32 (the TPU's preferred_element_type=f32 /
// Precision.HIGHEST).
//
// What bounds them on the card: operations. At the training shape (S=256,
// D=64, causal) a head's Q, K, V are 192 KB in f32 and take 8.6 MFLOP in
// the forward: ~45 flops a byte, above the ~20 of f32 CUDA cores. The
// TPU walked k-blocks as a sequential grid axis with (m, l, acc) in VMEM;
// CUDA blocks run in no order, so here the sequential axis is a loop in
// the block:
//   forward and dq: one block per (bh, 64-query tile) loops over 64-key
//   tiles up to the causal diagonal (the TPU's `live` predicate);
//   dkdv: one block per (bh, 64-key tile) loops over query tiles from the
//   diagonal down.
// No atomics: each output tile has one owner, so the gradients are
// deterministic. Tiles sit in shared memory as f32 with rows padded to an
// odd stride (bank-conflict free); each of the 256 threads owns a 4 x 4
// patch of the 64 x 64 score tile and a 4 x (D/16) patch of the output
// tile. Ragged S is masked in the kernel (rows past S load zeros and are
// never stored), so nothing is padded in device memory.
#include "common.cuh"

namespace stf {

// flash_fwd_mma.cu: the bf16 forward on tensor cores
cudaError_t flash_fwd_bf16_mma(const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int BH,
                               int q_len, int kv_len, int H, int D,
                               float scale, int causal, int dropout,
                               uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                               float inv_keep, cudaStream_t s);

// flash_bwd_mma.cu: the bf16 dK/dV (dkdv != 0) or dQ on tensor cores
cudaError_t flash_bwd_bf16_mma(int dkdv, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               const float* bias, void* dq, void* dk,
                               void* dv, int BH, int q_len, int kv_len, int H,
                               int D, float scale, int causal, int dropout,
                               uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                               float inv_keep, cudaStream_t s);

namespace {

constexpr int kFaThreads = 256;
constexpr int kBq = 64;  // query rows per tile
constexpr int kBk = 64;  // key rows per tile
constexpr int kPs = kBk + 1;  // padded stride of a (query, key) tile

// Stage rows [row0, row0 + 64) of a (rows, D) slice with stride DP; rows
// past `limit` are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int limit) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kBq * D; i += kFaThreads) {
    const int r = i / D, d = i - r * D;
    const int g = row0 + r;
    dst[r * DP + d] =
        g < limit ? src[static_cast<long long>(g) * D + d] : 0.0f;
  }
}

// acc[i][j] += a_row(ty*4+i) . b_row(tx+16j) over D: the 4 x 4 patch of a
// 64 x 64 product of two staged (64, D) tiles.
template <int D>
__device__ __forceinline__ void patch_dot(float (&acc)[4][4], const float* a,
                                          const float* b, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// The masked, scaled, biased score of (query qg, key kg).
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* bias, int qg,
                                              int kg, int q_len, int kv_len,
                                              int causal) {
  float s = dot * scale;
  if (bias != nullptr && kg < kv_len) s += bias[kg];
  const bool ok = kg < kv_len && qg < q_len && (!causal || qg >= kg);
  return ok ? s : kNegInf;
}

// sum / max over the 16 threads (tx) that share a row group (ty)
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, B*H)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_floats() {
  return 2 * kBq * (D + 1) + kBk * D + kBq * kPs;  // q, k | v | p
}

template <int D>
__global__ void __launch_bounds__(kFaThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int q_len,
                     int kv_len, int H, float scale, int causal, int dropout,
                     uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold, float inv_keep) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_sh = smem;
  float* k_sh = q_sh + kBq * DP;
  float* v_sh = k_sh + kBk * DP;
  float* p_sh = v_sh + kBk * D;

  const int qi = blockIdx.x, bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kBq;
  const float* qb = q + static_cast<long long>(bh) * q_len * D;
  const float* kb = k + static_cast<long long>(bh) * kv_len * D;
  const float* vb = v + static_cast<long long>(bh) * kv_len * D;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  const uint32_t h0 = dropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
  stage<D>(q_sh, qb, q0, q_len);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int n_kb = cdiv(kv_len, kBk);
  if (causal) n_kb = min(n_kb, cdiv(q0 + kBq, kBk));  // the `live` tiles
  for (int kt = 0; kt < n_kb; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's k, v, p are consumed
    stage<D>(k_sh, kb, k0, kv_len);
    for (int i = threadIdx.x; i < kBk * D; i += kFaThreads) {
      const int r = i / D, d = i - r * D;
      v_sh[i] = k0 + r < kv_len
                    ? vb[static_cast<long long>(k0 + r) * D + d]
                    : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {};
    patch_dot<D>(s, q_sh, k_sh, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], scale, bb, qg, k0 + tx + 16 * j,
                               q_len, kv_len, causal);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        const int c = tx + 16 * j;
        float pv = p;
        if (dropout)
          pv = counter_keep(h0, qg, k0 + c, threshold)
                   ? __fmul_rn(p, inv_keep)
                   : 0.0f;
        p_sh[(ty * 4 + i) * kPs + c] = pv;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int nk = min(kBk, kv_len - k0);
    for (int c = 0; c < nk; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_sh[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_sh[(ty * 4 + i) * kPs + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

  float* ob = o + static_cast<long long>(bh) * q_len * D;
  float* lb = lse + static_cast<long long>(bh) * q_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty * 4 + i;
    if (qg >= q_len) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[static_cast<long long>(qg) * D + tx + 16 * j] =
          acc[i][j] / l_safe;
    if (tx == 0) lb[qg] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// shared by both backward kernels: p and dS of one (64 q, 64 k) tile
// ---------------------------------------------------------------------------

// Computes, for the thread's 4 x 4 patch, p = exp(s - lse) and
// dS = p * (dP - delta) * scale, and stores dS into ds_sh and, when p_sh is
// given, p into p_sh. With dropout, dP and the
// stored p are the dropped ones (h0 = keep_hash0(seed, bh)).
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const float* q_sh, const float* k_sh, const float* v_sh,
    const float* do_sh, const float* lse_sh, const float* delta_sh,
    float* p_sh, float* ds_sh, const float* bias, int q0, int k0, int q_len,
    int kv_len, float scale, int causal, int dropout, uint32_t h0,
    uint32_t threshold, float inv_keep, int ty, int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  patch_dot<D>(s, q_sh, k_sh, ty, tx);
  patch_dot<D>(dp, do_sh, v_sh, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float sc = masked_score(s[i][j], scale, bias, q0 + r, k0 + c,
                                    q_len, kv_len, causal);
      const float p = expf(sc - lse_sh[r]);
      float pc = p, dpv = dp[i][j];
      if (dropout) {
        const bool keep = counter_keep(h0, q0 + r, k0 + c, threshold);
        pc = keep ? __fmul_rn(p, inv_keep) : 0.0f;
        dpv = keep ? __fmul_rn(dpv, inv_keep) : 0.0f;
      }
      if (p_sh != nullptr) p_sh[r * kPs + c] = pc;
      ds_sh[r * kPs + c] = p * (dpv - delta_sh[r]) * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: grid (k tiles, B*H)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkdv_smem_floats() {
  return 4 * kBq * (D + 1) + 2 * kBq * kPs + 2 * kBq;
}

template <int D>
__global__ void __launch_bounds__(kFaThreads)
    flash_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int q_len, int kv_len, int H,
                      float scale, int causal, int dropout, uint32_t seed,
                      const uint32_t* seed_ptr, uint32_t threshold, float inv_keep) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* k_sh = smem;
  float* v_sh = k_sh + kBk * DP;
  float* q_sh = v_sh + kBk * DP;
  float* do_sh = q_sh + kBq * DP;
  float* p_sh = do_sh + kBq * DP;
  float* ds_sh = p_sh + kBq * kPs;
  float* lse_sh = ds_sh + kBq * kPs;
  float* delta_sh = lse_sh + kBq;

  const int ki = blockIdx.x, bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = ki * kBk;
  const long long qo = static_cast<long long>(bh) * q_len;
  const long long ko = static_cast<long long>(bh) * kv_len;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  const uint32_t h0 = dropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
  stage<D>(k_sh, k + ko * D, k0, kv_len);
  stage<D>(v_sh, v + ko * D, k0, kv_len);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  const int n_qb = cdiv(q_len, kBq);
  // first query tile with a live (query >= key) pair: the diagonal
  const int qb0 = causal ? k0 / kBq : 0;
  for (int qt = qb0; qt < n_qb; ++qt) {
    const int q0 = qt * kBq;
    __syncthreads();  // the previous tile's q, dO, p, dS are consumed
    stage<D>(q_sh, q + qo * D, q0, q_len);
    stage<D>(do_sh, dout + qo * D, q0, q_len);
    for (int r = threadIdx.x; r < kBq; r += kFaThreads) {
      const bool in = q0 + r < q_len;
      lse_sh[r] = in ? lse[qo + q0 + r] : 0.0f;
      delta_sh[r] = in ? delta[qo + q0 + r] : 0.0f;
    }
    __syncthreads();
    tile_p_ds<D>(q_sh, k_sh, v_sh, do_sh, lse_sh, delta_sh, p_sh, ds_sh,
                    bb, q0, k0, q_len, kv_len, scale, causal, dropout, h0,
                    threshold, inv_keep, ty, tx);
    __syncthreads();

    // dV[c] += sum_r p[r][c] dO[r]; dK[c] += sum_r dS[r][c] Q[r]; the
    // thread owns key rows ty*4+i and columns tx+16j
    const int nq = min(kBq, q_len - q0);
    for (int r = 0; r < nq; ++r) {
      float dov[DJ], qv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = do_sh[r * DP + tx + 16 * j];
        qv[j] = q_sh[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_sh[r * kPs + ty * 4 + i];
        const float ds = ds_sh[r * kPs + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] += p * dov[j];
          dk_acc[i][j] += ds * qv[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kg = k0 + ty * 4 + i;
    if (kg >= kv_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const long long off = (ko + kg) * D + tx + 16 * j;
      dk[off] = dk_acc[i][j];
      dv[off] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (q tiles, B*H)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * kBq * (D + 1) + kBq * kPs + 2 * kBq;
}

template <int D>
__global__ void __launch_bounds__(kFaThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    int q_len, int kv_len, int H, float scale, int causal,
                    int dropout, uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                    float inv_keep) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_sh = smem;
  float* do_sh = q_sh + kBq * DP;
  float* k_sh = do_sh + kBq * DP;
  float* v_sh = k_sh + kBk * DP;
  float* ds_sh = v_sh + kBk * DP;
  float* lse_sh = ds_sh + kBq * kPs;
  float* delta_sh = lse_sh + kBq;

  const int qi = blockIdx.x, bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kBq;
  const long long qo = static_cast<long long>(bh) * q_len;
  const long long ko = static_cast<long long>(bh) * kv_len;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  const uint32_t h0 = dropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
  stage<D>(q_sh, q + qo * D, q0, q_len);
  stage<D>(do_sh, dout + qo * D, q0, q_len);
  for (int r = threadIdx.x; r < kBq; r += kFaThreads) {
    const bool in = q0 + r < q_len;
    lse_sh[r] = in ? lse[qo + q0 + r] : 0.0f;
    delta_sh[r] = in ? delta[qo + q0 + r] : 0.0f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  int n_kb = cdiv(kv_len, kBk);
  if (causal) n_kb = min(n_kb, cdiv(q0 + kBq, kBk));
  for (int kt = 0; kt < n_kb; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's k, v, dS are consumed
    stage<D>(k_sh, k + ko * D, k0, kv_len);
    stage<D>(v_sh, v + ko * D, k0, kv_len);
    __syncthreads();
    tile_p_ds<D>(q_sh, k_sh, v_sh, do_sh, lse_sh, delta_sh, nullptr,
                    ds_sh, bb, q0, k0, q_len, kv_len, scale, causal, dropout,
                    h0, threshold, inv_keep, ty, tx);
    __syncthreads();
    const int nk = min(kBk, kv_len - k0);
    for (int c = 0; c < nk; ++c) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_sh[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_sh[(ty * 4 + i) * kPs + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += ds * kv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty * 4 + i;
    if (qg >= q_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[(qo + qg) * D + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct FaArgs {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  const float* bias;
  void *o, *lse, *dq, *dk, *dv;
  int BH, q_len, kv_len, H;
  float scale;
  int causal;
  int dropout;
  uint32_t seed;
  const uint32_t* seed_ptr;  // null: the launch argument `seed`
  uint32_t threshold;
  float inv_keep;
  cudaStream_t s;
};

template <int D>
cudaError_t run_fwd(const FaArgs& a) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(cdiv(a.q_len, kBq), a.BH), kFaThreads, smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.q_len, a.kv_len, a.H, a.scale, a.causal,
      a.dropout, a.seed, a.seed_ptr, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dkdv(const FaArgs& a) {
  const size_t smem = dkdv_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dkdv_kernel<D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(cdiv(a.kv_len, kBk), a.BH), kFaThreads, smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), a.bias, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.q_len, a.kv_len, a.H, a.scale, a.causal,
      a.dropout, a.seed, a.seed_ptr, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dq(const FaArgs& a) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dq_kernel<D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(cdiv(a.q_len, kBq), a.BH), kFaThreads, smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), a.bias, static_cast<float*>(a.dq),
      a.q_len, a.kv_len, a.H, a.scale, a.causal, a.dropout, a.seed, a.seed_ptr,
      a.threshold, a.inv_keep);
  return cudaGetLastError();
}

enum FaWhich { kFwd = 0, kDkdv = 1, kDq = 2 };

template <int D>
cudaError_t run_f32(int which, const FaArgs& a) {
  if (which == kFwd) return run_fwd<D>(a);
  if (which == kDkdv) return run_dkdv<D>(a);
  return run_dq<D>(a);
}

// bf16 on tensor cores (flash_fwd_mma.cu, flash_bwd_mma.cu: each checks
// D), f32 on the CUDA-core kernels above
int dispatch(int which, int dtype, int D, const FaArgs& a) {
  if (a.BH <= 0 || a.q_len <= 0) return cudaSuccess;
  if (a.kv_len <= 0) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    if (which == kFwd)
      return flash_fwd_bf16_mma(a.q, a.k, a.v, a.bias, a.o,
                                static_cast<float*>(a.lse), a.BH, a.q_len,
                                a.kv_len, a.H, D, a.scale, a.causal,
                                a.dropout, a.seed, a.seed_ptr, a.threshold, a.inv_keep,
                                a.s);
    return flash_bwd_bf16_mma(
        which == kDkdv, a.q, a.k, a.v, a.dout,
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), a.bias, a.dq, a.dk, a.dv, a.BH,
        a.q_len, a.kv_len, a.H, D, a.scale, a.causal, a.dropout, a.seed, a.seed_ptr,
        a.threshold, a.inv_keep, a.s);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return run_f32<16>(which, a);
    case 32: return run_f32<32>(which, a);
    case 64: return run_f32<64>(which, a);
    case 128: return run_f32<128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace stf

// q (BH, q_len, D), k/v (BH, kv_len, D), o like q, lse (BH, q_len) f32;
// bias (B, kv_len) f32 or null with B = BH / H. D in {16, 32, 64, 128}.
// dropout 0/1; seed the int32 seed as uint32; threshold = min(int(keep_prob
// * 2^32), 2^32 - 1); inv_keep = f32(1 / keep_prob).
extern "C" int stf_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int BH, int q_len,
                                       int kv_len, int H, int D, float scale,
                                       int causal, int dropout, unsigned seed,
                                       unsigned threshold, float inv_keep,
                                       int dtype, void* stream) {
  stf::FaArgs a{q, k, v, nullptr, nullptr, nullptr,
                static_cast<const float*>(bias), o, lse, nullptr, nullptr,
                nullptr, BH, q_len, kv_len, H, scale, causal, dropout, seed,
                nullptr, threshold, inv_keep, static_cast<cudaStream_t>(stream)};
  return stf::dispatch(stf::kFwd, dtype, D, a);
}

// dout like q; lse, delta (BH, q_len) f32; dk/dv like k.
extern "C" int stf_flash_attention_dkdv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        const void* bias, void* dk, void* dv,
                                        int BH, int q_len, int kv_len, int H,
                                        int D, float scale, int causal,
                                        int dropout, unsigned seed,
                                        unsigned threshold, float inv_keep,
                                        int dtype, void* stream) {
  stf::FaArgs a{q, k, v, dout, lse, delta, static_cast<const float*>(bias),
                nullptr, nullptr, nullptr, dk, dv, BH, q_len, kv_len, H,
                scale, causal, dropout, seed, nullptr, threshold, inv_keep,
                static_cast<cudaStream_t>(stream)};
  return stf::dispatch(stf::kDkdv, dtype, D, a);
}

// dq like q.
extern "C" int stf_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* bias, void* dq, int BH,
                                      int q_len, int kv_len, int H, int D,
                                      float scale, int causal, int dropout,
                                      unsigned seed, unsigned threshold,
                                      float inv_keep, int dtype,
                                      void* stream) {
  stf::FaArgs a{q, k, v, dout, lse, delta, static_cast<const float*>(bias),
                nullptr, nullptr, dq, nullptr, nullptr, BH, q_len, kv_len, H,
                scale, causal, dropout, seed, nullptr, threshold, inv_keep,
                static_cast<cudaStream_t>(stream)};
  return stf::dispatch(stf::kDq, dtype, D, a);
}

// The three entry points above with dropout on and the seed read through
// `seed` (a device pointer to the int32 seed) when the kernel starts, not
// passed as a launch argument: what a CUDA graph launches, whose replays
// refill the seed buffer. The same kernels; the masks are bit-identical.
extern "C" int stf_flash_attention_fwd_seed_ptr(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int BH, int q_len, int kv_len, int H, int D, float scale,
    int causal, const void* seed, unsigned threshold, float inv_keep,
    int dtype, void* stream) {
  if (seed == nullptr) return cudaErrorInvalidValue;
  stf::FaArgs a{q, k, v, nullptr, nullptr, nullptr,
                static_cast<const float*>(bias), o, lse, nullptr, nullptr,
                nullptr, BH, q_len, kv_len, H, scale, causal, 1, 0u,
                static_cast<const uint32_t*>(seed), threshold, inv_keep,
                static_cast<cudaStream_t>(stream)};
  return stf::dispatch(stf::kFwd, dtype, D, a);
}

extern "C" int stf_flash_attention_dkdv_seed_ptr(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int BH, int q_len, int kv_len, int H, int D, float scale, int causal,
    const void* seed, unsigned threshold, float inv_keep, int dtype,
    void* stream) {
  if (seed == nullptr) return cudaErrorInvalidValue;
  stf::FaArgs a{q, k, v, dout, lse, delta, static_cast<const float*>(bias),
                nullptr, nullptr, nullptr, dk, dv, BH, q_len, kv_len, H,
                scale, causal, 1, 0u, static_cast<const uint32_t*>(seed),
                threshold, inv_keep, static_cast<cudaStream_t>(stream)};
  return stf::dispatch(stf::kDkdv, dtype, D, a);
}

extern "C" int stf_flash_attention_dq_seed_ptr(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dq, int BH,
    int q_len, int kv_len, int H, int D, float scale, int causal,
    const void* seed, unsigned threshold, float inv_keep, int dtype,
    void* stream) {
  if (seed == nullptr) return cudaErrorInvalidValue;
  stf::FaArgs a{q, k, v, dout, lse, delta, static_cast<const float*>(bias),
                nullptr, nullptr, dq, nullptr, nullptr, BH, q_len, kv_len, H,
                scale, causal, 1, 0u, static_cast<const uint32_t*>(seed),
                threshold, inv_keep, static_cast<cudaStream_t>(stream)};
  return stf::dispatch(stf::kDq, dtype, D, a);
}
