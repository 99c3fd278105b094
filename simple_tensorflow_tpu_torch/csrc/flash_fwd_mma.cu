// The bf16 FlashAttention forward on Hopper tensor cores: the port of the TPU
// kernel simple_tensorflow_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (:102, called at :180) for bf16 inputs at D <= 64, dropout branch
// included. flash_attention.cu routes every bf16 forward at D <= 64 here
// (D = 128 runs flash_fwd_sm90.cu's wgmma kernel) and keeps its f32
// CUDA-core kernel for f32 inputs (TF32 would break the f32 training
// check's 1e-5 on the loss).
//
// What it computes is flash_attention.cu's forward, bit for bit in the
// mask and up to the summation order in the sums: s = (q . k) * scale
// (+ bias[b, key]), NEG_INF where key >= kv_len or (causal) key > query,
// an online softmax whose l sums the undropped p, p rounded to bf16 before
// P.V (with dropout keep ? p * inv_keep : 0 first, the mask K0
// counter_keep(keep_hash0(seed, bh), global row, global col)), o = acc /
// l_safe and lse = m + log(l_safe). The TPU kernel runs bf16 x bf16 on the
// MXU with f32 accumulation; a bf16 product is exact in f32, so the tensor
// cores' products with f32 accumulators compute the same function.
//
// What bounds it on the card: at the training shape (256 heads of S=256,
// D=64, causal) the work is 4.3 GFLOP of bf16 products (4.4 us at the dense
// peak) against 33.6 MB of q, k, v, o and lse (10 us at 3.35 TB/s): bytes,
// so the design keeps every intermediate out of device memory and reads
// each input tile once a block:
// - products on tensor cores: mma.sync m16n8k16 bf16 -> f32 (FlashAttention-
//   2's layout). Each of 4 warps owns 16 query rows of the block's 64; Q,
//   K and V fragments come from shared memory through ldmatrix (.trans for
//   V). wgmma + TMA was not
//   taken: a block walks at most 4 key tiles at S=256, too few for the deep
//   asynchronous pipeline that wgmma needs to pay off, and m16n8k16 keeps P
//   in the registers that produced it;
// - scores stay in registers: the online softmax runs on the accumulator
//   fragments, with the row max and sum reduced over the 4 lanes of a quad;
//   P is rounded to bf16 in registers and fed straight back as the A
//   operand of P.V; O accumulates in registers and leaves once, staged
//   through the warp's own Q rows for 16-byte stores;
// - staging: Q, K and V tiles are copied as bf16 with 16-byte cp.async into
//   shared memory swizzled for ldmatrix (16-byte unit u of a 128-byte line
//   at u ^ line), K/V double-buffered so tile t + 1 loads while tile t
//   computes: (1 + 2 + 2) x 64 x D bf16 = 40 KB a block at D = 64;
// - few instructions an element, since the softmax's scalar work, not the
//   tensor cores, sets the pace of a 64 x 64 tile: exp as a subtraction, a
//   multiply and an ex2 on the special-function unit; causal and dropout are template
//   parameters, so the rate-0 kernels carry no dropout code; only the
//   diagonal tile (and a ragged last tile) is masked; the mask is computed
//   per accumulator element from its (row, col) as a tile's 32 keep bits,
//   hashed while the tile's copies are in flight; 128 registers a thread
//   at D <= 64 (4 blocks an SM);
// - the heaviest query tiles (the most live key tiles) launch first.
// Ragged S is masked in the kernel: rows past q_len / kv_len are zero-
// filled by cp.async and never stored.
#include "mma.cuh"

namespace stf {
namespace {

template <int D>
constexpr int mma_smem_bytes() {
  return 5 * kTile * D * static_cast<int>(sizeof(bf16));  // q | k x2 | v x2
}

// blocks an SM must hold: 4 caps D <= 64 at 128 registers a thread (3
// blocks at 160 registers ran the dropout kernel slower on an H100)
template <int D>
constexpr int mma_min_blocks() {
  return D <= 64 ? 4 : 2;
}

// grid (B*H, query tiles), the heaviest tile first. Lane (g, t) = (lane / 4,
// lane % 4) holds accumulator elements (rows g and g + 8 of its warp's 16)
// x (columns 2t, 2t + 1 of every 8-column n-tile).
template <int D, bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<D>())
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias, bf16* __restrict__ o,
                         float* __restrict__ lse, int q_len, int kv_len, int H,
                         float scale, uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                         float inv_keep) {
  constexpr int KS = D / 16;  // k-steps of Q.K^T, pairs of d n-tiles of P.V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_sh = q_sh + kTile * D;      // two stages
  bf16* v_sh = k_sh + 2 * kTile * D;  // two stages

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + warp * 16 + g;  // global rows of c[0..1], c[2..3]
  const int row_hi = row_lo + 8;

  const bf16* qb = q + static_cast<long long>(bh) * q_len * D;
  const bf16* kb = k + static_cast<long long>(bh) * kv_len * D;
  const bf16* vb = v + static_cast<long long>(bh) * kv_len * D;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  int n_kt = cdiv(kv_len, kTile);
  if (kCausal) n_kt = min(n_kt, qi + 1);  // the `live` tiles

  load_tile<D>(q_sh, qb, q0, q_len);
  load_tile<D>(k_sh, kb, 0, kv_len);
  load_tile<D>(v_sh, vb, 0, kv_len);
  cp_async_commit();

  // this warp's 16 Q rows, read as A fragments from shared memory for
  // each tile (registers kept for the scores)
  const int q_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
  // a tile's K0 keep bits (bit 4n + e of the thread's s[n][e]). The row
  // halves mix32(h0 ^ row) are recomputed for each tile: held across the
  // loop, or with the column hash reshaped into fewer instructions, the
  // compiler spilled registers at the 128-register cap and the kernel ran
  // slower on an H100
  auto keep_bits = [&](int k0) {
    uint32_t keep = 0u;
    const uint32_t h0 = keep_hash0(dropout_seed(seed, seed_ptr), bh);
    const uint32_t hr_lo = mix32(h0 ^ row_lo), hr_hi = mix32(h0 ^ row_hi);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        keep |= static_cast<uint32_t>(
                    mix32((e < 2 ? hr_lo : hr_hi) ^
                          (k0 + n * 8 + 2 * t + (e & 1))) < threshold)
                << (4 * n + e);
    return keep;
  };

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    // hashed while tile kt's copies are in flight (at kt = 0 also Q's)
    const uint32_t keep = kDropout ? keep_bits(k0) : 0u;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < n_kt) {  // prefetch tile kt + 1 into the other stage
      const int st = (kt + 1) & 1;
      load_tile<D>(k_sh + st * kTile * D, kb, (kt + 1) * kTile, kv_len);
      load_tile<D>(v_sh + st * kTile * D, vb, (kt + 1) * kTile, kv_len);
      cp_async_commit();
    }
    const bf16* ks = k_sh + (kt & 1) * kTile * D;
    const bf16* vs = v_sh + (kt & 1) * kTile * D;

    // S = Q K^T: 16 x 64 a warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4];
      ldsm_x4(qf, q_sh + swz<D>(q_row, kk * 2 + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks + swz<D>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                               kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qf, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf, b[2], b[3]);
      }
    }

    // scale, bias before the mask; masks on the diagonal and ragged tiles
    const bool edge = (kCausal && kt == qi) || k0 + kTile > kv_len;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float x = s[n][e] * scale;
        if (bb != nullptr && col < kv_len) x += __ldg(bb + col);
        if (edge && !(col < kv_len && (!kCausal || row >= col))) x = kNegInf;
        s[n][e] = x;
      }
    }

    // online softmax on the fragments; l sums the undropped p
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = ex2((m_lo - mx_lo) * kLog2e);
    const float a_hi = ex2((m_hi - mx_hi) * kLog2e);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
    uint32_t pf[4][4];  // P as A fragments, one per 16-key chunk
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = ex2((s[n][e] - (e < 2 ? m_lo : m_hi)) * kLog2e);
      sum_lo += p[0] + p[1];
      sum_hi += p[2] + p[3];
      if (kDropout) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = (keep >> (4 * n + e)) & 1u ? __fmul_rn(p[e], inv_keep)
                                            : 0.0f;
      }
      pf[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    l_lo = a_lo * l_lo + sum_lo;
    l_hi = a_hi * l_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }

    // O += P V: V fragments by ldmatrix.trans, two d n-tiles a load
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + swz<D>(kc * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     dp * 2 + (lane >> 4)));
        mma_bf16(acc[2 * dp], pf[kc], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pf[kc], b[2], b[3]);
      }
    }
  }

  // o = acc / l_safe through the warp's own Q rows (read only by this
  // warp), then 16-byte stores of the live rows
  const float ls_lo = quad_sum(l_lo), ls_hi = quad_sum(l_hi);
  const float d_lo = ls_lo == 0.0f ? 1.0f : ls_lo;
  const float d_hi = ls_hi == 0.0f ? 1.0f : ls_hi;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    acc[n][0] /= d_lo;
    acc[n][1] /= d_lo;
    acc[n][2] /= d_hi;
    acc[n][3] /= d_hi;
  }
  store_rows<D>(q_sh, warp * 16, acc,
                o + static_cast<long long>(bh) * q_len * D, q0 + warp * 16,
                q_len);
  if (t == 0) {
    float* lb = lse + static_cast<long long>(bh) * q_len;
    if (row_lo < q_len) lb[row_lo] = m_lo + logf(d_lo);
    if (row_hi < q_len) lb[row_hi] = m_hi + logf(d_hi);
  }
}

template <int D, bool kCausal, bool kDropout>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v,
                       const float* bias, bf16* o, float* lse, int BH,
                       int q_len, int kv_len, int H, float scale,
                       uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold, float inv_keep,
                       cudaStream_t s) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kernel = flash_fwd_mma_kernel<D, kCausal, kDropout>;
  static bool attr_set = false;  // once a process, before any capture
  if (smem > 48 * 1024 && !attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  kernel<<<dim3(BH, cdiv(q_len, kTile)), kMmaThreads, smem, s>>>(
      q, k, v, bias, o, lse, q_len, kv_len, H, scale, seed, seed_ptr, threshold,
      inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_flags(const bf16* q, const bf16* k, const bf16* v,
                     const float* bias, bf16* o, float* lse, int BH,
                     int q_len, int kv_len, int H, float scale, int causal,
                     int dropout, uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                     float inv_keep, cudaStream_t s) {
#define STF_MMA_LAUNCH(C, DR)                                              \
  return launch_mma<D, C, DR>(q, k, v, bias, o, lse, BH, q_len, kv_len, H, \
                              scale, seed, seed_ptr, threshold, inv_keep, s)
  if (causal) {
    if (dropout) STF_MMA_LAUNCH(true, true);
    STF_MMA_LAUNCH(true, false);
  }
  if (dropout) STF_MMA_LAUNCH(false, true);
  STF_MMA_LAUNCH(false, false);
#undef STF_MMA_LAUNCH
}

}  // namespace

// Called by flash_attention.cu for bf16 forwards: the arguments of
// stf_flash_attention_fwd with q, k, v, o bf16.
cudaError_t flash_fwd_bf16_mma(const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int BH,
                               int q_len, int kv_len, int H, int D,
                               float scale, int causal, int dropout,
                               uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                               float inv_keep, cudaStream_t s) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  switch (D) {
#define STF_MMA_DIM(DD)                                                     \
  case DD:                                                                  \
    return by_flags<DD>(qp, kp, vp, bias, op, lse, BH, q_len, kv_len, H,    \
                        scale, causal, dropout, seed, seed_ptr, threshold,  \
                        inv_keep, s)
    STF_MMA_DIM(16);
    STF_MMA_DIM(32);
    STF_MMA_DIM(64);
#undef STF_MMA_DIM
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace stf
