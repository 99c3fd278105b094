// The bf16 FlashAttention forward at head dim 128 on Hopper's wgmma and
// TMA: the port of the TPU kernel simple_tensorflow_tpu/ops/pallas/
// flash_attention.py:_fwd_kernel (:102, called at :180) for bf16 inputs
// with D = 128, dropout branch included. flash_attention.cu routes every
// bf16 forward at D = 128 here; D <= 64 stays on flash_fwd_mma.cu.
//
// What it computes is flash_fwd_mma.cu's function: s = (q . k) * scale
// (+ bias[b, key]), NEG_INF where key >= kv_len or (causal) key > query,
// an online softmax whose l sums the undropped p, p rounded to bf16 before
// P.V (with dropout keep ? p * inv_keep : 0 first, the mask K0
// counter_keep(keep_hash0(seed, bh), global row, global col)), o = acc /
// l_safe and lse = m + log(l_safe). The softmax runs in the log2 domain
// (s * scale * log2e, ex2), which changes roundoff only.
//
// What bounds it on the card: operations. At the long-context shape (8
// heads of S = 32768, causal) the live pairs take 4 * D FLOP each, 2.2 TFLOP
// (2.2 ms at the 989 TFLOP/s dense bf16 peak), against 201 MB of q, k, v, o
// and lse (0.06 ms at 3.35 TB/s). Only wgmma reaches the tensor cores' full
// rate, and it is asynchronous, so the design is FlashAttention-3's:
// - warp specialisation: 3 warpgroups (384 threads), one block an SM.
//   Warpgroup 0 produces: it gives back registers (setmaxnreg 24) and one
//   thread issues every TMA load. Warpgroups 1 and 2 consume (setmaxnreg
//   240), each owning 64 rows of the block's 128-row Q tile;
// - shared memory: Q (128 x 128 bf16, loaded once), K and V tiles of 128
//   keys in a ring of kStages = 3 stages with a full mbarrier each for K
//   and for V and an empty mbarrier a stage: 32 + 3 x 64 KB (a stage is
//   held from S of tile i to P V of tile i, one turn later, so 2 stages
//   left no room to prefetch). TMA zero-fills rows past q_len / kv_len
//   within a head (3-D maps);
// - S = Q K^T: 8 wgmma m64n128k16 a tile, both operands from shared
//   memory (K-major, 128B swizzle), f32 accumulators; the online softmax
//   runs on the accumulator fragments (row max and sum over the 4 lanes of
//   a quad), P is rounded to bf16 in registers and is the register A
//   operand of O += P V (8 wgmma m64n128k16, V an MN-major B operand), so
//   scores never leave registers and Q is never reloaded;
// - the two consumers take turns on named barriers (FlashAttention-3's
//   ping-pong): a turn issues S of tile i and P V of tile i - 1, so one
//   warpgroup's softmax runs while the other's products hold the tensor
//   cores, and the softmax of tile i overlaps its own P V of tile i - 1;
// - a consumer releases a stage only after the wgmma reading it has retired
//   (wgmma.wait_group), one arrival a warp;
// - causal: the walk runs from the last live key tile (the diagonal, or a
//   ragged last tile) down to tile 0, so only the first tile is masked, the
//   mask a compare of 8j + e against a per-row limit; the heaviest query
//   tiles launch first.
// S, O and P take 160 registers in flight at the 240-register cap; ptxas
// -v reports no spill at rate 0 and no serialized wgmma (C7512), which a
// timeout with __trap in the mbarrier wait loop had caused (sm90.cuh).
#include "sm90.cuh"

namespace stf {
namespace {

using namespace sm90;

constexpr int kD = 128;
constexpr int kBM = 128;      // query rows a block (64 a consumer warpgroup)
constexpr int kBN = 128;      // keys a tile
constexpr int kStages = 3;    // K/V ring depth
constexpr int kThreads = 384;
constexpr uint32_t kBox = kBN * 128;    // one (128 rows, 64 columns) box
constexpr uint32_t kTileBytes = 2 * kBox;  // a (128, 128) bf16 tile
// q | k x kStages | v x kStages | mbarriers, + 1024 to align the base
constexpr int kSmemBytes =
    (1 + 2 * kStages) * kTileBytes + 8 * (1 + 3 * kStages) + 1024;

template <bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ bias,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int q_len, int kv_len, int H, float scale,
                          uint32_t seed, const uint32_t* seed_ptr,
                          uint32_t threshold, float inv_keep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = smem_base_1024(smem_raw);
  const uint32_t sk = sq + kTileBytes;
  const uint32_t sv = sk + kStages * kTileBytes;
  const uint32_t bars = sv + kStages * kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;  // the heaviest tile first
  const int q0 = qi * kBM;
  int n_kt = cdiv(kv_len, kBN);
  if (kCausal) n_kt = min(n_kt, qi + 1);  // the `live` tiles

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: Q once, then K and V of tile n_kt - 1 - i into stage i %
    // kStages once the consumers have released it
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load_3d(sq, &tq, q_full, 0, q0, bh);
      tma_load_3d(sq + kBox, &tq, q_full, 64, q0, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (n_kt - 1 - i) * kBN;
        mbar_wait(empty(s), ph ^ 1);
        const uint32_t ks = sk + s * kTileBytes, vs = sv + s * kTileBytes;
        mbar_expect_tx(k_full(s), kTileBytes);
        tma_load_3d(ks, &tk, k_full(s), 0, k0, bh);
        tma_load_3d(ks + kBox, &tk, k_full(s), 64, k0, bh);
        mbar_expect_tx(v_full(s), kTileBytes);
        tma_load_3d(vs, &tv, v_full(s), 0, k0, bh);
        tma_load_3d(vs + kBox, &tv, v_full(s), 64, k0, bh);
      }
    }
    return;
  }

  // consumers. Lane (g, t) = (lane / 4, lane % 4) of warp w holds
  // accumulator elements (rows 16w + g, 16w + g + 8 of the warpgroup's 64)
  // x (columns 8j + 2t, 8j + 2t + 1, j < 16): element 4j + e, e < 2 on the
  // lower row
  regs_inc<240>();
  const int cw = (threadIdx.x - 128) >> 7;  // 0, 1: rows 64 cw of the tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + cw * 64 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;
  uint32_t hr_lo = 0u, hr_hi = 0u;  // K0's row hashes
  if (kDropout) {
    const uint32_t h0 = keep_hash0(dropout_seed(seed, seed_ptr), bh);
    hr_lo = mix32(h0 ^ static_cast<uint32_t>(row_lo));
    hr_hi = mix32(h0 ^ static_cast<uint32_t>(row_hi));
  }
  const float scale_l2 = scale * kLog2e;
  const uint32_t qa = sq + cw * 64 * 128;  // this warpgroup's rows of Q

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
  float sc[64];       // S of the tile in flight, then its (dropped) p
  uint32_t pf[8][4];  // P as the A fragments of the 8 k-steps of P.V
  const uint64_t dq = desc_sw128(qa, 16, 1024);

  // S = Q K^T of the tile in stage s (64 x 128 a warpgroup), one group
  auto issue_s = [&](int s) {
    const uint64_t dqh = desc_here(dq);
    const uint64_t dk = desc_here(desc_sw128(sk + s * kTileBytes, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
      wgmma_m64n128k16_ss(sc, desc_at(dqh, off), desc_at(dk, off), kk);
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage s, one group: k-step kk takes keys
  // 16 kk .. 16 kk + 15 of the tile
  auto issue_pv = [&](int s) {
    const uint64_t dv =
        desc_here(desc_sw128(sv + s * kTileBytes, kBox, 1024));
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_m64n128k16_rs(acc, pf[kk], desc_at(dv, kk * 2048));
    wgmma_commit();
  };
  // the online softmax of key tile kt on sc, in place: scale (log2
  // domain), bias before the mask, the mask on the diagonal and ragged
  // tiles; the new row max, p = ex2(s - m), l += the undropped p, then the
  // dropped p. Returns the factors (a_lo, a_hi) that rescale O.
  auto softmax = [&](int kt) {
    // key k0 + 8j + 2t + e of a row is live where 8j + e < lim, a
    // per-row limit, so no per-element column is held in registers
    const int k0 = kt * kBN;
    const int cb = k0 + 2 * t;
    const bool edge = (kCausal && kt == qi) || k0 + kBN > kv_len;
    const int lim_kv = kv_len - cb;
    const int lim[2] = {kCausal ? min(lim_kv, row_lo + 1 - cb) : lim_kv,
                        kCausal ? min(lim_kv, row_hi + 1 - cb) : lim_kv};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cj = j * 8 + (e & 1);
        float x = sc[4 * j + e] * scale_l2;
        if (bb != nullptr && cj < lim_kv)
          x = fmaf(__ldg(bb + cb + cj), kLog2e, x);
        if (edge && !(cj < lim[e >> 1])) x = kNegInf;
        sc[4 * j + e] = x;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float2 a = make_float2(ex2(m_lo - mx_lo), ex2(m_hi - mx_hi));
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(sc[4 * j + e] - (e < 2 ? m_lo : m_hi));
        (e < 2 ? sum_lo : sum_hi) += p;
        if (kDropout) {
          const uint32_t col = cb + j * 8 + (e & 1);
          const bool keep =
              mix32((e < 2 ? hr_lo : hr_hi) ^ col) < threshold;
          p = keep ? __fmul_rn(p, inv_keep) : 0.0f;
        }
        sc[4 * j + e] = p;
      }
    }
    l_lo = a.x * l_lo + sum_lo;
    l_hi = a.y * l_hi + sum_hi;
    return a;
  };
  // O *= a once the P V reading it has retired, and the new P as bf16
  auto rescale_pack = [&](float2 a) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= a.x;
      acc[4 * j + 1] *= a.x;
      acc[4 * j + 2] *= a.y;
      acc[4 * j + 3] *= a.y;
      pf[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };
  auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };

  // The two consumer warpgroups take turns to issue their products, so one
  // warpgroup's softmax runs while the other's products hold the tensor
  // cores: warpgroup cw waits at named barrier 1 + cw for the other's
  // arrival there, issues, and arrives at the other's. Turn 0 issues S of
  // the first tile; turn i (0 < i < n_kt) issues S of tile i and then P V
  // of tile i - 1, and the softmax of tile i runs while that P V does;
  // turn n_kt issues the last P V. Warpgroup 0 takes the first turn.
  if (cw == 1) named_arrive(1, 256);
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  named_sync(1 + cw, 256);
  wgmma_fence();
  issue_s(0);
  named_arrive(2 - cw, 256);
  wgmma_wait<0>();
  reg_fence(sc);
  rescale_pack(softmax(n_kt - 1));
  for (int i = 1; i < n_kt; ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(k_full(s), (i / kStages) & 1);
    mbar_wait(v_full(sp), ((i - 1) / kStages) & 1);
    named_sync(1 + cw, 256);
    reg_fence(acc);
    wgmma_fence();
    issue_s(s);
    issue_pv(sp);
    named_arrive(2 - cw, 256);
    wgmma_wait<1>();  // S of tile i
    reg_fence(sc);
    const float2 a = softmax(n_kt - 1 - i);
    wgmma_wait<0>();  // P V of tile i - 1
    reg_fence(acc);
    release(sp);
    rescale_pack(a);
  }
  const int sl = (n_kt - 1) % kStages;
  mbar_wait(v_full(sl), ((n_kt - 1) / kStages) & 1);
  named_sync(1 + cw, 256);
  reg_fence(acc);
  wgmma_fence();
  issue_pv(sl);
  if (cw == 0) named_arrive(2, 256);  // warpgroup 1's last turn hands none
  wgmma_wait<0>();
  reg_fence(acc);
  release(sl);

  // o = acc / l_safe as bf16 pairs; lse = m + log(l_safe)
  const float ls_lo = quad_sum(l_lo), ls_hi = quad_sum(l_hi);
  const float d_lo = ls_lo == 0.0f ? 1.0f : ls_lo;
  const float d_hi = ls_hi == 0.0f ? 1.0f : ls_hi;
  bf16* ob = o + static_cast<long long>(bh) * q_len * kD;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_lo < q_len)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_lo) * kD +
                                   col) =
          pack_bf16(acc[4 * j] / d_lo, acc[4 * j + 1] / d_lo);
    if (row_hi < q_len)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row_hi) * kD +
                                   col) =
          pack_bf16(acc[4 * j + 2] / d_hi, acc[4 * j + 3] / d_hi);
  }
  if (t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + static_cast<long long>(bh) * q_len;
    if (row_lo < q_len) lb[row_lo] = m_lo * kLn2 + logf(d_lo);
    if (row_hi < q_len) lb[row_hi] = m_hi * kLn2 + logf(d_hi);
  }
}

template <bool kCausal, bool kDropout>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const float* bias, bf16* o,
                   float* lse, int BH, int q_len, int kv_len, int H,
                   float scale, uint32_t seed, const uint32_t* seed_ptr,
                   uint32_t threshold, float inv_keep, cudaStream_t s) {
  auto kernel = flash_fwd_sm90_kernel<kCausal, kDropout>;
  // on every launch: the attribute is per device
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(BH, cdiv(q_len, kBM)), kThreads, kSmemBytes, s>>>(
      tq, tk, tv, bias, o, lse, q_len, kv_len, H, scale, seed, seed_ptr,
      threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// Called by flash_attention.cu for bf16 forwards at D = 128: the arguments
// of stf_flash_attention_fwd with q, k, v, o bf16 (BH, S, 128).
cudaError_t flash_fwd_sm90(const void* q, const void* k, const void* v,
                           const float* bias, void* o, float* lse, int BH,
                           int q_len, int kv_len, int H, float scale,
                           int causal, int dropout, uint32_t seed,
                           const uint32_t* seed_ptr, uint32_t threshold,
                           float inv_keep, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  cudaError_t e = sm90::bhsd_map(&tq, q, BH, q_len, kBM);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tk, k, BH, kv_len, kBN);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tv, v, BH, kv_len, kBN);
  if (e != cudaSuccess) return e;
  bf16* op = static_cast<bf16*>(o);
#define STF_SM90_LAUNCH(C, DR)                                              \
  return launch<C, DR>(tq, tk, tv, bias, op, lse, BH, q_len, kv_len, H,     \
                       scale, seed, seed_ptr, threshold, inv_keep, s)
  if (causal) {
    if (dropout) STF_SM90_LAUNCH(true, true);
    STF_SM90_LAUNCH(true, false);
  }
  if (dropout) STF_SM90_LAUNCH(false, true);
  STF_SM90_LAUNCH(false, false);
#undef STF_SM90_LAUNCH
}

}  // namespace stf
