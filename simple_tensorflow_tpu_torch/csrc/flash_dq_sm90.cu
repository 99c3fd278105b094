// The bf16 FlashAttention dQ at head dim 128 on Hopper's wgmma and TMA: the
// port of the TPU kernel simple_tensorflow_tpu/ops/pallas/
// flash_attention.py:_bwd_dq_kernel (:264, called at :383) for bf16 inputs
// with D = 128, dropout branch (:297-301) included. flash_attention.cu
// routes every bf16 dQ at D = 128 here; D <= 64 stays on flash_bwd_mma.cu.
//
// What it computes is flash_bwd_mma.cu's dQ, per head bh (bias row bh / H):
// s = (q . k) * scale (+ bias[key]), masked where key >= kv_len or (causal)
// key > query; p = exp(s - lse); dP = dO . V^T, with dropout keep ? dP *
// inv_keep : 0, the mask K0 counter_keep(keep_hash0(seed, bh), global
// query, global key); dS = (p * (dP - delta) * scale)(bf16); dQ += dS . K.
//
// What bounds it on the card: operations. At the long-context shape (8
// heads of S = 32768, causal) the three products take 6 * D FLOP a live
// pair, 3.3 TFLOP (3.3 ms at the 989 TFLOP/s dense bf16 peak), against 338
// MB of q, k, v, dO, lse, delta and dQ (0.10 ms at 3.35 TB/s). The design is
// flash_dkdv_sm90.cu's turned round, so that a block owns queries and
// streams keys:
// - a block owns 128 queries: 3 warpgroups (384 threads), one block an SM,
//   the heaviest query tile (the last, when causal) first. Warpgroup 0
//   produces (setmaxnreg 24): one thread issues the TMA loads of Q and dO
//   (once) and of each 64-key tile of K and V into a ring of kStages
//   stages, walked from key 0 up to the causal diagonal, and its warp
//   stages the tile's bias * log2e through plain stores before arriving on
//   the stage's full mbarrier. Warpgroups 1 and 2 consume (setmaxnreg 240),
//   64 queries each, with -lse * log2e, delta and (with dropout) the row
//   hashes mix32(h0 ^ query) of a lane's two rows in registers;
// - shared memory: Q and dO (128 x 128 each) resident; K and V tiles (64 x
//   128 each) and the tile's bias in the ring: 64 + 4 x 32.25 KB;
// - three wgmma products a tile: S = Q K^T and dP = dO V^T (m64n64k16, both
//   operands from shared memory, K-major); dS, rounded to bf16 in
//   registers, is the register A operand of dQ += dS K (m64n128k16, K an
//   MN-major B operand of the same tile). S and dP of the next tile are
//   issued beside dQ of this one, so the tensor cores take them back to
//   back; a lane's accumulators hold 2 queries x 16 keys, so the dropout
//   mask is one mix32 of a held row hash ^ key, one compare, an element;
// - the two consumers take turns on named barriers (FlashAttention-3's
//   ping-pong, as flash_fwd_sm90.cu): one warpgroup computes its dS while
//   the other's products hold the tensor cores (6.3 -> 5.3 ms at the
//   long-context shape on an H100);
// - only the diagonal tiles and a ragged last tile are masked (under
//   causal the first consumer's last tile is all masked: it adds zeros);
// - a stage is released only after the wgmma reading it has retired;
// - no atomics: each (bh, query tile) has one owner, so dQ is deterministic
//   (bit-identical between a captured step and an eager one).
// dQ takes 64 f32 registers a consumer thread, S and dP 64 more, dS 16;
// ptxas -v reports no spill and no serialized wgmma (C7512).
#include "sm90.cuh"

namespace stf {
namespace {

using namespace sm90;

constexpr int kD = 128;
constexpr int kBM = 128;     // queries a block (64 a consumer warpgroup)
constexpr int kBN = 64;      // keys a tile
constexpr int kStages = 4;   // K/V ring depth
constexpr int kThreads = 384;
constexpr uint32_t kQBox = kBM * 128;     // (128 queries, 64 columns)
constexpr uint32_t kQTile = 2 * kQBox;    // (128, 128) bf16
constexpr uint32_t kKBox = kBN * 128;     // (64 keys, 64 columns)
constexpr uint32_t kKTile = 2 * kKBox;    // (64, 128) bf16
constexpr uint32_t kBias = kBN * 4;       // the tile's bias * log2e
// q | do | k x kStages | v x kStages | bias x kStages | mbarriers, + 1024
// to align the base
constexpr int kSmemBytes = 2 * kQTile + kStages * (2 * kKTile + kBias) +
                           8 * (1 + 2 * kStages) + 1024;

template <bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         bf16* __restrict__ dq, int q_len, int kv_len, int H,
                         float scale, uint32_t seed, const uint32_t* seed_ptr,
                         uint32_t threshold, float inv_keep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = smem_base_1024(smem_raw);
  const uint32_t sdo = sq + kQTile;
  const uint32_t sk = sdo + kQTile;           // kStages
  const uint32_t sv = sk + kStages * kKTile;  // kStages
  const uint32_t sb = sv + kStages * kKTile;  // kStages
  const uint32_t bars = sb + kStages * kBias;
  // generic pointer of the stage-0 bias (plain loads and stores)
  float* const bias0 =
      reinterpret_cast<float*>(smem_raw + (sb - smem_u32(smem_raw)));
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;  // the heaviest tile first
  const int q0 = qi * kBM;
  // key tiles from key 0 up to the causal diagonal (the `live` tiles)
  int n_kt = cdiv(kv_len, kBN);
  if (kCausal) n_kt = min(n_kt, cdiv(q0 + kBM, kBN));
  const bool has_bias = bias != nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread's + the staging warp's
      mbar_init(empty(s), 8);      // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* bb =
          has_bias ? bias + static_cast<long long>(bh / H) * kv_len : nullptr;
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * kQTile);
        tma_load_3d(sq, &tq, q_full, 0, q0, bh);
        tma_load_3d(sq + kQBox, &tq, q_full, 64, q0, bh);
        tma_load_3d(sdo, &tdo, q_full, 0, q0, bh);
        tma_load_3d(sdo + kQBox, &tdo, q_full, 64, q0, bh);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = i * kBN;
        mbar_wait(empty(s), ph ^ 1);
        if (lane == 0) {
          const uint32_t ks = sk + s * kKTile, vs = sv + s * kKTile;
          mbar_expect_tx(full(s), 2 * kKTile);
          tma_load_3d(ks, &tk, full(s), 0, k0, bh);
          tma_load_3d(ks + kKBox, &tk, full(s), 64, k0, bh);
          tma_load_3d(vs, &tv, full(s), 0, k0, bh);
          tma_load_3d(vs + kKBox, &tv, full(s), 64, k0, bh);
        }
        if (has_bias) {
          float* b = bias0 + s * kBN;
#pragma unroll
          for (int c = lane; c < kBN; c += 32)
            b[c] = k0 + c < kv_len ? __ldg(bb + k0 + c) * kLog2e : 0.0f;
        }
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumers. Lane (g, t) of warp w holds accumulator elements (queries
  // 16w + g, 16w + g + 8 of the warpgroup's 64) x (columns 8j + 2t,
  // 8j + 2t + 1): keys of the tile for S and dP (j < 8), head dims for dQ
  // (j < 16); element 4j + e, e < 2 on the lower query
  regs_inc<240>();
  const int cw = (threadIdx.x - 128) >> 7;  // 0, 1: queries 64 cw of the tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + cw * 64;  // the warpgroup's first query
  const int row_lo = row0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const long long qo = static_cast<long long>(bh) * q_len;
  // -lse * log2e and delta of the lane's two queries (0 past q_len: never
  // stored)
  float nl_lo = 0.0f, nl_hi = 0.0f, dl_lo = 0.0f, dl_hi = 0.0f;
  if (row_lo < q_len) {
    nl_lo = -__ldg(lse + qo + row_lo) * kLog2e;
    dl_lo = __ldg(delta + qo + row_lo);
  }
  if (row_hi < q_len) {
    nl_hi = -__ldg(lse + qo + row_hi) * kLog2e;
    dl_hi = __ldg(delta + qo + row_hi);
  }
  uint32_t hr_lo = 0u, hr_hi = 0u;  // K0's row hashes
  if (kDropout) {
    const uint32_t h0 = keep_hash0(dropout_seed(seed, seed_ptr), bh);
    hr_lo = mix32(h0 ^ static_cast<uint32_t>(row_lo));
    hr_hi = mix32(h0 ^ static_cast<uint32_t>(row_hi));
  }
  const float scale_l2 = scale * kLog2e;
  const uint32_t qa = sq + cw * 64 * 128, oa = sdo + cw * 64 * 128;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float sc[32], dp[32];  // S and dP of the tile in flight
  uint32_t sf[4][4];     // dS as the A fragments of the 4 k-steps of dS K

  // S = Q K^T and dP = dO V^T of the tile in stage s (64 queries x 64 keys
  // a warpgroup), one group
  auto issue_sdp = [&](int s) {
    const uint64_t dqa = desc_here(desc_sw128(qa, 16, 1024));
    const uint64_t doa = desc_here(desc_sw128(oa, 16, 1024));
    const uint64_t dka = desc_here(desc_sw128(sk + s * kKTile, 16, 1024));
    const uint64_t dva = desc_here(desc_sw128(sv + s * kKTile, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t qoff = (kk >> 2) * kQBox + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * kKBox + (kk & 3) * 32;
      wgmma_m64n64k16_ss(sc, desc_at(dqa, qoff), desc_at(dka, koff), kk);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t qoff = (kk >> 2) * kQBox + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * kKBox + (kk & 3) * 32;
      wgmma_m64n64k16_ss(dp, desc_at(doa, qoff), desc_at(dva, koff), kk);
    }
    wgmma_commit();
  };
  // dQ += dS K of the tile in stage s, one group: k-step kk takes keys
  // 16 kk .. 16 kk + 15 of the tile
  auto issue_dq = [&](int s) {
    const uint64_t dkm =
        desc_here(desc_sw128(sk + s * kKTile, kKBox, 1024));
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_m64n128k16_rs(acc, sf[kk], desc_at(dkm, kk * 2048));
    wgmma_commit();
  };
  // dS of key tile i (in stage s) from sc and dp, as bf16 A fragments
  auto make_ds = [&](int i, int s) {
    const int k0 = i * kBN;
    const bool edge = (kCausal && k0 + kBN - 1 > row0) || k0 + kBN > kv_len;
    const float* b = bias0 + s * kBN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;  // tile column of e = 0 and 2
      float2 b2 = make_float2(0.0f, 0.0f);
      if (has_bias) b2 = *reinterpret_cast<const float2*>(b + c);
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + c + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float x = fmaf(sc[4 * j + e], scale_l2, e < 2 ? nl_lo : nl_hi);
        if (has_bias) x += (e & 1) ? b2.y : b2.x;
        float p = ex2(x);
        if (edge && !(key < kv_len && (!kCausal || row >= key))) p = 0.0f;
        float dpv = dp[4 * j + e];
        if (kDropout) {
          const bool keep =
              mix32((e < 2 ? hr_lo : hr_hi) ^ static_cast<uint32_t>(key)) <
              threshold;
          dpv = keep ? __fmul_rn(dpv, inv_keep) : 0.0f;
        }
        dsv[e] = p * (dpv - (e < 2 ? dl_lo : dl_hi)) * scale;
      }
      sf[j / 2][(j & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      sf[j / 2][(j & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }
  };
  auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };

  // The two consumers take turns to issue their products (named barriers
  // 1 + cw, FlashAttention-3's ping-pong), so one warpgroup's dS runs while
  // the other's products hold the tensor cores. A turn issues dQ += dS_i K_i
  // and S, dP of tile i + 1; each warpgroup takes 1 + n_kt turns (under
  // causal the first consumer's last tile is all masked: it adds zeros),
  // warpgroup 0 first; warpgroup 1's last turn hands none.
  if (cw == 1) named_arrive(1, 256);
  mbar_wait(q_full, 0);
  mbar_wait(full(0), 0);
  named_sync(1 + cw, 256);
  wgmma_fence();
  issue_sdp(0);
  named_arrive(2 - cw, 256);
  wgmma_wait<0>();
  reg_fence(sc);
  reg_fence(dp);
  make_ds(0, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages, s1 = (i + 1) % kStages;
    const bool next = i + 1 < n_kt;
    if (next) mbar_wait(full(s1), ((i + 1) / kStages) & 1);
    named_sync(1 + cw, 256);
    reg_fence(acc);
    wgmma_fence();
    issue_dq(s);
    if (next) issue_sdp(s1);
    if (next || cw == 0) named_arrive(2 - cw, 256);
    if (next) {
      wgmma_wait<1>();  // dQ of tile i
      reg_fence(acc);
      release(s);
      wgmma_wait<0>();  // S and dP of tile i + 1
      reg_fence(sc);
      reg_fence(dp);
      make_ds(i + 1, s1);
    } else {
      wgmma_wait<0>();
      reg_fence(acc);
      release(s);
    }
  }

  // dQ as bf16 pairs, the queries below q_len
  bf16* qb = dq + qo * kD;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_lo < q_len)
      *reinterpret_cast<uint32_t*>(qb + static_cast<long long>(row_lo) * kD +
                                   col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row_hi < q_len)
      *reinterpret_cast<uint32_t*>(qb + static_cast<long long>(row_hi) * kD +
                                   col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <bool kCausal, bool kDropout>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo,
                   const float* lse, const float* delta, const float* bias,
                   bf16* dq, int BH, int q_len, int kv_len, int H,
                   float scale, uint32_t seed, const uint32_t* seed_ptr,
                   uint32_t threshold, float inv_keep, cudaStream_t s) {
  auto kernel = flash_dq_sm90_kernel<kCausal, kDropout>;
  // on every launch: the attribute is per device
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(BH, cdiv(q_len, kBM)), kThreads, kSmemBytes, s>>>(
      tq, tk, tv, tdo, lse, delta, bias, dq, q_len, kv_len, H, scale, seed,
      seed_ptr, threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// Called by flash_attention.cu for bf16 dQ at D = 128: the arguments of
// stf_flash_attention_dq with q, k, v, dout, dq bf16 (BH, S, 128).
cudaError_t flash_dq_sm90(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* bias, void* dq,
                          int BH, int q_len, int kv_len, int H, float scale,
                          int causal, int dropout, uint32_t seed,
                          const uint32_t* seed_ptr, uint32_t threshold,
                          float inv_keep, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = sm90::bhsd_map(&tq, q, BH, q_len, kBM);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tdo, dout, BH, q_len, kBM);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tk, k, BH, kv_len, kBN);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tv, v, BH, kv_len, kBN);
  if (e != cudaSuccess) return e;
  bf16* dqp = static_cast<bf16*>(dq);
#define STF_SM90_LAUNCH(C, DR)                                              \
  return launch<C, DR>(tq, tk, tv, tdo, lse, delta, bias, dqp, BH, q_len,   \
                       kv_len, H, scale, seed, seed_ptr, threshold,         \
                       inv_keep, s)
  if (causal) {
    if (dropout) STF_SM90_LAUNCH(true, true);
    STF_SM90_LAUNCH(true, false);
  }
  if (dropout) STF_SM90_LAUNCH(false, true);
  STF_SM90_LAUNCH(false, false);
#undef STF_SM90_LAUNCH
}

}  // namespace stf
