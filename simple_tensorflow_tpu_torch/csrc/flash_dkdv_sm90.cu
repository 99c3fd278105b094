// The bf16 FlashAttention dK/dV at head dim 128 on Hopper's wgmma and TMA:
// the port of the TPU kernel simple_tensorflow_tpu/ops/pallas/
// flash_attention.py:_bwd_dkdv_kernel (:210, called at :352) for bf16
// inputs with D = 128, dropout branch (:244-253) included.
// flash_attention.cu routes every bf16 dK/dV at D = 128 here; dQ and
// D <= 64 stay on flash_bwd_mma.cu.
//
// What it computes is flash_bwd_mma.cu's dK/dV, per head bh (bias row
// bh / H): s = (q . k) * scale (+ bias[key]), masked where key >= kv_len
// or (causal) key > query; p = exp(s - lse); dP = dO . V^T; with dropout
// dP and the p of dV become keep ? x * inv_keep : 0, the mask K0
// counter_keep(keep_hash0(seed, bh), global query, global key);
// dV += p_dropped(bf16)^T . dO; dS = (p * (dP - delta) * scale)(bf16) with
// the undropped p; dK += dS^T . Q.
//
// What bounds it on the card: operations. At the long-context shape (8
// heads of S = 32768, causal) the four products take 8 * D FLOP a live
// pair, 4.4 TFLOP (4.4 ms at the 989 TFLOP/s dense bf16 peak), against
// 269 MB of q, k, v, dO, lse, delta, dK and dV (0.08 ms at 3.35 TB/s).
// The design is flash_fwd_sm90.cu's, carried to the backward:
// - a block owns 128 keys: 3 warpgroups (384 threads), one block an SM.
//   Warpgroup 0 produces (setmaxnreg 24): one thread issues the TMA loads
//   of K and V (once) and of each 64-query sub-tile of Q and dO, and its
//   warp stages the sub-tile's lse, delta and (with dropout) the row hashes
//   mix32(h0 ^ query) through plain stores before arriving on the stage's
//   full mbarrier. Warpgroups 1 and 2 consume (setmaxnreg 240), 64 keys
//   each; dK and dV take 128 f32 registers a consumer thread;
// - shared memory: K and V (128 x 128 each) resident; Q and dO sub-tiles
//   (64 x 128 each) with their statistics in a ring of kStages stages,
//   walked from the causal diagonal down: 64 + 2 x 33 KB;
// - four wgmma products a sub-tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16,
//   both operands from shared memory, K-major), then P^T and dS^T, rounded
//   to bf16 in registers, are the register A operands of dV += P^T dO and
//   dK += dS^T Q (m64n128k16, dO and Q MN-major B operands from the same
//   tiles). A lane's accumulators hold 2 keys x 16 queries, so the dropout
//   mask is one mix32 of the staged row hash ^ key, one compare, an element;
// - a stage is released only after the wgmma reading it has retired;
// - no atomics: each (bh, key tile) has one owner, so dK and dV are
//   deterministic (bit-identical between a captured step and an eager one).
// dK, dV, S^T and dP^T take 192 registers at the 240-register cap; ptxas
// -v reports 40 bytes of spill at rate 0 (56 with dropout) and no
// serialized wgmma (C7512). A third Q/dO stage ran no faster on an H100.
#include "sm90.cuh"

namespace stf {
namespace {

using namespace sm90;

constexpr int kD = 128;
constexpr int kBN = 128;     // keys a block (64 a consumer warpgroup)
constexpr int kBM = 64;      // queries a sub-tile
constexpr int kStages = 2;   // Q/dO ring depth
constexpr int kThreads = 384;
constexpr uint32_t kKBox = kBN * 128;     // (128 keys, 64 columns)
constexpr uint32_t kKTile = 2 * kKBox;    // (128, 128) bf16
constexpr uint32_t kQBox = kBM * 128;     // (64 queries, 64 columns)
constexpr uint32_t kQTile = 2 * kQBox;    // (64, 128) bf16
constexpr uint32_t kStats = 1024;         // lse | delta | row hashes, 64 each
// k | v | q x kStages | do x kStages | stats x kStages | mbarriers, + 1024
// to align the base
constexpr int kSmemBytes = 2 * kKTile + kStages * (2 * kQTile + kStats) +
                           8 * (1 + 2 * kStages) + 1024;

template <bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int q_len, int kv_len, int H, float scale,
                           uint32_t seed, const uint32_t* seed_ptr,
                           uint32_t threshold, float inv_keep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = smem_base_1024(smem_raw);
  const uint32_t sv = sk + kKTile;
  const uint32_t sq = sv + kKTile;            // kStages
  const uint32_t sdo = sq + kStages * kQTile;  // kStages
  const uint32_t sst = sdo + kStages * kQTile;  // kStages
  const uint32_t bars = sst + kStages * kStats;
  // generic pointer of the stage-s statistics (plain loads and stores)
  unsigned char* const stats0 = smem_raw + (sst - smem_u32(smem_raw));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBN;  // key tile 0 (the most work) first
  // query sub-tiles from the diagonal (q_len == kv_len) down
  const int qs0 = kCausal ? k0 / kBM : 0;
  const int n_sub = cdiv(q_len, kBM) - qs0;
  const long long qo = static_cast<long long>(bh) * q_len;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
      const uint32_t h0 =
          kDropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKTile);
        tma_load_3d(sk, &tk, kv_full, 0, k0, bh);
        tma_load_3d(sk + kKBox, &tk, kv_full, 64, k0, bh);
        tma_load_3d(sv, &tv, kv_full, 0, k0, bh);
        tma_load_3d(sv + kKBox, &tv, kv_full, 64, k0, bh);
      }
      for (int i = 0; i < n_sub; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int q0 = (qs0 + i) * kBM;
        mbar_wait(empty(s), ph ^ 1);
        if (lane == 0) {
          const uint32_t qs = sq + s * kQTile, dos = sdo + s * kQTile;
          mbar_expect_tx(full(s), 2 * kQTile);
          tma_load_3d(qs, &tq, full(s), 0, q0, bh);
          tma_load_3d(qs + kQBox, &tq, full(s), 64, q0, bh);
          tma_load_3d(dos, &tdo, full(s), 0, q0, bh);
          tma_load_3d(dos + kQBox, &tdo, full(s), 64, q0, bh);
        }
        float* st = reinterpret_cast<float*>(stats0 + s * kStats);
#pragma unroll
        for (int r = lane; r < kBM; r += 32) {
          const int q = q0 + r;
          const bool ok = q < q_len;
          st[r] = ok ? __ldg(lse + qo + q) : 0.0f;
          st[kBM + r] = ok ? __ldg(delta + qo + q) : 0.0f;
          if (kDropout)
            reinterpret_cast<uint32_t*>(st)[2 * kBM + r] =
                mix32(h0 ^ static_cast<uint32_t>(q));
        }
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumers. Lane (g, t) of warp w holds accumulator elements (keys
  // 16w + g, 16w + g + 8 of the warpgroup's 64) x (columns 8j + 2t,
  // 8j + 2t + 1): queries of the sub-tile for S^T and dP^T (j < 8), head
  // dims for dK and dV (j < 16); element 4j + e, e < 2 on the lower key
  regs_inc<240>();
  const int cw = (threadIdx.x - 128) >> 7;  // 0, 1: keys 64 cw of the tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + cw * 64 + warp * 16 + g;
  const int key_hi = key_lo + 8;
  // bias * log2e of the lane's two keys (0 past kv_len: never stored)
  float bl_lo = 0.0f, bl_hi = 0.0f;
  if (bias != nullptr) {
    const float* bb = bias + static_cast<long long>(bh / H) * kv_len;
    if (key_lo < kv_len) bl_lo = __ldg(bb + key_lo) * kLog2e;
    if (key_hi < kv_len) bl_hi = __ldg(bb + key_hi) * kLog2e;
  }
  const float scale_l2 = scale * kLog2e;
  const uint32_t ka = sk + cw * 64 * 128, va = sv + cw * 64 * 128;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < n_sub; ++i) {
    const int s = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int q0 = (qs0 + i) * kBM;
    const uint32_t qs = sq + s * kQTile, dos = sdo + s * kQTile;
    const float* st = reinterpret_cast<const float*>(stats0 + s * kStats);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries a warpgroup)
    float sc[32], dp[32];
    const uint64_t dka = desc_here(desc_sw128(ka, 16, 1024));
    const uint64_t dva = desc_here(desc_sw128(va, 16, 1024));
    const uint64_t dqk = desc_here(desc_sw128(qs, 16, 1024));
    const uint64_t dok = desc_here(desc_sw128(dos, 16, 1024));
    mbar_wait(full(s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t ka_off = (kk >> 2) * kKBox + (kk & 3) * 32;
      const uint32_t qa_off = (kk >> 2) * kQBox + (kk & 3) * 32;
      wgmma_m64n64k16_ss(sc, desc_at(dka, ka_off), desc_at(dqk, qa_off), kk);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t ka_off = (kk >> 2) * kKBox + (kk & 3) * 32;
      const uint32_t qa_off = (kk >> 2) * kQBox + (kk & 3) * 32;
      wgmma_m64n64k16_ss(dp, desc_at(dva, ka_off), desc_at(dok, qa_off), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);

    // P^T (dropped) and dS^T as bf16 A fragments, one per 16 queries
    const bool edge = (kCausal && q0 < k0 + kBN) || q0 + kBM > q_len;
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;  // sub-tile column of e = 0 and 2
      const float2 l2 = *reinterpret_cast<const float2*>(st + c);
      const float2 d2 = *reinterpret_cast<const float2*>(st + kBM + c);
      const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
      const float dl[2] = {d2.x, d2.y};
      uint2 hq = make_uint2(0u, 0u);
      if (kDropout)
        hq = *reinterpret_cast<const uint2*>(st + 2 * kBM + c);
      float pc[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_lo : key_hi;
        const int query = q0 + c + (e & 1);
        float p = ex2(fmaf(sc[4 * j + e], scale_l2, nl[e & 1]) +
                      (e < 2 ? bl_lo : bl_hi));
        if (edge && !(query < q_len && (!kCausal || query >= key))) p = 0.0f;
        float dpv = dp[4 * j + e];
        pc[e] = p;
        if (kDropout) {
          const bool keep =
              mix32(((e & 1) ? hq.y : hq.x) ^ static_cast<uint32_t>(key)) <
              threshold;
          pc[e] = keep ? __fmul_rn(p, inv_keep) : 0.0f;
          dpv = keep ? __fmul_rn(dpv, inv_keep) : 0.0f;
        }
        dsv[e] = p * (dpv - dl[e & 1]) * scale;
      }
      pf[j / 2][(j & 1) * 2] = pack_bf16(pc[0], pc[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(pc[2], pc[3]);
      sf[j / 2][(j & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      sf[j / 2][(j & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dV += P^T dO, dK += dS^T Q: k-step kk takes queries 16 kk ..
    // 16 kk + 15 of the sub-tile
    const uint64_t dom = desc_here(desc_sw128(dos, kQBox, 1024));
    const uint64_t dqm = desc_here(desc_sw128(qs, kQBox, 1024));
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      wgmma_m64n128k16_rs(dv_acc, pf[kk], desc_at(dom, kk * 2048));
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk)
      wgmma_m64n128k16_rs(dk_acc, sf[kk], desc_at(dqm, kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

  // dK and dV as bf16 pairs, the keys below kv_len
  const long long ko = static_cast<long long>(bh) * kv_len;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    if (key_lo < kv_len) {
      const long long at = (ko + key_lo) * kD + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[4 * j], dk_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (key_hi < kv_len) {
      const long long at = (ko + key_hi) * kD + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

template <bool kCausal, bool kDropout>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo,
                   const float* lse, const float* delta, const float* bias,
                   bf16* dk, bf16* dv, int BH, int q_len, int kv_len, int H,
                   float scale, uint32_t seed, const uint32_t* seed_ptr,
                   uint32_t threshold, float inv_keep, cudaStream_t s) {
  auto kernel = flash_dkdv_sm90_kernel<kCausal, kDropout>;
  // on every launch: the attribute is per device
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(BH, cdiv(kv_len, kBN)), kThreads, kSmemBytes, s>>>(
      tq, tk, tv, tdo, lse, delta, bias, dk, dv, q_len, kv_len, H, scale,
      seed, seed_ptr, threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// Called by flash_attention.cu for bf16 dK/dV at D = 128: the arguments of
// stf_flash_attention_dkdv with q, k, v, dout, dk, dv bf16 (BH, S, 128).
cudaError_t flash_dkdv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* bias, void* dk,
                            void* dv, int BH, int q_len, int kv_len, int H,
                            float scale, int causal, int dropout,
                            uint32_t seed, const uint32_t* seed_ptr,
                            uint32_t threshold, float inv_keep,
                            cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = sm90::bhsd_map(&tq, q, BH, q_len, kBM);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tdo, dout, BH, q_len, kBM);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tk, k, BH, kv_len, kBN);
  if (e == cudaSuccess) e = sm90::bhsd_map(&tv, v, BH, kv_len, kBN);
  if (e != cudaSuccess) return e;
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
#define STF_SM90_LAUNCH(C, DR)                                              \
  return launch<C, DR>(tq, tk, tv, tdo, lse, delta, bias, dkp, dvp, BH,     \
                       q_len, kv_len, H, scale, seed, seed_ptr, threshold,  \
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
