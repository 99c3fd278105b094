// The bf16 FlashAttention backward on Hopper tensor cores: the ports of the
// TPU kernels simple_tensorflow_tpu/ops/pallas/flash_attention.py:
// _bwd_dkdv_kernel (:210, called at :352) and _bwd_dq_kernel (:264, called
// at :383) for bf16 inputs, dropout branches (:244-253, :297-301) included.
// flash_attention.cu routes every bf16 backward here and keeps its f32
// CUDA-core kernels for f32 inputs (TF32 would break the f32 training
// check's 1e-4 on the gradients).
//
// What they compute is flash_attention.cu's backward up to the summation
// order, the mask bit for bit, per head bh (bias row bh / H):
//   s = (q . k) * scale (+ bias[key]), masked where key >= kv_len or
//   (causal) key > query; p = exp(s - lse); dP = dO . V^T; with dropout
//   dP and the p of dV become keep ? x * inv_keep : 0, the mask K0
//   counter_keep(keep_hash0(seed, bh), global query, global key);
//   dV += p_dropped(bf16)^T . dO; dS = (p * (dP - delta) * scale)(bf16)
//   with the undropped p; dK += dS^T . Q; dQ += dS . K.
// The TPU kernels run bf16 x bf16 on the MXU with f32 accumulation; a bf16
// product is exact in f32, so mma.sync with f32 accumulators computes the
// same function.
//
// What bounds them on the card: at the training shape (256 heads of S=256,
// D=64, causal) dK/dV moves 50.9 MB (15.2 us at 3.35 TB/s) and dQ 42.5 MB
// (12.7 us) against 4.3 and 3.2 GFLOP of bf16 products (4.4 and 3.3 us at
// the dense peak): bytes, so every intermediate stays in registers and
// each input tile is read once a block. The design is flash_fwd_mma.cu's
// (mma.cuh: swizzled cp.async tiles, ldmatrix fragments), carried to the
// four products of the backward:
// - dK/dV: grid (B*H, key tiles), key tile 0 (under causal the one that
//   walks every query tile) first. Each of 4 warps owns 16 keys of the
//   block's 64; K and V stay in shared memory, Q and dO tiles (with lse,
//   delta and, with dropout, the 64 row hashes mix32(h0 ^ query)) stream
//   from the diagonal down, double-buffered. The warp computes S^T = K Q^T
//   and dP^T = V dO^T with K and V as A operands and Q and dO as B operands
//   through ldmatrix; P^T and dS^T, rounded to bf16 in registers, are the A
//   operands of dV += P^T dO and dK += dS^T Q, with dO and Q read as B
//   operands through ldmatrix.trans from the same tiles. A lane's
//   accumulators hold 2 keys x 16 queries, so the mask is one mix32 of the
//   staged row hash ^ key, one compare, an element.
// - dQ: grid (B*H, query tiles), the heaviest (last) query tile first, the
//   forward's layout: 16 query rows a warp, Q and dO as A operands, lse and
//   delta of the lane's two rows in registers, K/V tiles up to the diagonal
//   double-buffered; S = Q K^T, dP = dO V^T, and dS from registers into
//   dQ += dS K with K through ldmatrix.trans. The mask is the forward's:
//   mix32(mix32(h0 ^ row) ^ key) with the two row hashes held.
// - Each tile is walked in sub-steps of kSub = 32 columns, so S and dP take
//   16 + 16 f32 registers a lane beside the accumulators (dK + dV: 64 at
//   D = 64, 128 at D = 128).
// - exp is ex2(s * scale * log2e - lse * log2e) on the special-function
//   unit; P and dS round to nearest-even bf16 where the TPU kernels cast.
// - causal and dropout are template parameters (the rate-0 kernels carry
//   no dropout code); only the diagonal tile and a ragged last tile are
//   masked. Rows past q_len / kv_len are zero-filled by cp.async and never
//   stored.
// - Two kernels and no atomics: each output tile has one owner, so the
//   gradients are deterministic, as the two Pallas calls are.
#include "mma.cuh"

namespace stf {
namespace {

constexpr int kSub = 32;  // columns of a tile a sub-step (n-tiles: 4)

// q | do (dK/dV: two stages each) and k | v (dQ: two stages each), bf16
template <int D>
constexpr int bwd_tiles_bytes() {
  return 6 * kTile * D * static_cast<int>(sizeof(bf16));
}

// dK/dV also stage lse, delta and the row hashes of each Q tile, two stages
template <int D>
constexpr int dkdv_smem_bytes() {
  return bwd_tiles_bytes<D>() + 2 * 3 * kTile * 4;
}

// blocks an SM must hold: 3 at D <= 64 caps a thread at 168 registers
// (dK + dV take 64 of them), 2 at D = 128 (128 for dK + dV)
template <int D>
constexpr int dkdv_min_blocks() {
  return D <= 64 ? 3 : 2;
}

// dQ holds one accumulator: the forward's 4 blocks (128 registers) at
// D <= 64
template <int D>
constexpr int dq_min_blocks() {
  return D <= 64 ? 4 : 2;
}

// Lane (g, t) = (lane / 4, lane % 4) holds accumulator elements (rows g and
// g + 8 of its warp's 16) x (columns 2t, 2t + 1 of every 8-column n-tile);
// here the rows are keys and the columns queries.
template <int D, bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads, dkdv_min_blocks<D>())
    flash_bwd_dkdv_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ bias, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int q_len, int kv_len, int H, float scale,
        uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold, float inv_keep) {
  constexpr int KS = D / 16;    // k-steps of S^T, dP^T; d n-tile pairs
  constexpr int NT = kSub / 8;  // query n-tiles a sub-step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_sh = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_sh = k_sh + kTile * D;
  bf16* q_sh = v_sh + kTile * D;        // two stages
  bf16* do_sh = q_sh + 2 * kTile * D;   // two stages
  float* lse_sh = reinterpret_cast<float*>(do_sh + 2 * kTile * D);
  float* delta_sh = lse_sh + 2 * kTile;  // two stages each
  uint32_t* hq_sh = reinterpret_cast<uint32_t*>(delta_sh + 2 * kTile);

  const int bh = blockIdx.x;
  const int ki = blockIdx.y;
  const int k0 = ki * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + warp * 16 + g;  // global keys of c[0..1], c[2..3]
  const int key_hi = key_lo + 8;

  const long long qo = static_cast<long long>(bh) * q_len;
  const long long ko = static_cast<long long>(bh) * kv_len;
  const bf16* qb = q + qo * D;
  const bf16* dob = dout + qo * D;
  // bias * log2e of the lane's two keys (0 past kv_len: never stored)
  float bl_lo = 0.0f, bl_hi = 0.0f;
  if (bias != nullptr) {
    const float* bb = bias + static_cast<long long>(bh / H) * kv_len;
    if (key_lo < kv_len) bl_lo = __ldg(bb + key_lo) * kLog2e;
    if (key_hi < kv_len) bl_hi = __ldg(bb + key_hi) * kLog2e;
  }
  const uint32_t h0 = kDropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
  const float scale_l2 = scale * kLog2e;

  // Q, dO, lse, delta of query tile qt into stage st (one commit group);
  // the row hashes by plain stores, seen after the next barrier
  auto load_queries = [&](int qt, int st) {
    const int q0 = qt * kTile;
    load_tile<D>(q_sh + st * kTile * D, qb, q0, q_len);
    load_tile<D>(do_sh + st * kTile * D, dob, q0, q_len);
    const int r = threadIdx.x & (kTile - 1);
    const bool ok = q0 + r < q_len;
    const bool is_lse = threadIdx.x < kTile;
    cp_async4((is_lse ? lse_sh : delta_sh) + st * kTile + r,
              (is_lse ? lse : delta) + qo + (ok ? q0 + r : 0), ok);
    cp_async_commit();
    if (kDropout && is_lse) hq_sh[st * kTile + r] = mix32(h0 ^ (q0 + r));
  };

  const int n_qt = cdiv(q_len, kTile);
  const int qt0 = kCausal ? ki : 0;  // the diagonal (q_len == kv_len)
  load_tile<D>(k_sh, k + ko * D, k0, kv_len);
  load_tile<D>(v_sh, v + ko * D, k0, kv_len);
  load_queries(qt0, 0);  // one group with K and V

  // A-operand rows of ldmatrix: the warp's 16 keys of K and V
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;

  float dk_acc[2 * KS][4], dv_acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qt landed; every warp is done with qt - 1
    if (qt + 1 < n_qt) load_queries(qt + 1, st ^ 1);
    const bf16* qs = q_sh + st * kTile * D;
    const bf16* dos = do_sh + st * kTile * D;
    const float* ls = lse_sh + st * kTile;
    const float* ds = delta_sh + st * kTile;
    const uint32_t* hs = hq_sh + st * kTile;
    const int q0 = qt * kTile;
    const bool edge = (kCausal && qt == ki) || q0 + kTile > q_len;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kSub) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kSub queries a warp
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, k_sh + swz<D>(a_row, kk * 2 + (lane >> 4)));
        ldsm_x4(vf, v_sh + swz<D>(a_row, kk * 2 + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int br = c0 + np * 16 + (lane & 7) + (lane >> 4) * 8;
          const int bc = kk * 2 + ((lane >> 3) & 1);
          uint32_t b[4];
          ldsm_x4(b, qs + swz<D>(br, bc));
          mma_bf16(s[2 * np], kf, b[0], b[1]);
          mma_bf16(s[2 * np + 1], kf, b[2], b[3]);
          ldsm_x4(b, dos + swz<D>(br, bc));
          mma_bf16(dp[2 * np], vf, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], vf, b[2], b[3]);
        }
      }

      // P^T (dropped) and dS^T as bf16 A fragments, one per 16 queries
      uint32_t pf[NT / 2][4], sf[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = c0 + n * 8 + 2 * t;  // tile column of e = 0 and 2
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
        uint2 hq = make_uint2(0u, 0u);
        if (kDropout) hq = *reinterpret_cast<const uint2*>(hs + c);
        float pc[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_lo : key_hi;
          const int query = q0 + c + (e & 1);
          float p = ex2(fmaf(s[n][e], scale_l2, nl[e & 1]) +
                        (e < 2 ? bl_lo : bl_hi));
          if (edge && !(query < q_len && (!kCausal || query >= key)))
            p = 0.0f;
          float dpv = dp[n][e];
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
        pf[n / 2][(n & 1) * 2] = pack_bf16(pc[0], pc[1]);
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(pc[2], pc[3]);
        sf[n / 2][(n & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
        sf[n / 2][(n & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dV += P^T dO, dK += dS^T Q: dO and Q by ldmatrix.trans, two d
      // n-tiles a load
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
        for (int dp2 = 0; dp2 < KS; ++dp2) {
          const int br = c0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int bc = dp2 * 2 + (lane >> 4);
          uint32_t b[4];
          ldsm_x4_trans(b, dos + swz<D>(br, bc));
          mma_bf16(dv_acc[2 * dp2], pf[kc], b[0], b[1]);
          mma_bf16(dv_acc[2 * dp2 + 1], pf[kc], b[2], b[3]);
          ldsm_x4_trans(b, qs + swz<D>(br, bc));
          mma_bf16(dk_acc[2 * dp2], sf[kc], b[0], b[1]);
          mma_bf16(dk_acc[2 * dp2 + 1], sf[kc], b[2], b[3]);
        }
      }
    }
  }

  // dK and dV through the warp's own K and V rows (read only by this warp)
  store_rows<D>(k_sh, warp * 16, dk_acc, dk + ko * D, k0 + warp * 16,
                kv_len);
  store_rows<D>(v_sh, warp * 16, dv_acc, dv + ko * D, k0 + warp * 16,
                kv_len);
}

// Rows are queries and columns keys, as in the forward.
template <int D, bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads, dq_min_blocks<D>())
    flash_bwd_dq_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ bias, bf16* __restrict__ dq, int q_len,
        int kv_len, int H, float scale, uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
        float inv_keep) {
  constexpr int KS = D / 16;    // k-steps of S, dP; d n-tile pairs of dQ
  constexpr int NT = kSub / 8;  // key n-tiles a sub-step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_sh = q_sh + kTile * D;
  bf16* k_sh = do_sh + kTile * D;      // two stages
  bf16* v_sh = k_sh + 2 * kTile * D;   // two stages

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + warp * 16 + g;  // global rows of c[0..1], c[2..3]
  const int row_hi = row_lo + 8;

  const long long qo = static_cast<long long>(bh) * q_len;
  const long long ko = static_cast<long long>(bh) * kv_len;
  const bf16* kb = k + ko * D;
  const bf16* vb = v + ko * D;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  int n_kt = cdiv(kv_len, kTile);
  if (kCausal) n_kt = min(n_kt, qi + 1);  // the `live` tiles

  load_tile<D>(q_sh, q + qo * D, q0, q_len);
  load_tile<D>(do_sh, dout + qo * D, q0, q_len);
  load_tile<D>(k_sh, kb, 0, kv_len);
  load_tile<D>(v_sh, vb, 0, kv_len);
  cp_async_commit();

  // -lse * log2e and delta of the lane's two rows (0 past q_len: never
  // stored), read while the tiles are in flight
  float nl_lo = 0.0f, nl_hi = 0.0f, dl_lo = 0.0f, dl_hi = 0.0f;
  if (row_lo < q_len) {
    nl_lo = -__ldg(lse + qo + row_lo) * kLog2e;
    dl_lo = __ldg(delta + qo + row_lo);
  }
  if (row_hi < q_len) {
    nl_hi = -__ldg(lse + qo + row_hi) * kLog2e;
    dl_hi = __ldg(delta + qo + row_hi);
  }
  uint32_t hr_lo = 0u, hr_hi = 0u;  // the two row hashes of K0
  if (kDropout) {
    const uint32_t h0 = keep_hash0(dropout_seed(seed, seed_ptr), bh);
    hr_lo = mix32(h0 ^ static_cast<uint32_t>(row_lo));
    hr_hi = mix32(h0 ^ static_cast<uint32_t>(row_hi));
  }
  const float scale_l2 = scale * kLog2e;

  // A-operand rows of ldmatrix: the warp's 16 rows of Q and dO
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
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
    const bool edge = (kCausal && kt == qi) || k0 + kTile > kv_len;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kSub) {
      // S = Q K^T and dP = dO V^T: 16 rows x kSub keys a warp
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4], of[4];
        ldsm_x4(qf, q_sh + swz<D>(a_row, kk * 2 + (lane >> 4)));
        ldsm_x4(of, do_sh + swz<D>(a_row, kk * 2 + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int br = c0 + np * 16 + (lane & 7) + (lane >> 4) * 8;
          const int bc = kk * 2 + ((lane >> 3) & 1);
          uint32_t b[4];
          ldsm_x4(b, ks + swz<D>(br, bc));
          mma_bf16(s[2 * np], qf, b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf, b[2], b[3]);
          ldsm_x4(b, vs + swz<D>(br, bc));
          mma_bf16(dp[2 * np], of, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], of, b[2], b[3]);
        }
      }

      // dS as bf16 A fragments, one per 16 keys
      uint32_t sf[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_lo : row_hi;
          const int col = k0 + c0 + n * 8 + 2 * t + (e & 1);
          float x = fmaf(s[n][e], scale_l2, e < 2 ? nl_lo : nl_hi);
          if (bb != nullptr && col < kv_len)
            x = fmaf(__ldg(bb + col), kLog2e, x);
          float p = ex2(x);
          if (edge && !(col < kv_len && (!kCausal || row >= col))) p = 0.0f;
          float dpv = dp[n][e];
          if (kDropout) {
            const bool keep =
                mix32((e < 2 ? hr_lo : hr_hi) ^ static_cast<uint32_t>(col)) <
                threshold;
            dpv = keep ? __fmul_rn(dpv, inv_keep) : 0.0f;
          }
          dsv[e] = p * (dpv - (e < 2 ? dl_lo : dl_hi)) * scale;
        }
        sf[n / 2][(n & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
        sf[n / 2][(n & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dQ += dS K: K by ldmatrix.trans, two d n-tiles a load
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
        for (int dp2 = 0; dp2 < KS; ++dp2) {
          uint32_t b[4];
          ldsm_x4_trans(b, ks + swz<D>(c0 + kc * 16 + (lane & 7) +
                                           ((lane >> 3) & 1) * 8,
                                       dp2 * 2 + (lane >> 4)));
          mma_bf16(acc[2 * dp2], sf[kc], b[0], b[1]);
          mma_bf16(acc[2 * dp2 + 1], sf[kc], b[2], b[3]);
        }
      }
    }
  }

  // dQ through the warp's own Q rows (read only by this warp)
  store_rows<D>(q_sh, warp * 16, acc, dq + qo * D, q0 + warp * 16, q_len);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  bf16 *dq, *dk, *dv;
  int BH, q_len, kv_len, H;
  float scale;
  int causal, dropout;
  uint32_t seed;
  const uint32_t* seed_ptr;  // null: the launch argument `seed`
  uint32_t threshold;
  float inv_keep;
  cudaStream_t s;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D, bool kCausal, bool kDropout>
cudaError_t launch_bwd(bool dkdv, const BwdArgs& a) {
  const dim3 grid(a.BH, cdiv(dkdv ? a.kv_len : a.q_len, kTile));
  if (dkdv) {
    constexpr int smem = dkdv_smem_bytes<D>();
    auto kernel = flash_bwd_dkdv_mma_kernel<D, kCausal, kDropout>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kMmaThreads, smem, a.s>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dk, a.dv, a.q_len,
        a.kv_len, a.H, a.scale, a.seed, a.seed_ptr, a.threshold, a.inv_keep);
  } else {
    constexpr int smem = bwd_tiles_bytes<D>();
    auto kernel = flash_bwd_dq_mma_kernel<D, kCausal, kDropout>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kMmaThreads, smem, a.s>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dq, a.q_len,
        a.kv_len, a.H, a.scale, a.seed, a.seed_ptr, a.threshold, a.inv_keep);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t by_flags(bool dkdv, const BwdArgs& a) {
  if (a.causal) {
    if (a.dropout) return launch_bwd<D, true, true>(dkdv, a);
    return launch_bwd<D, true, false>(dkdv, a);
  }
  if (a.dropout) return launch_bwd<D, false, true>(dkdv, a);
  return launch_bwd<D, false, false>(dkdv, a);
}

cudaError_t by_dim(bool dkdv, int D, const BwdArgs& a) {
  switch (D) {
    case 16: return by_flags<16>(dkdv, a);
    case 32: return by_flags<32>(dkdv, a);
    case 64: return by_flags<64>(dkdv, a);
    case 128: return by_flags<128>(dkdv, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Called by flash_attention.cu for bf16 backwards: dK, dV when `dkdv`,
// else dQ, with the arguments of stf_flash_attention_dkdv / _dq (q, k, v,
// dout and the outputs bf16; the unused outputs null).
cudaError_t flash_bwd_bf16_mma(int dkdv, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               const float* bias, void* dq, void* dk,
                               void* dv, int BH, int q_len, int kv_len, int H,
                               int D, float scale, int causal, int dropout,
                               uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                               float inv_keep, cudaStream_t s) {
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  lse, delta, bias, static_cast<bf16*>(dq),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, q_len,
                  kv_len, H, scale, causal, dropout, seed, seed_ptr, threshold,
                  inv_keep, s};
  return by_dim(dkdv != 0, D, a);
}

}  // namespace stf
