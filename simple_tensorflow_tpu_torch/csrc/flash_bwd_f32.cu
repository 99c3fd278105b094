// The f32 FlashAttention backward on the CUDA cores: the port of the TPU
// kernels simple_tensorflow_tpu/ops/pallas/flash_attention.py:
// _bwd_dkdv_kernel (:210, called at :352) and _bwd_dq_kernel (:264, called
// at :383) for f32 inputs at D in {16, 32, 64, 128}, causal or not, with a
// (B, kv_len) key bias or without, dropout branch included.
// flash_attention.cu routes every f32 dK/dV and dQ here (the f32 forward is
// flash_fwd_f32.cu; bf16 runs on tensor cores).
//
// What it computes (flash_attention_dkdv_plain / _dq_plain in
// ops/kernels/flash_attention.py state it), for query q and key k of head
// bh: s = (q . k) * scale (+ bias[b, k]), then NEG_INF where k >= kv_len,
// q >= q_len or (causal) k > q (the bias before the mask); p = exp(s -
// lse[q]); dP = dO[q] . V[k]; with dropout (K0 counter_keep of
// (keep_hash0(seed, bh), GLOBAL q, GLOBAL k), the forward's mask
// regenerated) p' = keep ? p * inv_keep : 0 and dP' = keep ? dP * inv_keep
// : 0, else p' = p, dP' = dP; dS = p * (dP' - delta[q]) * scale with the
// undropped p; dV[k] = sum_q p' dO[q], dK[k] = sum_q dS Q[q], dQ[q] =
// sum_k dS K[k]. delta comes from the caller. Every dot product and every
// sum is a chain of exact f32 FMAs on the CUDA cores: TF32 fails the f32
// checks (1e-5 on the loss, 1e-4 on the gradients).
//
// What bounds it on the card: operations (4 D FMAs a live pair in dK/dV, 3
// D in dQ; at the training checks' 256 heads of S = 256, D = 64, causal,
// 4.3 and 3.2 GFLOP: 64 and 48 us at 67 TFLOP/s), fed from shared memory.
// The kernels this file replaces (in flash_attention.cu) reached 23% of
// that: they copied a float a thread between barriers, read 2 shared
// words for each 4 FMAs through an odd row stride, and gave each causal
// block a different length of work. What sets the rate of the product
// loops is the shared-memory words a thread loads for each FMA (an SM's
// shared memory delivers 128 bytes a clock to 128 FMA lanes: at 0.5 words
// a FMA a loop reaches at most half the FMA rate) and the warps an SM
// keeps; a sweep of the tile shapes moved nothing else (not the epilogue,
// its expf, or loop unrolling). So a thread's patches are as large as its
// registers allow for both products, and one kernel body serves both (a
// "row" is a resident key in dK/dV and a resident query in dQ; a "column"
// is a streamed query or key):
// - a block owns BR rows (K and V, or Q and dO) for its whole walk and
//   streams 32-row tiles of the other pair (Q and dO, or K and V) through
//   a ring of two stages of 16-byte cp.async copies, each thread copying
//   the same chunk of fixed rows: tile t + 1 lands while tile t's products
//   run (one stage where the walk has a single tile). Rows sit in shared
//   memory at a stride of D + 4 floats;
// - BR / 16 warps stacked along the rows, each of 4 row groups x 8 column
//   groups: thread (rg, cg) of warp w owns rows 16 w + rg + 4 i and
//   columns cg + 8 j (i, j < 4) of the (BR, 32) score tile, so each float4
//   a warp reads of a row tile is 4 distinct rows and of a column tile 8
//   (no bank conflict). S and dP of the 4 x 4 patch come from one pass over
//   d: 16 float4 loads for 128 FMAs;
// - p' and dS go to shared memory once a tile, (BR, 32) at a stride of 40
//   floats (the scalar stores fall in 32 distinct banks), and the output
//   products read them back as float4s along the columns: thread (rg, cg)
//   owns rows 16 w + rg + 4 i and the D / 8 output columns of group cg (4
//   x 8 sums a product at D = 64, in registers for the whole walk): 8 + 4
//   D / 32 loads for 32 D FMAs in dK/dV;
// - BR = 64 in dK/dV and in dQ at D = 128, 32 in dQ below, halved down to
//   16 where the blocks would not fill the card (flash_attention.
//   bwd_tile_f32 states the rule). A sweep on the H100 (2 x 2 warps, 8
//   rows or 8 columns a thread, 64-row streamed tiles, 16 to 128 rows a
//   block) found none faster at the paths' shapes;
// - causal: dK/dV walks the query tiles from the diagonal down, dQ the key
//   tiles up to it; the blocks with the longest walks launch first (key
//   tile 0 of dK/dV, the last query tile of dQ); a warp whose whole patch
//   is masked skips its products, and the output products skip the
//   columns no row of the warp sees (exact: their p' and dS are 0, unless
//   an lse is about NEG_INF, where nothing is skipped);
// - no atomics, no split over the walk: each output row has one owner, so
//   two launches give the same bits (a captured graph equals eager
//   dispatch). Ragged S is masked in the kernel: rows past S load zeros
//   and are never stored.
#include <type_traits>

#include "f32_tile.cuh"

namespace stf {
namespace {

// The thread tile (file note): TM rows by TN columns of the score tile a
// thread, warps of 4 row groups by 8 column groups stacked along the rows,
// BS streamed rows a tile
constexpr int kBwdTM = 4, kBwdTN = 4, kBwdBS = 32;
// the blocks below which the host halves the rows a block (ops/kernels/
// flash_attention.py bwd_tile_f32 states the rule)
constexpr int kBwdFill = 128;

// rows a | (row tile, its pair) | (column tile, its pair) x stages | dS |
// p' (dK/dV only), rows padded by 4 or 8 floats
template <int D>
constexpr int bwd_smem_floats(int br, int stages, bool dkdv) {
  return 2 * br * (D + 4) + 2 * stages * kBwdBS * (D + 4) +
         (dkdv ? 2 : 1) * br * (kBwdBS + 8);
}

// lse at or below this marks a row whose every score was about NEG_INF (a
// NEG_INF-sized key bias): there exp(NEG_INF - lse) of a masked pair is
// not 0, so masked pairs are not skipped
constexpr float kLseLive = -1e29f;

// The body of both kernels: grid (B*H, row tiles), WR warps of 4 row
// groups x 8 column groups (file note). dK/dV (kDkdv): rows are keys
// (resident K, V), columns queries (streamed Q, dO); out0 = dK, out1 = dV.
// dQ: rows are queries (resident Q, dO), columns keys (streamed K, V);
// out0 = dQ.
template <int D, int WR, bool kDkdv>
__device__ __forceinline__ void flash_bwd_f32_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out0,
    float* __restrict__ out1, int q_len, int kv_len, int H, float scale,
    int causal, int stages, int dropout, uint32_t seed,
    const uint32_t* seed_ptr, uint32_t threshold, float inv_keep) {
  constexpr int TM = kBwdTM, TN = kBwdTN;
  constexpr int NT = 32 * WR;
  constexpr int BR = 4 * TM * WR;  // rows a block
  constexpr int BS = kBwdBS;       // columns a streamed tile
  constexpr int G = 8;             // output column groups: cg
  constexpr int DS = D + 4;        // row stride of the row and column tiles
  constexpr int MS = BS + 8;       // row stride of dS and p'
  constexpr int CW = D / G;        // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* ra_sh = smem;              // K (dK/dV) or Q (dQ)
  float* rb_sh = ra_sh + BR * DS;   // V or dO
  float* ring = rb_sh + BR * DS;    // stage st: (Q, dO) or (K, V)
  float* ds_sh = ring + 2 * stages * BS * DS;
  float* p_sh = ds_sh + BR * MS;    // dK/dV only

  const int bh = blockIdx.x;
  // the longest causal walks first: key tile 0 of dK/dV, the last query
  // tile of dQ
  const int r0 = (kDkdv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane & 3, cg = lane >> 2;
  const int row_w = warp * 4 * TM;  // the warp's first row
  const int row_l = row_w + rg;     // the thread's rows: + 4 i
  const int n_rows = kDkdv ? kv_len : q_len;
  const int n_cols = kDkdv ? q_len : kv_len;
  const long long ro = static_cast<long long>(bh) * n_rows;
  const long long co = static_cast<long long>(bh) * n_cols;
  // S = ra . ca, dP = rb . cb
  const float* ra = (kDkdv ? k : q) + ro * D;
  const float* rb = (kDkdv ? v : dout) + ro * D;
  const float* ca = (kDkdv ? q : k) + co * D;
  const float* cb = (kDkdv ? dout : v) + co * D;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  int t0 = 0, n_t = cdiv(n_cols, BS);
  if (causal) {
    if (kDkdv)
      t0 = r0 / BS;  // the first query tile with a query >= the block's keys
    else
      n_t = min(n_t, cdiv(r0 + BR, BS));  // the key tiles up to the diagonal
  }
  auto stage_cols = [&](int t, int st) {
    float* s0 = ring + st * 2 * BS * DS;
    stage_tile<D, NT, BS>(s0, ca, t * BS, n_cols);
    stage_tile<D, NT, BS>(s0 + BS * DS, cb, t * BS, n_cols);
    cp_async_commit();
  };
  stage_tile<D, NT, BR>(ra_sh, ra, r0, n_rows);
  stage_tile<D, NT, BR>(rb_sh, rb, r0, n_rows);
  if (t0 < n_t)
    stage_cols(t0, 0);  // in one copy group with the row tiles
  else
    cp_async_commit();

  const uint32_t h0 =
      dropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
  // the rows' own statistics: the key bias (dK/dV), lse and delta (dQ)
  float r_bias[TM], r_lse[TM], r_delta[TM];
  bool live = true;  // every lse this thread reads is above kLseLive
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + row_l + 4 * i;
    r_bias[i] = r_lse[i] = r_delta[i] = 0.0f;
    if (kDkdv && bb != nullptr && row < kv_len) r_bias[i] = __ldg(bb + row);
    if (!kDkdv && row < q_len) {
      r_lse[i] = __ldg(lse + ro + row);
      r_delta[i] = __ldg(delta + ro + row);
      live = live && r_lse[i] > kLseLive;
    }
  }
  float acc0[TM][CW], acc1[TM][CW];  // dK and dV, or dQ
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc0[i][c] = acc1[i][c] = 0.0f;

  for (int t = t0; t < n_t; ++t) {
    const int st = stages == 2 ? (t - t0) & 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's products are done
    if (t + 1 < n_t) stage_cols(t + 1, st ^ 1);
    const float* ca_sh = ring + st * 2 * BS * DS;
    const float* cb_sh = ca_sh + BS * DS;
    const int c0 = t * BS;

    // the columns' own statistics: lse and delta (dK/dV), the key bias
    // (dQ)
    float c_bias[TN], c_lse[TN], c_delta[TN];
    bool tile_live = live;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + cg + 8 * j;
      c_bias[j] = c_lse[j] = c_delta[j] = 0.0f;
      if (kDkdv && col < q_len) {
        c_lse[j] = __ldg(lse + co + col);
        c_delta[j] = __ldg(delta + co + col);
        tile_live = tile_live && c_lse[j] > kLseLive;
      }
      if (!kDkdv && bb != nullptr && col < kv_len) c_bias[j] = __ldg(bb + col);
    }
    // causal: a warp whose pairs are all masked (every key past every
    // query) skips its products; its p is exp(NEG_INF - lse) = 0 unless a
    // row's lse is about NEG_INF
    const int kmin = kDkdv ? r0 + row_w : c0;
    const int qmax = kDkdv ? c0 + BS - 1 : r0 + row_w + 4 * TM - 1;
    const bool skip = causal && kmin > qmax &&
                      __all_sync(0xffffffffu, tile_live);

    // S and dP of the thread's TM x TN patch, one pass over d
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.0f;
    if (!skip) {
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 ya[TN], yb[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ya[j] = *reinterpret_cast<const float4*>(ca_sh + (cg + 8 * j) * DS + d);
          yb[j] = *reinterpret_cast<const float4*>(cb_sh + (cg + 8 * j) * DS + d);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 xa = *reinterpret_cast<const float4*>(ra_sh + (row_l + 4 * i) * DS + d);
          const float4 xb = *reinterpret_cast<const float4*>(rb_sh + (row_l + 4 * i) * DS + d);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fma4(xa, ya[j], s[i][j]);
            dp[i][j] = fma4(xb, yb[j], dp[i][j]);
          }
        }
      }
    }

    // scale, the bias before the mask (0 where there is none: x + 0 is x),
    // p, the dropout mask, dS; p' and dS to shared memory. A tile inside
    // both lengths and (causal) below the diagonal masks nothing
    const bool inside =
        c0 + BS <= n_cols && r0 + BR <= n_rows &&
        (!causal || (kDkdv ? c0 >= r0 + BR - 1 : r0 >= c0 + BS - 1));
    auto epilogue = [&](auto drop) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = r0 + row_l + 4 * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = c0 + cg + 8 * j;
          const int kg = kDkdv ? row : col, qg = kDkdv ? col : row;
          float x = __fmul_rn(s[i][j], scale) + (kDkdv ? r_bias[i] : c_bias[j]);
          if (!inside) {
            const bool ok =
                kg < kv_len && qg < q_len && (!causal || qg >= kg);
            x = ok ? x : kNegInf;
          }
          const float p = expf(x - (kDkdv ? c_lse[j] : r_lse[i]));
          float pc = p, dpv = dp[i][j];
          if constexpr (decltype(drop)::value) {
            const bool keep = counter_keep(h0, qg, kg, threshold);
            pc = keep ? __fmul_rn(p, inv_keep) : 0.0f;
            dpv = keep ? __fmul_rn(dpv, inv_keep) : 0.0f;
          }
          const int at = (row_l + 4 * i) * MS + cg + 8 * j;
          ds_sh[at] = p * (dpv - (kDkdv ? c_delta[j] : r_delta[i])) * scale;
          if (kDkdv) p_sh[at] = pc;
        }
      }
    };
    if (dropout)
      epilogue(std::true_type{});
    else
      epilogue(std::false_type{});
    // dS and p' of the whole tile are in shared memory; is every lse of
    // the tile above kLseLive (then masked pairs hold p' = dS = 0)
    const bool all_live = __syncthreads_and(tile_live);

    // dK/dV: dK[row] += dS[row][c] Q[c], dV[row] += p'[row][c] dO[c];
    // dQ: dQ[row] += dS[row][c] K[c]; 4 columns at a time (past n_cols the
    // column rows are zero). Causal: only the columns a row of the warp
    // can see (the queries from its first key, the keys up to its last
    // query)
    int c_lo = 0, c_hi = BS;
    if (causal && all_live) {
      if (kDkdv)
        c_lo = min(BS, max(0, r0 + row_w - c0)) & ~3;
      else
        c_hi = (min(BS, max(0, r0 + row_w + 4 * TM - c0)) + 3) & ~3;
    }
#pragma unroll 2
    for (int c = c_lo; c < c_hi; c += 4) {
      float4 m0[TM], m1[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        m0[i] = *reinterpret_cast<const float4*>(ds_sh + (row_l + 4 * i) * MS + c);
        if (kDkdv)
          m1[i] = *reinterpret_cast<const float4*>(p_sh + (row_l + 4 * i) * MS + c);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ya[CW], yb[CW];
        group_cols<D, G>(ca_sh + (c + e) * DS, cg, ya);
        if (kDkdv) group_cols<D, G>(cb_sh + (c + e) * DS, cg, yb);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float w0 = lane4(m0[i], e);
#pragma unroll
          for (int cc = 0; cc < CW; ++cc)
            acc0[i][cc] = fmaf(w0, ya[cc], acc0[i][cc]);
          if (kDkdv) {
            const float w1 = lane4(m1[i], e);
#pragma unroll
            for (int cc = 0; cc < CW; ++cc)
              acc1[i][cc] = fmaf(w1, yb[cc], acc1[i][cc]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // a walk of no tile leaves the row copies pending

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + row_l + 4 * i;
    if (row >= n_rows) continue;
    store_group_cols<D, G>(out0 + (ro + row) * D, cg, acc0[i]);
    if (kDkdv) store_group_cols<D, G>(out1 + (ro + row) * D, cg, acc1[i]);
  }
}

template <int D, int WR>
__global__ void __launch_bounds__(32 * WR)
    flash_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int q_len, int kv_len, int H, float scale,
                          int causal, int stages, int dropout, uint32_t seed,
                          const uint32_t* seed_ptr, uint32_t threshold,
                          float inv_keep) {
  flash_bwd_f32_body<D, WR, true>(q, k, v, dout, lse, delta, bias, dk, dv,
                                  q_len, kv_len, H, scale, causal, stages,
                                  dropout, seed, seed_ptr, threshold,
                                  inv_keep);
}

template <int D, int WR>
__global__ void __launch_bounds__(32 * WR)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        float* __restrict__ dq, float* __restrict__ unused,
                        int q_len, int kv_len, int H, float scale, int causal,
                        int stages, int dropout, uint32_t seed,
                        const uint32_t* seed_ptr, uint32_t threshold,
                        float inv_keep) {
  flash_bwd_f32_body<D, WR, false>(q, k, v, dout, lse, delta, bias, dq,
                                   unused, q_len, kv_len, H, scale, causal,
                                   stages, dropout, seed, seed_ptr,
                                   threshold, inv_keep);
}

struct BwdF32Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *out0, *out1;  // dK and dV, or dQ
  int BH, q_len, kv_len, H;
  float scale;
  int causal, dropout;
  uint32_t seed;
  const uint32_t* seed_ptr;
  uint32_t threshold;
  float inv_keep;
  cudaStream_t s;
};

template <int D, int WR, bool kDkdv>
cudaError_t launch_bwd_f32(const BwdF32Args& a) {
  constexpr int BR = 16 * WR;
  const int n_rows = kDkdv ? a.kv_len : a.q_len;
  // one stage where the walk has a single tile
  const int stages = cdiv(kDkdv ? a.q_len : a.kv_len, kBwdBS) > 1 ? 2 : 1;
  const size_t smem = bwd_smem_floats<D>(BR, stages, kDkdv) * sizeof(float);
  auto kernel =
      kDkdv ? flash_dkdv_f32_kernel<D, WR> : flash_dq_f32_kernel<D, WR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.BH, cdiv(n_rows, BR)), 32 * WR, smem, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.out0, a.out1,
      a.q_len, a.kv_len, a.H, a.scale, a.causal, stages, a.dropout, a.seed,
      a.seed_ptr, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <bool kDkdv, int D>
cudaError_t launch_bwd_f32_rows(int br, const BwdF32Args& a) {
  if (br == 64) return launch_bwd_f32<D, 4, kDkdv>(a);
  if (br == 32) return launch_bwd_f32<D, 2, kDkdv>(a);
  return launch_bwd_f32<D, 1, kDkdv>(a);
}

template <bool kDkdv>
cudaError_t launch_bwd_f32_d(int D, int br, const BwdF32Args& a) {
  switch (D) {
    case 16: return launch_bwd_f32_rows<kDkdv, 16>(br, a);
    case 32: return launch_bwd_f32_rows<kDkdv, 32>(br, a);
    case 64: return launch_bwd_f32_rows<kDkdv, 64>(br, a);
    case 128: return launch_bwd_f32_rows<kDkdv, 128>(br, a);
    default: return cudaErrorInvalidValue;
  }
}

// The rows a block of the f32 dK/dV (dkdv != 0; rows are keys) or dQ (rows
// are queries) for B*H heads of n_rows rows at head dim D: 64 for dK/dV
// and for dQ at D = 128, 32 for dQ below, halved while the blocks would
// not reach kBwdFill, down to 16.
int flash_bwd_f32_rows(int dkdv, int BH, int n_rows, int D) {
  int rows = dkdv || D == 128 ? 64 : 32;
  while (rows > 16 &&
         static_cast<long long>(cdiv(n_rows, rows)) * BH < kBwdFill)
    rows /= 2;
  return rows;
}

}  // namespace

// dK/dV (dkdv != 0: dk, dv written) or dQ (dq written). q (BH, q_len, D),
// k/v (BH, kv_len, D), dout like q, lse and delta (BH, q_len), all f32;
// bias (B, kv_len) f32 or null with B = BH / H; BH, q_len, kv_len >= 1.
// q, k, v, dout and the outputs must be 16-byte aligned (the copies and
// stores are 16 bytes wide): a misaligned pointer is refused, never read.
cudaError_t flash_bwd_f32(int dkdv, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, const float* bias, void* dq,
                          void* dk, void* dv, int BH, int q_len, int kv_len,
                          int H, int D, float scale, int causal, int dropout,
                          uint32_t seed, const uint32_t* seed_ptr,
                          uint32_t threshold, float inv_keep,
                          cudaStream_t s) {
  void* out0 = dkdv ? dk : dq;
  void* out1 = dkdv ? dv : nullptr;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(out0) | reinterpret_cast<uintptr_t>(out1)) %
          16 != 0)
    return cudaErrorInvalidValue;
  const int br = flash_bwd_f32_rows(dkdv, BH, dkdv ? kv_len : q_len, D);
  const BwdF32Args a{static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout), lse, delta, bias,
                     static_cast<float*>(out0), static_cast<float*>(out1),
                     BH, q_len, kv_len, H, scale, causal, dropout, seed,
                     seed_ptr, threshold, inv_keep, s};
  return dkdv ? launch_bwd_f32_d<true>(D, br, a)
              : launch_bwd_f32_d<false>(D, br, a);
}

}  // namespace stf
