// The f32 FlashAttention forward on the CUDA cores: the port of the TPU
// kernel simple_tensorflow_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (:102, called at :180) for f32 inputs at D in {16, 32, 64, 128}, causal or
// not, with a (B, kv_len) key bias or without, dropout branch included.
// flash_attention.cu routes every f32 forward here (its f32 dK/dV and dQ
// kernels stay there; bf16 runs on tensor cores in flash_fwd_mma.cu and
// flash_fwd_sm90.cu).
//
// What it computes (flash_attention_fwd_plain in ops/kernels/
// flash_attention.py states it): s = (q . k) * scale
// (+ bias[b, key]), then NEG_INF where key >= kv_len or (causal) key >
// query (the bias before the mask); an online softmax over key tiles (m,
// l, acc) whose l sums the undropped p; with dropout only the p of P.V is
// keep ? p * inv_keep : 0, keep = K0 counter_keep(keep_hash0(seed, bh),
// GLOBAL query, GLOBAL key), so the backward regenerates the mask; o = acc
// / l and lse = m + log(l) with l == 0 -> 1. Each dot product and each
// P.V sum runs as one chain of f32 FMAs in d and key order: exact f32 on
// the CUDA cores. Not TF32 (it fails the f32 limits: 1e-5 on
// the loss and on o and lse, 1e-4 on the gradients), and not a
// split-precision 3xTF32 product on the tensor cores either: its dropped
// low x low term and the tensor cores' truncating accumulation would move
// o by ~1e-6, a tenth of the limit, for a kernel whose main path (the
// encoder-decoder prefill) is bound by latency and block count, not by
// operations.
//
// What bounds it on the card. At the encoder-decoder prefill (16 heads of
// S = 64, D = 64, batch 1, 4 or 16, non-causal, the pad bias) a head is
// 48 KB of q, k, v and 1 MFLOP: the bound is ~1.3 us of bytes. One
// 256-thread block a 64-query tile would run 64 blocks on 132 SMs at batch
// 4, and a block that copies its tiles 4 bytes a thread between barriers,
// then reads 8 shared floats for every 16 FMAs, waits on latency, not on
// the card's rates. At the f32 training checks' shape (256 heads of
// S = 256, causal) it is operations (2.2 GFLOP: 32 us at 67 TFLOP/s). So:
// - the host picks the tile: the query rows a block, BQ in {64, 32, 16},
//   the largest that still makes about a block an SM (two, causal:
//   kFillBlocks), else 16, and the rows a thread, TM = 4, or 2 where the
//   grid still leaves SMs without a block. At one TM a block's threads do
//   the same work at every BQ, so fewer, taller blocks copy each K/V tile
//   fewer times; TM = 2 doubles a block's threads and halves each one's
//   serial work, which pays only where the card is mostly idle. The
//   prefill at batch 1, 4 and 16 runs 64 blocks of 16 rows (TM 2), 128 of
//   32 (TM 2) and 256 of 64; the causal training shapes keep 64 (TM 4);
// - a block is BQ / TM groups of 16 threads; thread (ty, tx) owns query
//   rows TM ty .. TM ty + TM - 1 and the keys tx + 16 j of a tile (4 of 64
//   keys; 2 of 32 at D = 128), then the output columns of its row group;
// - staging: 16-byte cp.async copies into shared memory (rows of D + 4
//   floats: 16-byte aligned and bank-conflict free for the reads below),
//   ragged rows zero-filled and never stored; the K/V tiles sit in a ring
//   of two stages, so tile t + 1 loads while tile t's products run (one
//   stage where the walk has a single tile: less shared memory, more
//   blocks an SM), and a tile's K and V are two copy groups, so its
//   Q K^T starts before its V has landed. Rows of D f32 are 16-byte
//   multiples at every D;
// - register-blocked products: S = Q K^T reads a float4 of d for each of
//   its TM query rows (the 16 threads of a row group read the same
//   address: a broadcast) and each of its 4 keys, 8 loads for 64 FMAs at
//   TM = 4 (6 for 32 at TM = 2); the row max and sum are reduced over the
//   16 threads by shuffles; P goes to shared memory once and P.V reads it
//   as float4s over 4 keys (a broadcast again) against float4s of the V
//   rows, 8 loads for 64 FMAs at D = 64, TM = 4;
// - one launch a call, no atomics, no split-K merge: each output row has
//   one owner, so two launches give the same bits; the heaviest causal
//   query tiles launch first.
#include "f32_tile.cuh"

namespace stf {
namespace {

// the blocks below which the host halves the query rows a block
// (ops/kernels/flash_attention.py fwd_tile_f32 states the rule): about one
// block an SM of the 132 where every block does the same work, two where
// (causal) the diagonal's blocks do less, so the heaviest, launched first,
// leave room to balance the tail; below kSMs blocks a thread takes 2 rows
constexpr int kSMs = 132;
constexpr int kFillBlocks = 128;
constexpr int kFillBlocksCausal = 2 * kSMs;

// keys a tile: 64, or 32 at D = 128, where two stages of 64 would leave
// one block an SM
template <int D>
__host__ __device__ constexpr int f32_bk() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr int f32_smem_floats(int bq, int stages) {
  return bq * (D + 4) + 2 * stages * f32_bk<D>() * (D + 4) +
         bq * (f32_bk<D>() + 4);  // q | (k, v) x stages | p
}

// wait until at most n (0 .. 3) of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sum / max over the 16 threads (tx) of a row group
__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (B*H, query tiles of BQ rows), the heaviest tile first; BQ / TM
// groups of 16 threads, TM query rows a thread
template <int D, int BQ, int TM>
__global__ void __launch_bounds__(BQ / TM * 16)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int q_len, int kv_len, int H,
                     float scale, int causal, int stages, int dropout,
                     uint32_t seed, const uint32_t* seed_ptr,
                     uint32_t threshold, float inv_keep) {
  constexpr int NT = BQ / TM * 16;
  constexpr int BK = f32_bk<D>();
  constexpr int KN = BK / 16;  // keys a thread
  constexpr int DS = D + 4;    // row stride of q, k, v in shared memory
  constexpr int PS = BK + 4;   // row stride of p
  constexpr int CW = D / 16;   // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;
  float* kv_sh = q_sh + BQ * DS;  // stage st: k, then v
  float* p_sh = kv_sh + 2 * stages * BK * DS;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + static_cast<long long>(bh) * q_len * D;
  const float* kb = k + static_cast<long long>(bh) * kv_len * D;
  const float* vb = v + static_cast<long long>(bh) * kv_len * D;
  const float* bb =
      bias != nullptr ? bias + static_cast<long long>(bh / H) * kv_len
                      : nullptr;

  int n_kt = cdiv(kv_len, BK);
  if (causal) n_kt = min(n_kt, cdiv(q0 + BQ, BK));  // the `live` tiles
  // a tile is two copy groups, K then V, so S = Q K^T starts while V is
  // still in flight
  auto stage_kv = [&](int kt, int st) {
    float* ks = kv_sh + st * 2 * BK * DS;
    stage_tile<D, NT, BK>(ks, kb, kt * BK, kv_len);
    cp_async_commit();
    stage_tile<D, NT, BK>(ks + BK * DS, vb, kt * BK, kv_len);
    cp_async_commit();
  };
  stage_tile<D, NT, BQ>(q_sh, qb, q0, q_len);  // in tile 0's K group
  stage_kv(0, 0);
  if (stages == 2 && n_kt > 1) stage_kv(1, 1);

  const uint32_t h0 =
      dropout ? keep_hash0(dropout_seed(seed, seed_ptr), bh) : 0u;
  float m[TM], l[TM], acc[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int st = stages == 2 ? (kt & 1) : 0;
    // groups issued after this tile's V: the next tile's K and V
    const int later = stages == 2 && kt + 1 < n_kt ? 2 : 0;
    cp_async_wait_pending(1 + later);  // this tile's K landed
    __syncthreads();
    const float* ks = kv_sh + st * 2 * BK * DS;
    const float* vs = ks + BK * DS;

    // S = Q K^T on the thread's TM x KN patch, a float4 of d at a time
    float s[TM][KN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[TM], kv[KN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_sh + (ty * TM + i) * DS + d);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) s[i][j] = fma4(qv[i], kv[j], s[i][j]);
    }

    // scale, the bias before the mask; the online softmax over the row
    // group; p (dropped with dropout) to shared memory
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qg = q0 + ty * TM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kg = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (bb != nullptr && kg < kv_len) x += bb[kg];
        const bool ok = kg < kv_len && qg < q_len && (!causal || qg >= kg);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        float pv = p;
        if (dropout)
          pv = counter_keep(h0, qg, k0 + tx + 16 * j, threshold)
                   ? __fmul_rn(p, inv_keep)
                   : 0.0f;
        p_sh[(ty * TM + i) * PS + tx + 16 * j] = pv;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait_pending(later);  // this tile's V landed
    __syncthreads();  // p and V of the whole tile are in shared memory

    // O += P V over the tile's live keys, 4 at a time: keys past kv_len
    // in the last quad have p = 0 and zero V rows
    const int n_quads = cdiv(min(BK, kv_len - k0), 4);
#pragma unroll 2
    for (int c4 = 0; c4 < n_quads; ++c4) {
      float4 pq[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pq[i] = *reinterpret_cast<const float4*>(p_sh + (ty * TM + i) * PS +
                                                 c4 * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[CW];
        group_cols<D, 16>(vs + (c4 * 4 + e) * DS, tx, vv);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = lane4(pq[i], e);
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // this stage and p are consumed
    if (stages == 2 ? kt + 2 < n_kt : kt + 1 < n_kt)
      stage_kv(kt + stages, st);
  }

  float* ob = o + static_cast<long long>(bh) * q_len * D;
  float* lb = lse + static_cast<long long>(bh) * q_len;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qg = q0 + ty * TM + i;
    if (qg >= q_len) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
    float out[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) out[c] = acc[i][c] / l_safe;
    store_group_cols<D, 16>(ob + static_cast<long long>(qg) * D, tx, out);
    if (tx == 0) lb[qg] = m[i] + logf(l_safe);
  }
}

struct F32Args {
  const float *q, *k, *v, *bias;
  float *o, *lse;
  int BH, q_len, kv_len, H;
  float scale;
  int causal, dropout;
  uint32_t seed;
  const uint32_t* seed_ptr;
  uint32_t threshold;
  float inv_keep;
  cudaStream_t s;
};

template <int D, int BQ, int TM>
cudaError_t launch_f32(const F32Args& a) {
  // one stage where the walk has a single key tile
  const int stages = cdiv(a.kv_len, f32_bk<D>()) > 1 ? 2 : 1;
  const size_t smem = f32_smem_floats<D>(BQ, stages) * sizeof(float);
  auto kernel = flash_fwd_kernel<D, BQ, TM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.BH, cdiv(a.q_len, BQ)), BQ / TM * 16, smem, a.s>>>(
      a.q, a.k, a.v, a.bias, a.o, a.lse, a.q_len, a.kv_len, a.H, a.scale,
      a.causal, stages, a.dropout, a.seed, a.seed_ptr, a.threshold,
      a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_tile(int bq, int tm, const F32Args& a) {
  if (bq == 64) return launch_f32<D, 64, 4>(a);
  if (bq == 32)
    return tm == 2 ? launch_f32<D, 32, 2>(a) : launch_f32<D, 32, 4>(a);
  return tm == 2 ? launch_f32<D, 16, 2>(a) : launch_f32<D, 16, 4>(a);
}

// The f32 forward's tile for B*H heads of q_len queries: the query rows a
// block, *bq, the largest of 64 and 32 whose blocks still reach
// kFillBlocks (kFillBlocksCausal), else 16; and the rows a thread, *tm: 2
// where the blocks still leave SMs without one (and *bq < 64), so each
// block has twice the threads, each half the serial work; else 4.
void flash_fwd_f32_tile(int BH, int q_len, int causal, int* bq, int* tm) {
  const long long fill = causal ? kFillBlocksCausal : kFillBlocks;
  *bq = 16;
  for (int rows = 64; rows >= 32; rows /= 2) {
    if (static_cast<long long>(cdiv(q_len, rows)) * BH >= fill) {
      *bq = rows;
      break;
    }
  }
  const long long blocks = static_cast<long long>(cdiv(q_len, *bq)) * BH;
  *tm = blocks < kSMs && *bq < 64 ? 2 : 4;
}

}  // namespace

// q (BH, q_len, D), k/v (BH, kv_len, D), o like q, lse (BH, q_len), all f32;
// bias (B, kv_len) f32 or null with B = BH / H; BH, q_len, kv_len >= 1.
// q, k, v and o must be 16-byte aligned (the copies and stores are 16
// bytes wide): a misaligned pointer is refused, never read.
cudaError_t flash_fwd_f32(const void* q, const void* k, const void* v,
                          const float* bias, void* o, float* lse, int BH,
                          int q_len, int kv_len, int H, int D, float scale,
                          int causal, int dropout, uint32_t seed,
                          const uint32_t* seed_ptr, uint32_t threshold,
                          float inv_keep, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return cudaErrorInvalidValue;
  int bq, tm;
  flash_fwd_f32_tile(BH, q_len, causal, &bq, &tm);
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), bias, static_cast<float*>(o),
                  lse, BH, q_len, kv_len, H, scale, causal, dropout, seed,
                  seed_ptr, threshold, inv_keep, s};
  switch (D) {
    case 16: return launch_f32_tile<16>(bq, tm, a);
    case 32: return launch_f32_tile<32>(bq, tm, a);
    case 64: return launch_f32_tile<64>(bq, tm, a);
    case 128: return launch_f32_tile<128>(bq, tm, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stf
