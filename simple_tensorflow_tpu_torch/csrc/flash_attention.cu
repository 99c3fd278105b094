// FlashAttention-2 forward and backward over (B*H, S, D): the C entry
// points of the ports of the TPU kernels simple_tensorflow_tpu/ops/pallas/
// flash_attention.py:_fwd_kernel (:102, called at :180), _bwd_dkdv_kernel
// (:210, called at :352) and _bwd_dq_kernel (:264, called at :383), with
// their dropout branch, and the rule that routes each call to its kernel.
// bf16 runs on tensor cores: at D = 128 the forward in flash_fwd_sm90.cu,
// dK/dV in flash_dkdv_sm90.cu and dQ in flash_dq_sm90.cu (wgmma, TMA,
// warp-specialised); at D <= 64 the forward in flash_fwd_mma.cu, dK/dV and
// dQ in flash_bwd_mma.cu. f32 runs on the CUDA cores (register-blocked,
// cp.async, the rows a block sized to fill the card): the forward in
// flash_fwd_f32.cu, dK/dV and dQ in flash_bwd_f32.cu. TF32 tensor cores
// would fail the f32 training check's limits (1e-5 on the loss, 1e-4 on
// the gradients).
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
// so any tiling draws the mask the TPU's 128 x 128 blocks draw, and the
// backward regenerates it; inv = f32(1 / keep_prob).
//   forward: l sums the UNDROPPED p; only the p stored for P.V is
//   keep ? p * inv : 0;
//   backward: dV takes keep ? p * inv : 0, dP becomes keep ? dP * inv : 0,
//   and dS = p_undropped * (dP - delta) * scale, delta = rowsum(dO . O) of
//   the dropped O.
// All sums are f32 (the TPU's preferred_element_type=f32 /
// Precision.HIGHEST). No kernel uses atomics: each output tile has one
// owner, so the gradients are deterministic.
#include "common.cuh"

namespace stf {

// flash_fwd_f32.cu: the f32 forward on the CUDA cores
cudaError_t flash_fwd_f32(const void* q, const void* k, const void* v,
                          const float* bias, void* o, float* lse, int BH,
                          int q_len, int kv_len, int H, int D, float scale,
                          int causal, int dropout, uint32_t seed,
                          const uint32_t* seed_ptr, uint32_t threshold,
                          float inv_keep, cudaStream_t s);

// flash_bwd_f32.cu: the f32 dK/dV (dkdv != 0) or dQ on the CUDA cores
cudaError_t flash_bwd_f32(int dkdv, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, const float* bias, void* dq,
                          void* dk, void* dv, int BH, int q_len, int kv_len,
                          int H, int D, float scale, int causal, int dropout,
                          uint32_t seed, const uint32_t* seed_ptr,
                          uint32_t threshold, float inv_keep, cudaStream_t s);

// flash_fwd_mma.cu: the bf16 forward on tensor cores
cudaError_t flash_fwd_bf16_mma(const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int BH,
                               int q_len, int kv_len, int H, int D,
                               float scale, int causal, int dropout,
                               uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                               float inv_keep, cudaStream_t s);

// flash_fwd_sm90.cu, flash_dkdv_sm90.cu, flash_dq_sm90.cu: the bf16
// forward, dK/dV and dQ at D = 128 on wgmma and TMA
cudaError_t flash_fwd_sm90(const void* q, const void* k, const void* v,
                           const float* bias, void* o, float* lse, int BH,
                           int q_len, int kv_len, int H, float scale,
                           int causal, int dropout, uint32_t seed,
                           const uint32_t* seed_ptr, uint32_t threshold,
                           float inv_keep, cudaStream_t s);
cudaError_t flash_dkdv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* bias, void* dk,
                            void* dv, int BH, int q_len, int kv_len, int H,
                            float scale, int causal, int dropout,
                            uint32_t seed, const uint32_t* seed_ptr,
                            uint32_t threshold, float inv_keep,
                            cudaStream_t s);
cudaError_t flash_dq_sm90(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* bias, void* dq,
                          int BH, int q_len, int kv_len, int H, float scale,
                          int causal, int dropout, uint32_t seed,
                          const uint32_t* seed_ptr, uint32_t threshold,
                          float inv_keep, cudaStream_t s);

// flash_bwd_mma.cu: the bf16 dK/dV (dkdv != 0) or dQ on tensor cores at
// D <= 64
cudaError_t flash_bwd_bf16_mma(int dkdv, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               const float* bias, void* dq, void* dk,
                               void* dv, int BH, int q_len, int kv_len, int H,
                               int D, float scale, int causal, int dropout,
                               uint32_t seed, const uint32_t* seed_ptr, uint32_t threshold,
                               float inv_keep, cudaStream_t s);

namespace {

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

enum FaWhich { kFwd = 0, kDkdv = 1, kDq = 2 };

// bf16 on tensor cores: every part at D = 128 on wgmma and TMA
// (flash_fwd_sm90.cu, flash_dkdv_sm90.cu, flash_dq_sm90.cu), everything at
// D <= 64 on mma.sync (flash_fwd_mma.cu, flash_bwd_mma.cu: each checks D);
// f32 on the CUDA cores (flash_fwd_f32.cu, flash_bwd_f32.cu: each checks
// D). ops/kernels/flash_attention.py kernel_name() states the same rule.
int dispatch(int which, int dtype, int D, const FaArgs& a) {
  if (a.BH <= 0 || a.q_len <= 0) return cudaSuccess;
  if (a.kv_len <= 0) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    if (D == 128 && which == kFwd)
      return flash_fwd_sm90(a.q, a.k, a.v, a.bias, a.o,
                            static_cast<float*>(a.lse), a.BH, a.q_len,
                            a.kv_len, a.H, a.scale, a.causal, a.dropout,
                            a.seed, a.seed_ptr, a.threshold, a.inv_keep, a.s);
    if (D == 128 && which == kDkdv)
      return flash_dkdv_sm90(a.q, a.k, a.v, a.dout,
                             static_cast<const float*>(a.lse_in),
                             static_cast<const float*>(a.delta), a.bias,
                             a.dk, a.dv, a.BH, a.q_len, a.kv_len, a.H,
                             a.scale, a.causal, a.dropout, a.seed,
                             a.seed_ptr, a.threshold, a.inv_keep, a.s);
    if (D == 128)
      return flash_dq_sm90(a.q, a.k, a.v, a.dout,
                           static_cast<const float*>(a.lse_in),
                           static_cast<const float*>(a.delta), a.bias, a.dq,
                           a.BH, a.q_len, a.kv_len, a.H, a.scale, a.causal,
                           a.dropout, a.seed, a.seed_ptr, a.threshold,
                           a.inv_keep, a.s);
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
  if (which == kFwd)
    return flash_fwd_f32(a.q, a.k, a.v, a.bias, a.o,
                         static_cast<float*>(a.lse), a.BH, a.q_len, a.kv_len,
                         a.H, D, a.scale, a.causal, a.dropout, a.seed,
                         a.seed_ptr, a.threshold, a.inv_keep, a.s);
  return flash_bwd_f32(which == kDkdv, a.q, a.k, a.v, a.dout,
                       static_cast<const float*>(a.lse_in),
                       static_cast<const float*>(a.delta), a.bias, a.dq, a.dk,
                       a.dv, a.BH, a.q_len, a.kv_len, a.H, D, a.scale,
                       a.causal, a.dropout, a.seed, a.seed_ptr, a.threshold,
                       a.inv_keep, a.s);
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
