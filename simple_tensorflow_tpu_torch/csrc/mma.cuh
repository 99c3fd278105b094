// Tensor-core building blocks shared by the bf16 flash kernels
// (flash_fwd_mma.cu, flash_bwd_mma.cu): 64-row bf16 tiles copied with
// 16-byte cp.async into shared memory under an XOR swizzle, read back as
// mma.sync m16n8k16 fragments through ldmatrix, and the few scalar helpers
// the kernels run on accumulator fragments.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 g + t): A (16 x 16, row)
// holds (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..) as four
// bf16 pairs; B (16 x 8, col) holds (k 2t..2t+1, n g) and (k 2t+8.., n g);
// C (16 x 8, f32) holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). So the
// C fragments of two neighbouring 8-column n-tiles, rounded to bf16 pairs,
// are the A fragment of a product whose k runs over those 16 columns.
#pragma once

#include "common.cuh"

namespace stf {

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows of a 64-row tile
constexpr int kTile = 64;         // rows of a block's tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `chunk` of row `row` in a (rows, D) bf16
// tile: unit u of 128-byte line u / 8 sits at u ^ (line % 8), so the 8 rows
// one ldmatrix phase reads fall in 8 different bank groups for any D.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  const int u = row * (D / 8) + chunk;
  return (u ^ ((u >> 3) & 7)) * 8;
}

// 16 bytes global -> shared; zero-filled when !valid (src is then any
// mapped address and is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a (rows, D) slice into a swizzled tile; rows
// at or past `limit` are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* sh, const bf16* g, int row0,
                                          int limit) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = row0 + r < limit;
    const bf16* src = g + (ok ? static_cast<long long>(row0 + r) * D : 0) +
                      c * 8;
    cp_async16(sh + swz<D>(r, c), src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 C
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warp's 16 x D f32 accumulator fragments acc[n] (columns 8n..8n+7),
// rounded to bf16, into rows [row0, row0 + 16) of a swizzled tile that
// only this warp reads; then 16-byte stores of those rows to rows
// [grow0, grow0 + 16) of the (rows, D) slice `out`, the rows below `limit`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* stage, int row0,
                                           const float (&acc)[D / 8][4],
                                           bf16* out, int grow0, int limit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's last fragment reads of these rows are done
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + swz<D>(row0 + g, n) + 2 * t) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(row0 + g + 8, n) + 2 * t) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    if (grow0 + r < limit)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(grow0 + r) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(row0 + r, c));
  }
}

// 2^x on the special-function unit (ex2.approx: 2 ulp, subnormal results
// flushed to 0). exp(s - m) is ex2((s - m) * log2(e)): three instructions
// an element against some ten for the accurate expf, and exp(0) = 1 where
// s = m = NEG_INF, as in the TPU kernel.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace stf
