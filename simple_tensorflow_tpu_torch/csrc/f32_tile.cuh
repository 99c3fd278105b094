// Helpers of the f32 flash kernels on the CUDA cores (flash_fwd_f32.cu,
// flash_bwd_f32.cu): 16-byte cp.async copies of f32 rows into shared
// memory rows of D + 4 floats (16-byte aligned; the reads of 4 or 8
// neighbouring rows fall in distinct banks), the columns of a row that a
// thread of a thread group owns, and exact f32 multiply-adds over a
// float4.
#pragma once

#include "mma.cuh"

namespace stf {
namespace {

// rows [row0, row0 + ROWS) of a head's (rows, D) f32 slice `src` into
// shared memory rows of D + 4 floats, 16 bytes a cp.async; rows at or past
// `limit` are zero. Each of the NT threads copies the same chunk of every
// NT / (D / 4)-th row: its offsets are fixed, so a copy costs an add.
template <int D, int NT, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int row0, int limit) {
  constexpr int kChunks = D / 4;
  static_assert(NT % kChunks == 0, "a thread keeps one chunk of its rows");
  constexpr int kRowsPer = NT / kChunks;  // rows a pass copies
  const int r = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  float* d0 = dst + r * (D + 4) + c * 4;
  const float* s0 = src + (row0 + r) * D + c * 4;
#pragma unroll
  for (int it = 0; it < cdiv(ROWS, kRowsPer); ++it) {
    const int rr = r + it * kRowsPer;
    if (ROWS % kRowsPer == 0 || rr < ROWS) {
      const bool ok = row0 + rr < limit;
      cp_async16(d0 + it * kRowsPer * (D + 4),
                 ok ? s0 + it * kRowsPer * D : src, ok);
    }
  }
}

// The columns a thread of a G-thread group owns in a D-wide row: float4s at
// 4 G c + 4 g (D >= 4 G: the group reads 16 G contiguous bytes), else D / G
// contiguous floats at g D / G.
template <int D, int G>
__device__ __forceinline__ void group_cols(const float* row, int g,
                                           float (&v)[D / G]) {
  if constexpr (D >= 4 * G) {
#pragma unroll
    for (int c = 0; c < D / (4 * G); ++c) {
      const float4 t = *reinterpret_cast<const float4*>(row + 4 * G * c + 4 * g);
      v[4 * c] = t.x, v[4 * c + 1] = t.y, v[4 * c + 2] = t.z,
            v[4 * c + 3] = t.w;
    }
  } else if constexpr (D == 2 * G) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * g);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = row[g];
  }
}

template <int D, int G>
__device__ __forceinline__ void store_group_cols(float* row, int g,
                                                 const float (&v)[D / G]) {
  if constexpr (D >= 4 * G) {
#pragma unroll
    for (int c = 0; c < D / (4 * G); ++c)
      *reinterpret_cast<float4*>(row + 4 * G * c + 4 * g) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else if constexpr (D == 2 * G) {
    *reinterpret_cast<float2*>(row + 2 * g) = make_float2(v[0], v[1]);
  } else {
    row[g] = v[0];
  }
}

__device__ __forceinline__ float fma4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

}  // namespace
}  // namespace stf
