// Int8 quantized matmul x @ dequant(wq): the port of the TPU kernel
// simple_tensorflow_tpu/ops/pallas/quant_matmul.py:_qmm_kernel (:45) with
// its activation quantizer quantize_rowwise (:27). In serving it is the int8
// tied-softmax logits head, (rows, d_model) x (d_model, vocab).
//
// What it computes, in ONE launch:
//   1. per row of x: amax = max|x|, scale = amax == 0 ? 1 : amax / 127,
//      xq = clamp(rint(x / scale), -127, 127) (IEEE division, round half to
//      even: bit-identical to quantize_rowwise and the plain version);
//   2. acc[m, n] = sum_k xq[m, k] * wq[k, n] in exact int32;
//   3. out[m, n] = float(acc) * (xs[m] * ws[n]), multiplied in exactly that
//      order, cast to x's dtype.
// Integer sums are exact in any order, so the result is bit-exact against
// the plain PyTorch version on identical inputs.
//
// The weight is K-major: logical (k, n) with strides (1, k), i.e. the rows
// of a contiguous (n, k) int8 tensor, each column's k values contiguous.
// That is the layout int8 mma.sync needs for its B operand (.col): each
// column's k bytes are contiguous, so a lane reads 16 of them in one load.
//
// What bounds it on the card: bytes. At decode row counts (m <= 16) the
// weight dominates the traffic (32 MiB at 1024 x 32768, ~10.7 us at the
// H100 SXM data sheet's 3.35 TB/s) and each weight byte feeds only 2 * m
// operations. The design:
//   - each block owns 256 output columns (16 warps x 16) and the whole k, so
//     the weight is read once, and no partial sum leaves the block: no
//     memset, no int32 buffer, no atomics; 128 blocks at n = 32768, one an
//     SM, one wave, so x is quantized once an SM;
//   - the weight goes straight from HBM into registers, as in a GEMV: lane
//     (g, t) of a warp reads 16 contiguous bytes, k [16 t, 16 t + 16) of a
//     64-byte chunk, of column g of each of its two 8-column n-tiles, in
//     groups of four chunks, two groups in flight while one is multiplied
//     (up to 8 KB a warp, ~128 KB an SM, against the ~25-32 KB that covers
//     HBM latency). No shared memory, no barrier and no copy engine stand
//     between the load and the tensor cores. (Staging the weight through a
//     ring of shared memory, per-warp TMA boxes on mbarriers, measured
//     slower at the same block shape: PERF.md §6);
//   - tensor cores: mma.sync m16n8k32 s8 x s8 -> s32. Integer sums do not
//     depend on the order of k, so k is permuted the same way for A and B:
//     lane (g, t)'s 16 bytes are k 16 t + [0, 4) and [4, 8) of one product
//     (its b0/b1, which the canonical layout places at k 4 t and 16 + 4 t)
//     and 16 t + [8, 12), [12, 16) of a second: one 16-byte load is two B
//     fragments, and A's fragments are the same 16 bytes of rows g and g + 8
//     of the quantized x;
//   - the first two weight groups are loaded before anything else; then the
//     block quantizes its rows of x into shared memory (a warp per row,
//     four 16-byte loads a lane in flight, from L2; scales recomputed per
//     block: they are identical; zeros and padding rows skip the division,
//     whose slow path a zero dividend takes) while the groups land. Rows
//     sit a_stride bytes apart, 64 mod 128, so the 16-byte A reads of a
//     quarter-warp hit 32 different banks;
//   - m <= 16 rows is one A tile; up to 64 rows are four tiles against each
//     weight fragment; more rows take further blocks along grid.y;
//   - the epilogue scales the int32 fragments in registers and stores.
// Tails: rows past m and k past its end are zero in the A tile; loads past n
// and past k are not made (zeros), and columns past n are never stored.
// Where k or the pointer is not 16-byte aligned the lane reads its 16 bytes
// as four 4-byte loads.
#include "common.cuh"

namespace stf {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kQmmWarps = 16;
constexpr int kQmmThreads = 32 * kQmmWarps;
constexpr int kQmmNT = 2;                         // 8-column n-tiles a warp
constexpr int kQmmCols = kQmmWarps * 8 * kQmmNT;  // columns of a block
constexpr int kQmmChunk = 64;                     // k bytes: 4 lanes x 16
constexpr int kQmmU = 4;                          // chunks of one group
constexpr int kQmmGroup = kQmmChunk * kQmmU;      // k bytes of one group
constexpr int kQmmABudget = 72 * 1024;  // bytes of quantized x a block holds
constexpr int kQmmXUnroll = 4;          // 16-byte loads of x in flight a lane

// c += a . b: 16 x 32 s8 A (row), 32 x 8 s8 B (col), s32 C. Canonical
// fragments (lane = 4 g + t): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g,
// 16+4t..), a3 (g+8, 16+4t..); b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g); C
// as bf16's.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 weight bytes, read once: not kept in L1; L2 fetches the 256 bytes
// around them, which the column's next chunks read
__device__ __forceinline__ uint4 ldg_stream(const int8_t* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 4 consecutive elements of x (16-byte aligned f32, 8-byte aligned bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// int8 code of v at row scale sc: rint(v / sc) (IEEE division, half to
// even) clamped to [-127, 127], in the low byte. 0 / sc is 0: skipped, as
// a zero dividend takes the division's slow path
__device__ __forceinline__ uint32_t quantize(float v, float sc) {
  if (v == 0.0f) return 0u;
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int>(q));
}

// One block: rows [blockIdx.y * 16 MT, +16 MT) of x against columns
// [blockIdx.x * 256, +256) of wq_km, the (n, k) rows of the K-major weight.
// Quantized x lives in `ka`-deep chunks of k (one chunk unless k exceeds the
// A budget; ka a multiple of a group), rows `a_stride` bytes apart.
template <typename T, int MT, bool kVec16>
__global__ void __launch_bounds__(kQmmThreads, 1)
    qmm_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq_km,
                   const float* __restrict__ ws, T* __restrict__ out, int m,
                   int k, int n, int ka, int a_stride) {
  constexpr int kRows = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* a_sh = reinterpret_cast<int8_t*>(xs + kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kQmmCols + warp * 8 * kQmmNT;
  const int ngroups = cdiv(k, kQmmGroup);

  // group gi of the lane's weight bytes: chunk u of n-tile j is k
  // [gi * 256 + 64 u + 16 t, +16) of column col0 + 8 j + g
  using Group = uint4[kQmmU][kQmmNT];
  auto load_group = [&](Group& bv, int gi) {
#pragma unroll
    for (int u = 0; u < kQmmU; ++u)
#pragma unroll
      for (int j = 0; j < kQmmNT; ++j) {
        const int col = col0 + 8 * j + g;
        const int kk = gi * kQmmGroup + u * kQmmChunk + 16 * t;
        const int8_t* p = wq_km + static_cast<long long>(col) * k + kk;
        const bool ok = col < n;
        if constexpr (kVec16) {
          bv[u][j] = ok && kk < k ? ldg_stream(p) : make_uint4(0, 0, 0, 0);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = ok && kk + 4 * i < k
                       ? __ldg(reinterpret_cast<const uint32_t*>(p) + i)
                       : 0u;
          bv[u][j] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
  };
  Group b0, b1;  // two groups in flight: one multiplied, the next landing
  load_group(b0, 0);
  if (ngroups > 1) load_group(b1, 1);

  // row scales while the first group lands: a warp per row
  for (int r = warp; r < kRows; r += kQmmWarps) {
    float amax = 0.0f;
    if (m0 + r < m) {
      const T* xr = x + static_cast<long long>(m0 + r) * k;
      for (int i0 = 4 * lane; i0 < k; i0 += 128 * kQmmXUnroll) {
        float v[kQmmXUnroll][4];
#pragma unroll
        for (int u = 0; u < kQmmXUnroll; ++u) {
          if (i0 + 128 * u < k)
            load4(xr + i0 + 128 * u, v[u]);
          else
            v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kQmmXUnroll; ++u)
          amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[u][0]), fabsf(v[u][1])),
                                   fmaxf(fabsf(v[u][2]), fabsf(v[u][3]))));
      }
    }
    amax = warp_max(amax);
    if (lane == 0) xs[r] = amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
  }

  int acc[MT][kQmmNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kQmmNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  int chunk0 = -ka;  // first k of the quantized chunk in a_sh
  // group gi against the quantized x, first quantizing the next chunk of x
  // where gi starts one (the same gi in every warp)
  auto multiply = [&](const Group& bv, int gi) {
    const int kb = gi * kQmmGroup;
    if (kb == chunk0 + ka) {
      chunk0 = kb;
      __syncthreads();  // the scales are written; the last chunk is read
      // a warp per row; zeros past m and past k
      for (int r = warp; r < kRows; r += kQmmWarps) {
        const bool live = m0 + r < m;
        const T* xr = x + static_cast<long long>(live ? m0 + r : 0) * k;
        const float sc = xs[r];
        for (int i0 = 4 * lane; i0 < ka; i0 += 128 * kQmmXUnroll) {
          float v[kQmmXUnroll][4];
#pragma unroll
          for (int u = 0; u < kQmmXUnroll; ++u) {
            const int kk = chunk0 + i0 + 128 * u;
            if (live && i0 + 128 * u < ka && kk < k)
              load4(xr + kk, v[u]);
            else
              v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kQmmXUnroll; ++u) {
            if (i0 + 128 * u < ka)
              *reinterpret_cast<uint32_t*>(a_sh + r * a_stride + i0 +
                                           128 * u) =
                  quantize(v[u][0], sc) | quantize(v[u][1], sc) << 8 |
                  quantize(v[u][2], sc) << 16 | quantize(v[u][3], sc) << 24;
          }
        }
      }
      __syncthreads();
    }
    const int8_t* ak = a_sh + (kb - chunk0) + 16 * t;
#pragma unroll
    for (int u = 0; u < kQmmU; ++u)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // rows g and g + 8 of A tile i, k as the weight chunk's
        const int8_t* au = ak + u * kQmmChunk + (16 * i + g) * a_stride;
        const uint4 lo = *reinterpret_cast<const uint4*>(au);
        const uint4 hi = *reinterpret_cast<const uint4*>(au + 8 * a_stride);
#pragma unroll
        for (int j = 0; j < kQmmNT; ++j) {
          mma_s8(acc[i][j], lo.x, hi.x, lo.y, hi.y, bv[u][j].x, bv[u][j].y);
          mma_s8(acc[i][j], lo.z, hi.z, lo.w, hi.w, bv[u][j].z, bv[u][j].w);
        }
      }
  };
  for (int gi = 0; gi < ngroups; gi += 2) {
    multiply(b0, gi);
    if (gi + 2 < ngroups) load_group(b0, gi + 2);
    if (gi + 1 < ngroups) {
      multiply(b1, gi + 1);
      if (gi + 3 < ngroups) load_group(b1, gi + 3);
    }
  }

#pragma unroll
  for (int j = 0; j < kQmmNT; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    if (col >= n) continue;  // n % 4 == 0: col + 1 < n as well
    const float w0 = ws[col], w1 = ws[col + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * i + g + 8 * h;
        if (m0 + r >= m) continue;
        const float sx = xs[r];
        store2(out + static_cast<long long>(m0 + r) * n + col,
               __int2float_rn(acc[i][j][2 * h]) * (sx * w0),
               __int2float_rn(acc[i][j][2 * h + 1]) * (sx * w1));
      }
  }
}

template <typename T, int MT, bool kVec16>
cudaError_t launch_qmm(const T* x, const int8_t* wq_km, const float* ws,
                       T* out, int m, int k, int n, cudaStream_t s) {
  constexpr int kRows = 16 * MT;
  // the deepest run of groups of x whose rows (plus 64 bytes of skew) fit
  const int cap = ((kQmmABudget / kRows - 64) / kQmmGroup) * kQmmGroup;
  const int whole = cdiv(k, kQmmGroup) * kQmmGroup;
  const int ka = whole < cap ? whole : cap;
  const int a_stride = ka + 64;  // 64 mod 128: conflict-free 16-byte reads
  const size_t smem =
      kRows * sizeof(float) + static_cast<size_t>(kRows) * a_stride;
  auto kernel = qmm_mma_kernel<T, MT, kVec16>;
  static bool attr_set = false;  // the largest smem any call can ask for
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRows * static_cast<int>(sizeof(float)) + kQmmABudget);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(cdiv(n, kQmmCols), cdiv(m, kRows));
  kernel<<<grid, kQmmThreads, smem, s>>>(x, wq_km, ws, out, m, k, n, ka,
                                         a_stride);
  return cudaGetLastError();
}

template <typename T, bool kVec16>
cudaError_t run(const void* x, const int8_t* wq_km, const float* ws,
                void* out, int m, int k, int n, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (m <= 16) return launch_qmm<T, 1, kVec16>(xt, wq_km, ws, o, m, k, n, s);
  if (m <= 32) return launch_qmm<T, 2, kVec16>(xt, wq_km, ws, o, m, k, n, s);
  return launch_qmm<T, 4, kVec16>(xt, wq_km, ws, o, m, k, n, s);
}

}  // namespace
}  // namespace stf

// x (m, k) f32/bf16, contiguous, 16-byte (f32) or 8-byte (bf16) aligned;
// wq_km the (n, k) int8 rows of the K-major weight, 4-byte aligned;
// w_scale (n,) f32; out (m, n) in x's dtype. k % 4 == 0, n % 4 == 0.
extern "C" int stf_quant_matmul(const void* x, const void* wq_km,
                                const void* w_scale, void* out, int m, int k,
                                int n, int dtype, void* stream) {
  using namespace stf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || k % 4 != 0 || n % 4 != 0) return cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(wq_km);
  const float* ws = static_cast<const float*>(w_scale);
  const bool vec16 = k % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (dtype == kF32)
    return vec16 ? run<float, true>(x, w, ws, out, m, k, n, s)
                 : run<float, false>(x, w, ws, out, m, k, n, s);
  if (dtype == kBF16)
    return vec16 ? run<bf16, true>(x, w, ws, out, m, k, n, s)
                 : run<bf16, false>(x, w, ws, out, m, k, n, s);
  return cudaErrorInvalidValue;
}
