// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its element type as a template parameter (float or
// __nv_bfloat16) and does all of its arithmetic in float: values are widened
// on load and narrowed once, on the final store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

// The same masking constant as the JAX reference (pallas_attention.NEG_INF):
// finite, so a row whose every entry is masked stays finite through exp().
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// dtype codes shared with the Python wrappers (ops/_build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// ------------------------------------------------ bf16 tensor-core helpers
// mma.sync.m16n8k16 with bf16 inputs and float accumulation. With g = lane/4
// and t = lane%4, a thread holds: A rows g and g+8 at columns 2t, 2t+1 and
// 2t+8, 2t+9 (a[0..3]: (g, 2t) (g+8, 2t) (g, 2t+8) (g+8, 2t+8)); B column g
// at rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1); C rows g (c[0], c[1]) and g+8
// (c[2], c[3]) at columns 2t, 2t+1.

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + ROWS) of a [S, D] slice with row stride ss (elements) into
// a [ROWS][D + 8] tile, zeros past S; 16-byte loads, so the wrappers require
// 16-byte aligned rows
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ g,
                                          int64_t ss, int r0, int S,
                                          __nv_bfloat16* tile, int tid) {
  constexpr int kVecs = D / 8;
  for (int i = tid; i < ROWS * kVecs; i += THREADS) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      v = *reinterpret_cast<const uint4*>(g + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(tile + r * (D + 8) + c) = v;
  }
}

// the same rows transposed into a [D][pitch] tile: tile[d * pitch + r], so
// that a B fragment along the rows is one 32-bit word
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_t(
    const __nv_bfloat16* __restrict__ g, int64_t ss, int r0, int S,
    __nv_bfloat16* tile, int pitch, int tid) {
  constexpr int kVecs = D / 8;
  for (int i = tid; i < ROWS * kVecs; i += THREADS) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      raw = *reinterpret_cast<const uint4*>(g + (r0 + r) * ss + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[(c + j) * pitch + r] = e[j];
  }
}

}  // namespace pt
