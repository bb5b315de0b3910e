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

}  // namespace pt
