// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its element type as a template parameter (float,
// __nv_bfloat16 or, for the flash kernels, __half; the paged kernel's pools
// also int8) and does all of its arithmetic in float: values are widened on
// load and narrowed where the reference rounds them (the operands of a
// 16-bit product, the final store).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
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

// 16 bytes global -> shared, asynchronously; zero-filled when !full (the
// source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x, hidden from the compiler: a value cheap to recompute (a kernel
// parameter, an index) passed through it inside a loop is recomputed there
// instead of being hoisted out and held in a register for the whole loop
template <typename T>
__device__ __forceinline__ T opaque(T x) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "a 32- or 64-bit value");
  if constexpr (sizeof(T) == 8) {
    asm volatile("" : "+l"(x));
  } else {
    asm volatile("" : "+r"(x));
  }
  return x;
}

// dtype codes shared with the Python wrappers (ops/_build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat16 = 3 };

// two floats rounded to bf16 and packed into one register (low half first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the same for a 16-bit element type T (__nv_bfloat16 or __half). Rounding
// to nearest: a value beyond float16's range becomes inf and NaN stays NaN,
// as the reference's astype lets them through (nothing is clamped).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace pt
