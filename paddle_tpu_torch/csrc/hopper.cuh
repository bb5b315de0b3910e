// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tensor
// maps and loads, mbarrier rings, wgmma descriptors and instructions, and
// warp-specialisation helpers (register rebalancing, named barriers).
//
// How the pieces fit (csrc/flash_fwd.cu and csrc/flash_bwd.cu use them):
// - A tensor map describes a strided tensor in device memory. It is encoded
//   on the host (encode_bshd, through the driver entry point that the
//   runtime hands out, so the library links no libcuda) and passed to the
//   kernel as a __grid_constant__ parameter.
// - One thread issues tma_load_4d for a box of the tensor into shared
//   memory, 128-byte swizzled, and the copy signals an mbarrier with its
//   byte count. Rows past the tensor's edge are filled with zeros.
// - Consumers wait on that barrier (mbar_wait) and read the tile with wgmma,
//   whose shared-memory descriptor (desc_sw128) states the same 128-byte
//   swizzle; when done they arrive on the stage's "empty" barrier so the
//   producer may load the next tile into it.
//
// Shared memory layout of a 16-bit (bf16 or f16) tile as TMA writes it with
// SWIZZLE_128B: a box of 64 columns (128 bytes) by R rows is R rows of 128 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8). Wider rows are loaded as
// several such boxes, one after the other. Every box starts on a 1024-byte
// boundary.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and announce the bytes the TMA copies of this phase will deliver
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed. (No timeout that
// traps: a trap anywhere in a kernel keeps ptxas from giving the roles of a
// warp-specialised kernel their own register budgets, see setmaxnreg_inc.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ TMA
// Copy the box at coordinates (c0, c1, c2, c3) (innermost first) of a 4-D
// tensor map into shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Copy the box at element c0 of a 1-D tensor map (the backward's lse and
// delta, flattened [B*H*S] float) into shared memory at dst.
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// ------------------------------------------------- warp specialisation
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Raise this warpgroup's registers to N (taken from those another role gave
// up with setmaxnreg_dec). ptxas then allocates up to N registers in the code
// that follows, but only if it can tell the roles apart: the branch between
// them must be warp-uniform (derive it through __shfl_sync) and the kernel
// must contain no trap. Otherwise it keeps every role at the launch bound's
// count (168 at 384 threads) and spills.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier over `threads` threads (a multiple of 32) under the id `id`
// (1..15; 0 is __syncthreads')
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at that barrier without waiting (a producer-consumer handoff)
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a 128-byte swizzled operand (layout
// type 1 in bits 62-63). Offsets are in bytes:
// - K-major operand (rows of 64 elements along K, as TMA wrote them): sbo is the
//   stride between groups of 8 rows (1024); lbo is unused. A step of 16
//   along K adds 32 bytes to the start address, inside the swizzle atom.
// - MN-major operand (rows of 64 elements along M or N, one row per K index):
//   sbo is the stride between groups of 8 K rows (1024), lbo the stride
//   between the 64-wide blocks along M or N. Use it with the transpose bit.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr,
                                               uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// before the first wgmma that reads registers or accumulators written by
// ordinary instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma: call after wgmma_wait on every register it wrote.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products below are m64nNk16 with 16-bit inputs of type T (bf16 or
// f16: the template argument picks the instruction's .bf16 or .f16 kind; the
// operands' layouts and descriptors are the same, both types being 2 bytes)
// and float accumulators d. Thread t of the warpgroup (warp w = t / 32,
// g = (t % 32) / 4, q = t % 4) holds rows 16w + g (d[4j], d[4j + 1]) and
// 16w + g + 8 (d[4j + 2], d[4j + 3]) at columns 8j + 2q and 8j + 2q + 1. A
// register A operand holds the same rows at k = 2q, 2q + 1 (a[0], a[1] for
// the two rows) and 2q + 8, 2q + 9 (a[2], a[3]), two elements to a register:
// the accumulator of keys 16k..16k+15 (d[8k..8k+7]) is the A operand of
// step k as it stands. scale_d = 0 overwrites d, 1 accumulates. Trans = 1:
// MN-major operand.
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

#define PT_ACC8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PT_ACC32(d, i)                                                       \
  PT_ACC8(d, i), PT_ACC8(d, i + 8), PT_ACC8(d, i + 16), PT_ACC8(d, i + 24)
#define PT_REGS32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define PT_REGS64                                                            \
  PT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
            "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
            "%56, %57, %58, %59, %60, %61, %62, %63"

// m64n64k16, A from registers, B from shared memory; TY is "bf16" or "f16"
#define PT_WGMMA_N64_RS(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
               PT_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"  \
               : PT_ACC32(d, 0)                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
                 "r"(scale_d), "n"(TransB))
// m64n64k16, both operands K-major in shared memory (no transpose bits)
#define PT_WGMMA_N64_SS(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
               PT_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                  \
               : PT_ACC32(d, 0)                                              \
               : "l"(da), "l"(db), "r"(scale_d))
// m64n128k16, both operands K-major in shared memory
#define PT_WGMMA_N128_SS(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
               PT_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                  \
               : PT_ACC32(d, 0), PT_ACC32(d, 32)                             \
               : "l"(da), "l"(db), "r"(scale_d))
// m64n128k16, A from registers
#define PT_WGMMA_N128_RS(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
               PT_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"  \
               : PT_ACC32(d, 0), PT_ACC32(d, 32)                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
                 "r"(scale_d), "n"(TransB))

template <typename T, int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_N64_RS("f16");
  else
    PT_WGMMA_N64_RS("bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_N64_SS("f16");
  else
    PT_WGMMA_N64_SS("bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_N128_SS("f16");
  else
    PT_WGMMA_N128_SS("bf16");
}

template <typename T, int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  if constexpr (kIsHalf<T>)
    PT_WGMMA_N128_RS("f16");
  else
    PT_WGMMA_N128_RS("bf16");
}

#undef PT_WGMMA_N128_RS
#undef PT_WGMMA_N128_SS
#undef PT_WGMMA_N64_SS
#undef PT_WGMMA_N64_RS
#undef PT_REGS64
#undef PT_REGS32
#undef PT_ACC32
#undef PT_ACC8

// the register-A products above by their N (64 or 128)
template <typename T, int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 128)
    wgmma_m64n128k16_rs<T, TransB>(d, a, db, scale_d);
  else
    wgmma_m64n64k16_rs<T, TransB>(d, a, db, scale_d);
}

}  // namespace hopper

// ------------------------------------------------------- host: tensor maps
namespace hopper_host {

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (nullptr when the driver does not offer it)
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (D, H, S, B), innermost first, over a 16-bit [B, S, H, D]
// tensor of type T (__nv_bfloat16 or __half) with element strides sb, ss, sh
// and a contiguous last dim; boxes of 64 columns (128 bytes, SWIZZLE_128B)
// by box_rows positions of one head. Dims of size 1 get a stride that is
// never used but is valid. Returns false if the driver refuses the map (e.g.
// strides that are not multiples of 16 bytes, a base pointer not 16-byte
// aligned).
template <typename T>
inline bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S,
                        int H, int D, int64_t sb, int64_t ss, int64_t sh,
                        int box_rows) {
  static_assert(sizeof(T) == 2, "encode_bshd: a 16-bit element type");
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const uint64_t elt = sizeof(T);
  if (H == 1) sh = D;
  if (S == 1) ss = sh * H;
  if (B == 1) sb = ss * S;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * elt, (cuuint64_t)ss * elt,
                           (cuuint64_t)sb * elt};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = hopper::kIsHalf<T>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over n contiguous floats (the backward's [B*H, S] lse and
// delta, flattened), boxes of `box` elements, no swizzle. A box that starts
// near the end of one row holds the next row's first values (the kernels
// mask those columns); past n it is zero-filled. Returns false if the driver
// refuses it (a base pointer not 16-byte aligned).
inline bool encode_1d_f32(CUtensorMap* map, const float* ptr, int64_t n,
                          int box) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  cuuint64_t dims[1] = {(cuuint64_t)n};
  cuuint64_t strides[1] = {0};  // rank 1: no strides are read
  cuuint32_t boxd[1] = {(cuuint32_t)box};
  cuuint32_t estride[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(ptr), dims, strides, boxd, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper_host
