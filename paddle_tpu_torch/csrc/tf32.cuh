// float32 on Hopper's tensor cores in 3xTF32, shared by the float32 flash
// kernels (csrc/flash_fwd.cu, flash_fwd_tf32_kernel; csrc/flash_bwd.cu,
// dq_tf32_kernel and dkv_tf32_kernel).
//
// The TPU runs float32 operands as three bf16 passes on its matrix unit; the
// card's counterpart is 3xTF32, as CUTLASS's OpMultiplyAddFastF32: each
// float x is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest
// even; the remainder exact before its rounding), and a b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi, small terms first, accumulated in float. The
// dropped a_lo b_lo is ~2^-22 of the product, next to float32's own
// rounding; one TF32 product alone keeps ~2^-11 and fails the float32
// limits. The rounding is cvt.rn.tf32.f32, one instruction on sm_90 (the
// split is these kernels' largest cost after the products), and a NaN stays
// NaN through it, so a NaN reaches the rows it reaches in the reference.
// Integer rounding on the float's bits (add 0x1000, clear 13 bits) would
// carry the card's NaN 0x7fffffff into the sign (-0) and drop it; guarding
// that with selects costs ~40%, and cvt.rna.tf32.f32 compiles to about four
// instructions.
//
// The tensor cores truncate the sum they write back, so every product added
// to an accumulator costs up to an ulp of it: no chain of tensor-core sums
// may be long. Each kernel sums a short run of products from zero (an 8-wide
// step of a score product, one streamed tile of a gradient or output
// product) and joins it to its float accumulator in one rounded FADD.
//
// Fragment order (mma.sync m16n8k8: A rows g and g + 8, columns t and t + 4;
// B rows t and t + 4, column g; the accumulator rows g and g + 8, columns 2t
// and 2t + 1, for g = lane / 4, t = lane % 4). A product whose reduced index
// is a head dim relabels it (k-index t is dim 2t, t + 4 is dim 2t + 1), so an
// A or B fragment is one 8-byte load of dims (2t, 2t + 1) of a row. A
// product whose reduced index is the score's column (keys or queries)
// relabels it the same way, so the score accumulator's registers are the A
// fragment as they are, and the B operand is read at rows 2t and 2t + 1.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace tf32 {

// x rounded to TF32 (10 mantissa bits, the low 13 bits zero), to nearest
// even; an inf or NaN stays one
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (hi rounded to nearest, lo the exact remainder
// rounded the same way)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// d += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), d 16x8 float
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, b split: the two small terms first, then hi hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// the same for kTiles row tiles of a against one b (b0, b1), split once
template <int kTiles>
__device__ __forceinline__ void mma_3xtf32(float (&d)[kTiles][4],
                                           const uint32_t (&ah)[kTiles][4],
                                           const uint32_t (&al)[kTiles][4],
                                           float b0, float b1) {
  uint32_t bh[2], bl[2];
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
#pragma unroll
  for (int r = 0; r < kTiles; ++r) mma_3xtf32(d[r], ah[r], al[r], bh, bl);
}

// one row tile of the same
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh[2], bl[2];
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  mma_3xtf32(d, ah, al, bh, bl);
}

// A fragment for head dims 8kk..8kk+7 (relabelled: dims 2t, 2t+1 of rows g
// and g + 8) of a tile whose row g is `row`, split into hi and lo
template <int kStride>
__device__ __forceinline__ void a_fragment(const float* row, int kk, int t,
                                           uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(row + kk * 8 + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(row + 8 * kStride + kk * 8 + 2 * t);
  split_tf32(x0.x, ah[0], al[0]);
  split_tf32(x1.x, ah[1], al[1]);
  split_tf32(x0.y, ah[2], al[2]);
  split_tf32(x1.y, ah[3], al[3]);
}

// A fragment of a score-layout accumulator (x[0..3]: rows g, g + 8, columns
// 2t, 2t + 1 of an 8-column step), relabelled (k-index t is column 2t, t + 4
// is 2t + 1), split into hi and lo
__device__ __forceinline__ void score_fragment(const float (&x)[4],
                                               uint32_t (&ah)[4],
                                               uint32_t (&al)[4]) {
  split_tf32(x[0], ah[0], al[0]);
  split_tf32(x[2], ah[1], al[1]);
  split_tf32(x[1], ah[2], al[2]);
  split_tf32(x[3], ah[3], al[3]);
}

// rows row0 .. row0 + kRows - 1 of a [S, D] float matrix (row r at
// src + r * stride) into shared memory rows of kStride floats, by kThreads
// threads; rows at or past n_rows are zero-filled (and not read). One pass
// of the block copies kPass rows; the passes stay a loop (unrolled, their
// addresses would be hoisted out of the tile loop and held in registers,
// which spills). Every source row must be 16-byte aligned.
template <int D, int kRows, int kStride, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int row0,
                                          int n_rows, int tid) {
  constexpr int kPerRow = D / 4;  // 16-byte copies per row
  constexpr int kPass = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kRows % kPass == 0,
                "whole rows a pass, whole passes a tile");
  const int c = (tid % kPerRow) * 4;
  int r = tid / kPerRow;
  const float* from = src + (int64_t)(row0 + r) * stride + c;
  uint32_t to = hopper::smem_u32(dst + r * kStride + c);
#pragma unroll 1
  for (; r < kRows; r += kPass) {
    const bool ok = row0 + r < n_rows;
    pt::cp_async16(to, ok ? from : src, ok);
    from += kPass * stride;
    to += kPass * kStride * sizeof(float);
  }
}

// A tile read two ways: as the B operand of a score product (rows g, dims
// 2t and 2t + 1: 8-byte loads) and of a gradient product (rows 2t and
// 2t + 1, dim g: 4-byte loads). A padded stride serves one or the other
// (D + 8 the first, D + 4 the second), so such a tile has rows of D floats
// whose 8-float groups are XOR-swizzled by the row: element (r, c) lies at
// r D + (c ^ 8 swz(r)), swz(r) = (r ^ r / 2) % 4. Among rows g = 0..3 (and
// 4..7), and among rows 2t (and 2t + 1) for t = 0..3, swz takes four
// distinct values, so both reads hit 32 distinct banks. The XOR keeps every
// aligned group of 4 floats together, so a 16-byte copy stays one.
__device__ __forceinline__ int swz(int r) { return ((r ^ (r >> 1)) & 3) << 3; }

// load_rows into a swizzled [kRows][D] tile
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows_swizzled(float* dst,
                                                   const float* src,
                                                   int64_t stride, int row0,
                                                   int n_rows, int tid) {
  constexpr int kPerRow = D / 4;
  constexpr int kPass = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kRows % kPass == 0,
                "whole rows a pass, whole passes a tile");
  const int c = (tid % kPerRow) * 4;
  int r = tid / kPerRow;
  const float* from = src + (int64_t)(row0 + r) * stride + c;
  const uint32_t to = hopper::smem_u32(dst);
#pragma unroll 1
  for (; r < kRows; r += kPass) {
    const bool ok = row0 + r < n_rows;
    pt::cp_async16(to + (r * D + (c ^ swz(r))) * sizeof(float),
                   ok ? from : src, ok);
    from += kPass * stride;
  }
}

}  // namespace tf32
