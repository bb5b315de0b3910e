// Flash-attention forward for Hopper (sm_90a): the port of the TPU kernel
// paddle_tpu/ops/pallas_attention.py::_mha_fwd (kernel body _mha_fwd_kernel,
// pl.pallas_call at :135).
//
// What it computes: out = softmax(q k^T * scale [+ causal mask]) v per (batch,
// head), and the row logsumexp lse = m + log(l), with the online softmax kept
// in float (running max m, denominator l, accumulator), NEG_INF = -1e30 as the
// mask value and l clamped at 1e-30, exactly as the reference.
//
// Layout: q/k/v are read in the [B, S, H, D] layout the serving prefill
// receives, through their batch/sequence/head strides (the last dim must be
// contiguous), so the head-major qkv split of the GPT layer needs no copy.
// out is a contiguous [B, Sq, H, D] in the input type, lse a contiguous
// [B*H, Sq] float (the TPU's 128-lane replication of lse is dropped).
//
// What bounds it on the H100: at prefill and training widths (S up to 2048,
// D=128) the work is 4*S^2*D/2 flops per (batch, head) against 4*S*D elements
// moved, so it is bound by operations: in bf16 and f16 only wgmma reaches the
// tensor cores' dense rate, and only if the loads hide behind it; in float32
// the tensor cores take TF32, and float32 accuracy costs three TF32 products
// per product (495 / 3 TFLOP/s, against 67 for float FMAs).
//
// What the design does about it: bf16 and f16 inputs take the
// warp-specialised kernel below (one template over the element type: the
// tensor maps' data type, the wgmma kind and the rounding of P and of the
// output follow it): TMA loads into a two-stage K/V ring in shared memory, one
// producer warpgroup and two consumer warpgroups that run both products with
// wgmma (the second straight from the V tile as TMA wrote it), the softmax in
// registers, the mask only on tiles that need one, and the heaviest causal
// blocks first (the Hopper pieces live in hopper.cuh). float32 inputs take a
// tensor-core kernel in 3xTF32 (the next section): both products on mma.sync
// with each operand split into TF32 hi + lo parts, the softmax in registers,
// K/V tiles in a two-stage cp.async ring. Both stop causal blocks at the
// diagonal and mask ragged sequence lengths at the edge, so any S runs (the
// TPU's multiple-of-128 gate does not carry over).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ----------------------------------------------------------- float32 path
// float32 on tensor cores (flash_fwd_tf32_kernel) in 3xTF32: the split,
// the products, the fragment order and why no chain of tensor-core sums is
// long are in tf32.cuh.
//
// A block owns kRows query rows of one (batch, head): four warps, each
// running mma.sync m16n8k8 (tf32 in, float accumulators) for kTiles tiles
// of 16 rows over the whole key range, so that every K or V fragment it
// loads and splits feeds kTiles row tiles. K and V stream in tiles of kKeys
// keys through a two-stage ring in shared memory filled by 16-byte cp.async
// copies (every row of q, k and v 16-byte aligned: the wrapper copies a view
// that is not), so tile n + 1's loads run under tile n's products. The
// scores and the online softmax stay in registers (a row's max and sum are
// two quad shuffles: a row of the m16n8 accumulator belongs to the four
// threads of a quad).
// Accumulation. The tensor cores truncate the sum they write back, so every
// product added to an accumulator costs up to an ulp of it: an output
// accumulated over the whole key range read several times float32's own
// rounding against a float64 reference, and failed the training parity's
// float32 limits. So no chain is long: each 8-dim step of Q K^T sums its
// three products from zero and joins the scores in one rounded FADD, and
// each key tile's P V sums from zero and joins the output in one rounded
// FFMA with the rescale; both together put the kernel at the float FMA
// kernel's distance from float64 (chip_smoke.py's ref64_err). The softmax
// keeps s scale, its max and lse in natural units, as the reference (a
// log2-domain max puts one rounding more into lse).
// Fragment order. The accumulator gives a thread score columns (2t, 2t+1) of
// each 8-key step, the A operand wants columns (t, t+4): the P V product
// relabels its keys instead (logical k-index t is key 2t, t + 4 is key 2t+1),
// so P goes from the score registers to the A operand as it is, and V is read
// at keys 2t and 2t+1. Q K^T relabels its head dims the same way, so a Q or K
// fragment is one 8-byte load of dims (2t, 2t+1).
// Shared-memory strides: Q and K rows D + 8 floats, so the 8-byte loads of a
// half-warp (rows g, dims 2t) hit 32 distinct banks; V rows D + 4, so the
// relabelled loads (keys 2t or 2t+1, dim g) do too. Both keep rows 16-byte
// aligned for cp.async.
// Q is split per fragment as it is read from shared memory.
// Sizes, chosen on the card: at D=64 two row tiles a warp (128-row blocks)
// were faster than one row tile with Q's hi/lo fragments kept in registers
// from S=256 on, and a little slower at S=128; 32-key tiles hold the scores
// of two row tiles in registers without spilling (64-key tiles spilled) and
// keep a block at ~71 KB of shared memory (~101 KB at D=128, one row tile:
// two spilled there and were slower), so two blocks fit an SM at both head
// dims. The Q K^T step loop stays rolled: unrolled, its per-step sums
// spilled.
constexpr int kF32Threads = 128;  // four warps

template <int D>
struct F32Tile {
  static constexpr int kTiles = D == 64 ? 2 : 1;   // 16-row tiles a warp
  static constexpr int kRows = 4 * 16 * kTiles;    // query rows a block
  static constexpr int kKeys = 32;                 // keys per K/V tile
  static constexpr int kQStride = D + 8;
  static constexpr int kKStride = D + 8;
  static constexpr int kVStride = D + 4;
  static constexpr int kQFloats = kRows * kQStride;
  static constexpr int kKFloats = kKeys * kKStride;
  static constexpr int kVFloats = kKeys * kVStride;
  static constexpr int kStages = 2;
  static constexpr size_t kBytes =
      sizeof(float) * (kQFloats + kStages * (kKFloats + kVFloats));
};

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, int H, int Sq, int Sk,
                          int64_t q_sb, int64_t q_ss, int64_t q_sh,
                          int64_t k_sb, int64_t k_ss, int64_t k_sh,
                          int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          float scale, int causal) {
  using L = F32Tile<D>;
  constexpr int kT = L::kTiles;
  constexpr int kKeys = L::kKeys;
  constexpr int kN = kKeys / 8;  // 8-key steps of a tile
  constexpr int kDK = D / 8;     // 8-dim steps of a row
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;                       // [kRows][kQStride]
  float* Ks = Qs + L::kQFloats;               // [stage][kKeys][kKStride]
  float* Vs = Ks + L::kStages * L::kKFloats;  // [stage][kKeys][kVStride]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // causal blocks with the most key tiles first
  const int qblock = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qblock * L::kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = q0 + warp * 16 * kT;  // the warp's first query row
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int k_end = causal ? min(q0 + L::kRows, Sk) : Sk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  auto load_kv = [&](int n) {
    const int s = n % L::kStages;
    tf32::load_rows<D, kKeys, L::kKStride, kF32Threads>(
        Ks + s * L::kKFloats, kb, k_ss, n * kKeys, Sk, tid);
    tf32::load_rows<D, kKeys, L::kVStride, kF32Threads>(
        Vs + s * L::kVFloats, vb, v_ss, n * kKeys, Sk, tid);
  };
  tf32::load_rows<D, L::kRows, L::kQStride, kF32Threads>(
      Qs, q + b * q_sb + h * q_sh, q_ss, q0, Sq, tid);
  load_kv(0);
  pt::cp_async_commit();  // Q and tile 0
  if (n_tiles > 1) load_kv(1);
  pt::cp_async_commit();  // tile 1 (or nothing)

  // row g of the warp's first row tile in the Q tile
  const float* qrow = Qs + (warp * 16 * kT + g) * L::kQStride;
  float o[kDK][kT][4];
#pragma unroll
  for (int j = 0; j < kDK; ++j)
#pragma unroll
    for (int r = 0; r < kT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][r][e] = 0.f;
  // running max and (this thread's columns only) sum of rows g, g + 8 of
  // each row tile
  float m[kT][2], l[kT][2];
#pragma unroll
  for (int r = 0; r < kT; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[r][i] = pt::kNegInf;
      l[r][i] = 0.f;
    }

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kKeys;
    const float* Kt = Ks + (n % L::kStages) * L::kKFloats;
    const float* Vt = Vs + (n % L::kStages) * L::kVFloats;
    pt::cp_async_wait<1>();  // every group but the newest: tile n is here
    __syncthreads();
    // a warp whose rows all lie above this causal tile has nothing in it
    if (!(causal && k0 > wrow + 16 * kT - 1)) {
      // S = Q K^T (raw scores; rows g and g + 8, keys 8j + 2t + {0, 1})
      float sc[kN][kT][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int r = 0; r < kT; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][r][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < kDK; ++kk) {
        uint32_t ah[kT][4], al[kT][4];
#pragma unroll
        for (int r = 0; r < kT; ++r)
          tf32::a_fragment<L::kQStride>(qrow + 16 * r * L::kQStride, kk, t,
                                        ah[r], al[r]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Kt + (8 * j + g) * L::kKStride + kk * 8 + 2 * t);
          float st[kT][4] = {};
          tf32::mma_3xtf32<kT>(st, ah, al, kv.x, kv.y);
#pragma unroll
          for (int r = 0; r < kT; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][r][e] += st[r][e];
        }
      }
      // online softmax: scores, max and lse in natural units (s scale, as
      // the reference), p = 2^(s log2 e - m log2 e) in one FFMA; only
      // tiles that reach past Sk or above the warp's first row build a
      // mask
      const bool edge = k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > wrow);
      float alpha[kT][2];
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        float mx[2] = {m[r][0], m[r][1]};
#pragma unroll
        for (int j = 0; j < kN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[j][r][e] * scale;
            if (edge) {
              const int kpos = k0 + 8 * j + 2 * t + (e & 1);
              const int qpos = wrow + 16 * r + g + 8 * (e >> 1);
              if (kpos >= Sk || (causal && kpos > qpos)) x = pt::kNegInf;
            }
            sc[j][r][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(pt::kFullMask, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(pt::kFullMask, mx[i], 2));
          alpha[r][i] = hopper::exp2_approx((m[r][i] - mx[i]) * kLog2e);
          m[r][i] = mx[i];
          l[r][i] *= alpha[r][i];
        }
        const float ml[2] = {m[r][0] * kLog2e, m[r][1] * kLog2e};
#pragma unroll
        for (int j = 0; j < kN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][r][e] =
                hopper::exp2_approx(fmaf(sc[j][r][e], kLog2e, -ml[e >> 1]));
            l[r][e >> 1] += sc[j][r][e];
          }
      }
      // O = O alpha + P V: keys 8j..8j+7 relabelled (k-index t is key 2t,
      // t + 4 is key 2t + 1), so the A fragment is the score registers in
      // place. Each output column block sums this tile's products in
      // registers of its own and joins O in one rounded FFMA: the tensor
      // cores truncate what they add to an accumulator, so O itself is
      // never one.
      uint32_t ph[kN][kT][4], pl[kN][kT][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int r = 0; r < kT; ++r)
          tf32::score_fragment(sc[j][r], ph[j][r], pl[j][r]);
      const float* v0 = Vt + 2 * t * L::kVStride + g;
#pragma unroll
      for (int dn = 0; dn < kDK; ++dn) {
        float pv[kT][4] = {};
#pragma unroll
        for (int j = 0; j < kN; ++j)
          tf32::mma_3xtf32<kT>(pv, ph[j], pl[j],
                               v0[8 * j * L::kVStride + dn * 8],
                               v0[(8 * j + 1) * L::kVStride + dn * 8]);
#pragma unroll
        for (int r = 0; r < kT; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[dn][r][e] = fmaf(o[dn][r][e], alpha[r][e >> 1], pv[r][e]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (n + 2 < n_tiles) load_kv(n + 2);
    pt::cp_async_commit();
  }

  // out = o / l, lse = m + log(l), rows g and g + 8 of each row tile
#pragma unroll
  for (int r = 0; r < kT; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lr = l[r][i];
      lr += __shfl_xor_sync(pt::kFullMask, lr, 1);
      lr += __shfl_xor_sync(pt::kFullMask, lr, 2);
      const int s = wrow + 16 * r + g + 8 * i;
      if (s >= Sq) continue;
      // l clamped at 1e-30, a NaN l kept (fmaxf would drop it from lse)
      const float lc = lr < 1e-30f ? 1e-30f : lr;
      if (t == 0) lse[(int64_t)bh * Sq + s] = m[r][i] + logf(lc);
      float* orow = out + (((int64_t)b * Sq + s) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < kDK; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[j][r][2 * i] / lc, o[j][r][2 * i + 1] / lc);
    }
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Sq, int Sk,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                        int64_t v_sh, float scale, int causal,
                        cudaStream_t stream) {
  // the 16-byte copies need every row of q, k and v 16-byte aligned
  for (const void* p : {q, k, v})
    if ((uintptr_t)p % 16) return cudaErrorInvalidValue;
  for (int64_t st : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh})
    if (st % 4) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tf32_kernel<D>;
  const size_t smem = F32Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = F32Tile<D>::kRows;
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Sq, Sk,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
  return cudaGetLastError();
}


// --------------------------------------------------- bf16 and f16 path
// The 16-bit forward (T = __nv_bfloat16 or __half) is warp-specialised for
// Hopper. A block owns 128 query
// rows of one (batch, head) and runs three warpgroups:
// - warpgroup 0 is the producer: one thread loads the Q tile once and then
//   K and V tiles of 128 keys by TMA into a ring of kStages stages (128-byte
//   swizzled; per stage a full and an empty barrier for K and for V, so a K
//   slot is refilled as soon as its scores are done), and it hands most of
//   its registers to the consumers (setmaxnreg: 24 for it, 240 for them);
// - warpgroups 1 and 2 are consumers, 64 query rows each: S = Q K^T by
//   wgmma with both operands in shared memory (K-major), the online softmax
//   in registers (log2 domain; with a positive scale the max is taken over
//   the raw scores and the scale folds into one FFMA per element; only
//   tiles that touch the causal diagonal or the ragged end of the keys
//   build a mask), then O += P V by wgmma with P as the register operand
//   (the score accumulator narrowed to T in place, as the reference rounds
//   p to v's type) and V read MN-major straight from its TMA tile
//   (transpose bit, no transposed copy).
// Each consumer overlaps the softmax of tile n with the P V product of tile
// n - 1 (both products are issued before it waits for the first), and the
// two consumers take turns to issue, so one's softmax runs while the
// other's products hold the tensor cores. That needs about 200 registers a
// consumer thread, more than the 168 a 384-thread block starts with: the
// producer gives its registers up.
// The epilogue divides by l, stages each warpgroup's 64 x D output (rounded
// to T: a value beyond float16's range becomes inf, as the reference's cast
// makes it) in its own rows of the Q tile and stores it as 16-byte vectors; lse is written
// per row. Heads run in groups whose K/V fit in L2 together, the heaviest
// causal blocks of a group first, and no block loads a tile above its
// diagonal. TMA fills rows past S with zeros, so any S runs and the ragged
// edge needs only the softmax mask.

constexpr int kBM = 128;       // query rows per block (2 consumers x 64)
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kWsThreads = 384;
constexpr int kConsumerWarps = 8;  // each releases a stage with one arrival
// the consumers take turns to issue their products: while one runs its
// softmax the other's wgmma have the tensor cores (named barriers 3 and 4;
// 1 and 2 are the epilogue's)
constexpr int kTurnBarrier = 3;
constexpr int kScores = kBN / 2;  // score accumulators per thread
// K/V bytes that one group of heads may keep in the 50 MB L2
constexpr int64_t kL2Budget = 24ll << 20;
// shared memory of one block: Q [D/64][kBM][64], then kStages K tiles and
// kStages V tiles [D/64][kBN][64] (every box 1024-byte aligned), then the
// barriers
template <int D>
struct FwdSmem {
  static constexpr uint32_t kBoxRowBytes = 128;  // 64 16-bit elements
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kKVBytes = kBN * D * 2;  // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr size_t kDynamic = kBytes + 1024;  // alignment slack
};

// S = Q K^T for one consumer's 64 rows and a tile of kBN keys, issued (not
// waited for): q is the consumer's first Q row in the first 64-column box,
// k the stage's K tile. K = D in steps of 16 (32 bytes inside a box).
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kScores], uint32_t q,
                                         uint32_t k) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = hopper::desc_sw128(
        q + (kk / 4) * kBM * FwdSmem<D>::kBoxRowBytes + col, 16, 1024);
    const uint64_t db = hopper::desc_sw128(
        k + (kk / 4) * kBN * FwdSmem<D>::kBoxRowBytes + col, 16, 1024);
    hopper::wgmma_m64n128k16_ss<T>(sc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V, issued: V [keys][D] is MN-major for this product; a step of 16
// keys is 16 rows (2048 bytes), the 64-column boxes lie kBN rows apart
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = hopper::desc_sw128(
        v + kk * 16 * FwdSmem<D>::kBoxRowBytes,
        kBN * FwdSmem<D>::kBoxRowBytes, 1024);
    hopper::wgmma_rs<T, D, 1>(o, pa[kk], db, 1);
  }
  hopper::wgmma_commit();
}

// One tile of the online softmax over this thread's rows g (i = 0) and g + 8
// (i = 1), each spread over the four threads of a group: the mask where
// `edge` says the tile needs one, the new running max m (log2 units), the
// rescale factor alpha of the earlier sums, l updated; sc becomes p. With
// a positive scale (kPositiveScale) the max is taken over the raw scores and
// the scale folds into one FFMA per element, p = 2^(s c - m); otherwise each
// score is scaled first.
template <bool kPositiveScale>
__device__ __forceinline__ void online_softmax(
    float (&sc)[kScores], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale_log2, bool edge, int k0, int Sk, int causal,
    const int (&qpos)[2], int t) {
  float mx[2] = {pt::kNegInf, pt::kNegInf};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = kPositiveScale ? sc[4 * j + e] : sc[4 * j + e] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        if (kpos >= Sk || (causal && kpos > qpos[i])) x = pt::kNegInf;
      }
      sc[4 * j + e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(pt::kFullMask, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(pt::kFullMask, mx[i], 2));
    const float m_new =
        fmaxf(m[i], kPositiveScale ? mx[i] * scale_log2 : mx[i]);
    alpha[i] = hopper::exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int e = 0; e < kScores; ++e) {
    const int i = (e >> 1) & 1;
    sc[e] = hopper::exp2_approx(kPositiveScale ? fmaf(sc[e], scale_log2, -m[i])
                                               : sc[e] - m[i]);
    rs[i] += sc[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(pt::kFullMask, rs[i], 1);
    rs[i] += __shfl_xor_sync(pt::kFullMask, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
}

// p (the score accumulator layout) to the A operand of P V: keys
// 16kk..16kk+15 are sc[8kk..8kk+7], two T to a register
template <typename T>
__device__ __forceinline__ void narrow_p(const float (&p)[kScores],
                                         uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pt::pack2<T>(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
}

template <typename T, int D, bool kPositiveScale>
__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
    float* __restrict__ lse, int BH, int H, int Sq, int Sk, int group,
    float scale_log2, int causal) {
  using L = FwdSmem<D>;
  constexpr int kHalves = D / 64;       // 64-column boxes per row
  constexpr int kAcc = D / 2;           // output accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;  // each + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  // Heads run in groups of `group` whose K/V fit in L2 together; inside a
  // group the heaviest q-blocks (the last rows, under a causal mask) of all
  // its heads start first.
  const int n_qblocks = (Sq + kBM - 1) / kBM;
  const int first = blockIdx.x / (group * n_qblocks) * group;
  const int in_group = blockIdx.x % (group * n_qblocks);
  const int heads = min(group, BH - first);
  const int bh = first + in_group % heads;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (n_qblocks - 1 - in_group / heads) * kBM;
  const int k_end = causal ? min(q0 + kBM, Sk) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, kConsumerWarps);
      hopper::mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the role branch must be provably warp-uniform for ptxas to give each
  // role its own register budget (setmaxnreg)
  const int wg = __shfl_sync(pt::kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        hopper::tma_load_4d(sQ + c * kBM * L::kBoxRowBytes, &tm_q, q_full,
                            c * 64, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
        const int k0 = n * kBN;
        hopper::mbar_wait(k_empty + 8 * s, free_parity);
        hopper::mbar_arrive_expect_tx(k_full + 8 * s, L::kKVBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_4d(sK + s * L::kKVBytes + c * kBN * L::kBoxRowBytes,
                              &tm_k, k_full + 8 * s, c * 64, h, k0, b);
        hopper::mbar_wait(v_empty + 8 * s, free_parity);
        hopper::mbar_arrive_expect_tx(v_full + 8 * s, L::kKVBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_4d(sV + s * L::kKVBytes + c * kBN * L::kBoxRowBytes,
                              &tm_v, v_full + 8 * s, c * 64, h, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hopper::setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;               // consumer warpgroup: rows cw*64..
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wrow = cw * 64 + warp * 16 + g;  // block rows wrow, wrow + 8
    const int qpos[2] = {q0 + wrow, q0 + wrow + 8};
    const int cw_first = q0 + cw * 64;  // this warpgroup's first query row
    const uint32_t q_rows = sQ + cw * 64 * L::kBoxRowBytes;
    // a tile needs the mask if it reaches past Sk or above the diagonal
    // of this warpgroup's first row
    auto edge = [&](int k0) {
      return k0 + kBN > Sk || (causal && k0 + kBN - 1 > cw_first);
    };
    // a warp hands a K or V slot back once its wgmma reads are done
    auto release = [&](uint32_t bar) {
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    // every wait for this warpgroup's turn is matched by one hand-over from
    // the other: the second warpgroup lets the first go first and does not
    // hand over after its last issue
    auto my_turn = [&] {
      hopper::named_barrier_sync(kTurnBarrier + cw, 256);
    };
    auto their_turn = [&] {
      hopper::named_barrier_arrive(kTurnBarrier + 1 - cw, 256);
    };
    if (cw == 1) their_turn();

    float o[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    float m[2] = {pt::kNegInf, pt::kNegInf};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float sc[kScores];
    uint32_t pa[kBN / 16][4];

    // tile 0: scores and probabilities only
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full, 0);
    my_turn();
    issue_qk<T, D>(sc, q_rows, sK);
    their_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);
    release(k_empty);
    online_softmax<kPositiveScale>(sc, m, l, alpha, scale_log2, edge(0), 0,
                                   Sk, causal, qpos, t);
    narrow_p<T>(sc, pa);

    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int ps = (n - 1) % kStages;
      const int k0 = n * kBN;
      // scores of tile n and O += P V of tile n - 1, both in flight
      hopper::mbar_wait(k_full + 8 * s, (n / kStages) & 1);
      hopper::mbar_wait(v_full + 8 * ps, ((n - 1) / kStages) & 1);
      my_turn();
      issue_qk<T, D>(sc, q_rows, sK + s * L::kKVBytes);
      issue_pv<T, D>(o, pa, sV + ps * L::kKVBytes);
      their_turn();
      hopper::wgmma_wait<1>();  // the scores
      hopper::fence_operands(sc);
      release(k_empty + 8 * s);
      online_softmax<kPositiveScale>(sc, m, l, alpha, scale_log2, edge(k0),
                                     k0, Sk, causal, qpos, t);
      hopper::wgmma_wait<0>();  // P V of tile n - 1
      hopper::fence_operands(o);
      release(v_empty + 8 * ps);
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      narrow_p<T>(sc, pa);
    }
    {
      const int n = n_tiles - 1;
      const int s = n % kStages;
      hopper::mbar_wait(v_full + 8 * s, (n / kStages) & 1);
      my_turn();
      issue_pv<T, D>(o, pa, sV + s * L::kKVBytes);
      if (cw == 0) their_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      release(v_empty + 8 * s);
    }

    // ------------------------------------------------------- epilogue
    // out = o / l, lse = m ln 2 + log(l). The warpgroup's own rows of the
    // Q tile are free now (only its own products read them): stage the
    // T rows there, 128-byte rows with 16-byte chunks swizzled by row,
    // then store them as 16-byte vectors.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lc = fmaxf(l[i], 1e-30f);
      inv[i] = 1.f / lc;
      if (t == 0 && qpos[i] < Sq)
        lse[(int64_t)bh * Sq + qpos[i]] = m[i] * kLn2 + logf(lc);
    }
    unsigned char* stage = smem + L::kQ + cw * 64 * L::kBoxRowBytes;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;  // row in the warpgroup's 64
        const uint32_t off = (j / 8) * kBM * L::kBoxRowBytes +
                             r * L::kBoxRowBytes +
                             (((j % 8) ^ (r & 7)) * 16) + t * 4;
        *reinterpret_cast<uint32_t*>(stage + off) = pt::pack2<T>(
            o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
    hopper::named_barrier_sync(1 + cw, 128);
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int idx = ct & 127; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int j = idx % kChunks;
      const int sq = cw_first + r;
      if (sq >= Sq) continue;
      const uint32_t off = (j / 8) * kBM * L::kBoxRowBytes +
                           r * L::kBoxRowBytes + (((j % 8) ^ (r & 7)) * 16);
      const uint4 val = *reinterpret_cast<const uint4*>(stage + off);
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + sq) * H + h) * D +
                                j * 8) = val;
    }
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Sq, int Sk,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                        int64_t v_sh, float scale, int causal,
                        cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hopper_host::encode_bshd<T>(&tm_q, q, B, Sq, H, D, q_sb, q_ss, q_sh,
                                    kBM) ||
      !hopper_host::encode_bshd<T>(&tm_k, k, B, Sk, H, D, k_sb, k_ss, k_sh,
                                    kBN) ||
      !hopper_host::encode_bshd<T>(&tm_v, v, B, Sk, H, D, v_sb, v_ss, v_sh,
                                    kBN))
    return cudaErrorInvalidValue;
  const size_t smem = FwdSmem<D>::kDynamic;
  const bool positive = scale > 0.f;
  auto kernel = positive ? flash_fwd_wgmma_kernel<T, D, true>
                         : flash_fwd_wgmma_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)B * H * ((Sq + kBM - 1) / kBM);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // heads per group: as few groups as keep a group's K/V within kL2Budget,
  // of equal size
  const int64_t kv_bytes = 4ll * Sk * D;  // K and V of one head, 16-bit
  const int64_t n_groups =
      std::max<int64_t>(1, ((int64_t)B * H * kv_bytes + kL2Budget - 1) /
                               kL2Budget);
  const int group = (int)(((int64_t)B * H + n_groups - 1) / n_groups);
  kernel<<<(unsigned)blocks, kWsThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), lse, B * H, H, Sq,
      Sk, group, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// Name of a CUDA error code, for the wrappers' messages.
extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C entry point bound with ctypes (ops/_build.py). Returns cudaGetLastError()
// after the launch (0 = launched); a shape it does not take, and float32
// rows that are not 16-byte aligned, return cudaErrorInvalidValue without
// launching.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int H, int Sq,
                            int Sk, int D, int64_t q_sb, int64_t q_ss,
                            int64_t q_sh, int64_t k_sb, int64_t k_ss,
                            int64_t k_sh, int64_t v_sb, int64_t v_ss,
                            int64_t v_sh, float scale, int causal, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_FLASH_ARGS                                                     \
  q, k, v, out, lse, B, H, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    \
      v_sb, v_ss, v_sh, scale, causal, st
  if (dtype == pt::kFloat32 && D == 64) return launch_tf32<64>(PT_FLASH_ARGS);
  if (dtype == pt::kFloat32 && D == 128)
    return launch_tf32<128>(PT_FLASH_ARGS);
  if (dtype == pt::kBFloat16 && D == 64)
    return launch_wgmma<__nv_bfloat16, 64>(PT_FLASH_ARGS);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch_wgmma<__nv_bfloat16, 128>(PT_FLASH_ARGS);
  if (dtype == pt::kFloat16 && D == 64)
    return launch_wgmma<__half, 64>(PT_FLASH_ARGS);
  if (dtype == pt::kFloat16 && D == 128)
    return launch_wgmma<__half, 128>(PT_FLASH_ARGS);
#undef PT_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
