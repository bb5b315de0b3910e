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
// tensor cores' dense rate, and only if the loads hide behind it.
//
// What the design does about it: bf16 and f16 inputs take the
// warp-specialised kernel below (one template over the element type: the
// tensor maps' data type, the wgmma kind and the rounding of P and of the
// output follow it): TMA loads into a two-stage K/V ring in shared memory, one
// producer warpgroup and two consumer warpgroups that run both products with
// wgmma (the second straight from the V tile as TMA wrote it), the softmax in
// registers, the mask only on tiles that need one, and the heaviest causal
// blocks first (the Hopper pieces live in hopper.cuh). float32 inputs take a
// float-FMA kernel (exact float32, held to the 67 TFLOP/s float rate): each
// block keeps a 64-row query tile and one 64-row key/value tile in shared
// memory (padded rows, so column reads hit distinct banks), and every thread
// owns a 4x4 score tile and a 4x(D/16) output tile in registers. Both stop
// causal blocks at the diagonal and mask ragged sequence lengths at the edge,
// so any S runs (the TPU's multiple-of-128 gate does not carry over).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256; // 16 x 16 threads

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) +
                  3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, float scale, int causal) {
  constexpr int DP = D + 1;    // padded float row stride of the Q/K tiles
  constexpr int SP = kBK + 1;  // padded row stride of the score tile
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;    // [kBK][DP]
  float* Vs = Ks + kBK * DP;    // [kBK][D]
  float* Ss = Vs + kBK * D;     // [kBQ][SP] scores, then probabilities
  float* m_s = Ss + kBQ * SP;   // [kBQ] running max
  float* l_s = m_s + kBQ;       // [kBQ] running denominator
  float* a_s = l_s + kBQ;       // [kBQ] this tile's rescale factor

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qs[r * DP + d] = s < Sq ? pt::to_float(qb[s * q_ss + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = pt::kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: only key tiles at or below the diagonal of this query tile
  const int q_hi = min(q0 + kBQ, Sq);
  const int k_end = causal ? min(q_hi, Sk) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      const bool ok = s < Sk;
      Ks[r * DP + d] = ok ? pt::to_float(kb[s * k_ss + d]) : 0.f;
      Vs[r * D + d] = ok ? pt::to_float(vb[s * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty*4+i, columns tx+16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float s = sc[i][j] * scale;
        if (kpos >= Sk || (causal && kpos > q0 + r)) s = pt::kNegInf;
        Ss[r * SP + c] = s;
      }
    }
    __syncthreads();

    // online softmax: each warp owns kBQ/8 rows, a lane two columns
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float s0 = Ss[r * SP + lane];
      const float s1 = Ss[r * SP + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, pt::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float psum = pt::warp_sum(p0 + p1);
      Ss[r * SP + lane] = p0;
      Ss[r * SP + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int s = q0 + r;
    if (s >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + (((int64_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = pt::from_float<T>(acc[i][j] / l);
    if (tx == 0) lse[(int64_t)bh * Sq + s] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Sq, int Sk, int64_t q_sb,
                   int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                   int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Sk, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
// after the launch (0 = launched); a shape it does not take returns
// cudaErrorInvalidValue without launching.
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
  if (dtype == pt::kFloat32 && D == 64) return launch<float, 64>(PT_FLASH_ARGS);
  if (dtype == pt::kFloat32 && D == 128)
    return launch<float, 128>(PT_FLASH_ARGS);
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
