// Flash-attention backward for Hopper (sm_90a): the port of the two TPU
// kernels of paddle_tpu/ops/pallas_attention.py::_mha_bwd,
// _mha_bwd_dq_kernel (:162, pallas_call at :288) and _mha_bwd_dkv_kernel
// (:212, pallas_call at :313).
//
// What it computes, per (batch, head), from q, k, v, dO, the forward's row
// logsumexp lse and delta = rowsum(o * dO) (minus an optional lse cotangent,
// folded in by the wrapper):
//   p  = exp(q k^T * scale - lse)          (0 where the causal mask or a
//                                           ragged edge hides the key)
//   dp = dO v^T
//   ds = p * (dp - delta) * scale
//   dq = ds k        dk = ds^T q        dv = p^T dO
// with every product accumulated in float, as the reference; in bf16 and
// f16, p (for dv) and ds (for dq, dk) are rounded to the input type before
// the products that take them, as the reference rounds them. In f16 a ds
// beyond its range (a loss scaled up for dynamic loss scaling) rounds to
// inf, and an inf or NaN in dO flows through: nothing is clamped, so the
// overflow reaches the gradients as the reference's does. Two kernels, as
// on the TPU: dq walks the key tiles of a block of queries, dk/dv walk the
// query tiles of a block of keys. Neither needs atomics, so the gradients
// repeat bit for bit from run to run. p is recomputed from (q, k, lse) in
// both (O(S) memory, no S x S array).
//
// Layout: q/k/v/dO are read in the [B, S, H, D] layout of the GPT layer's
// fused qkv projection through their batch/sequence/head strides (the last
// dim must be contiguous); lse and delta are contiguous [B*H, S] float (the
// TPU's 128-lane replication is dropped); dq, dk, dv are written contiguous
// [B, S, H, D] in the input type.
//
// What bounds it on the H100: dq is 3 products of 2*S^2*D flops per head,
// dk/dv 4, both halved when causal, against ~5*S*D elements moved: at
// training widths (S = 2048, D = 128) it is bound by operations, and in bf16
// and f16 only wgmma reaches the tensor cores' dense rate.
//
// What the design does about it: bf16 and f16 inputs take two
// warp-specialised kernels (templates over the element type) with the forward's shape (csrc/flash_fwd.cu; the Hopper pieces in
// hopper.cuh). A block owns 128 rows (queries for dq, keys for dk/dv) of one
// (batch, head): a producer warpgroup loads them once by TMA and streams the
// other side's tiles of 64 rows through a three-stage mbarrier ring, and two
// consumer warpgroups of 64 rows each run every product with wgmma straight
// from the tiles as TMA wrote them (128-byte swizzled), with no transposed
// copy: the score-side products (S = Q K^T and dP = dO V^T for dq; their
// transposes S^T = K Q^T and dP^T = V dO^T for dk/dv) with both operands
// K-major along D, and the gradient products (dq += ds K; dv += p^T dO,
// dk += ds^T Q) with the rounded p or ds as the register operand (the score
// accumulator's layout is the A operand's) and the streamed tile read
// MN-major through the descriptor's transpose bit. The two consumers take
// turns to issue, so one builds p and ds in registers while the other's
// products hold the tensor cores. A dq consumer also overlaps its own work:
// it issues the score products of tile n with dQ += dS K of tile n - 1 and
// builds dS of tile n while the latter runs. A dk/dv consumer cannot: with
// dK and dV (128 floats a thread at D = 128) pinned, the next tile's S^T and
// dP^T (64) beside this tile's 16-bit P^T and dS^T operands (32) exceed the
// 240 registers a consumer gets, and ptxas spilled and serialized the wgmma
// (C7518); so it issues the score products, waits, builds P^T and dS^T,
// issues the gradient products, and waits. dk/dv needs the lse and delta of
// its tile's query columns: the producer loads them with the tile (a 1-D
// tensor map over the flattened [B*H, S] floats). The mask is built only on tiles that touch the causal
// diagonal or a ragged end (TMA zero-fills rows past S, and the mask hides
// them), the heaviest causal blocks start first inside head groups whose
// streamed tensors fit in L2, and the epilogue stages each warpgroup's rows
// in its own freed rows of shared memory for 16-byte stores. float32 inputs
// take float-FMA kernels (exact float32, held to the 67 TFLOP/s float rate)
// over 64x64 tiles in shared memory, as the forward's float32 path. Causal
// tiles stop at the diagonal and ragged sequence lengths are masked at the
// edge, so every S the forward takes has a backward (the TPU's
// multiple-of-128 gate and its XLA crossover below S = 1024 do not carry
// over).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Sq]
  const float* delta;  // [B*H, Sq]
  void* dq;            // [B, Sq, H, D]
  void* dk;            // [B, Sk, H, D]
  void* dv;            // [B, Sk, H, D]
  int H, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // dO's strides
  float scale;
  int causal;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const BwdArgs& a) {
  return qpos < a.Sq && kpos < a.Sk && (!a.causal || kpos <= qpos);
}

// ------------------------------------------------------------- float32 path
constexpr int kRows = 64;      // rows a block owns (queries, or keys)
constexpr int kTile = 64;      // rows of a streamed tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 score tile

template <int D>
constexpr size_t dq_f32_smem() {
  // Q, dO, K, V tiles [64][D + 1], dS [64][65], lse and delta [64]
  return sizeof(float) *
         (size_t)(4 * kRows * (D + 1) + kRows * (kTile + 1) + 2 * kRows);
}

template <int D>
constexpr size_t dkv_f32_smem() {
  // K, V, Q, dO tiles [64][D + 1], P and dS [64][65], lse and delta [64]
  return sizeof(float) *
         (size_t)(4 * kRows * (D + 1) + 2 * kRows * (kTile + 1) + 2 * kTile);
}

// rows [r0, r0 + 64) of a [S, D] float slice into a [64][D + 1] tile, zeros
// past S
template <int D>
__device__ __forceinline__ void load_f32(const float* __restrict__ g,
                                         int64_t ss, int r0, int S,
                                         float* tile, int tid) {
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    tile[r * (D + 1) + d] = r0 + r < S ? g[(r0 + r) * ss + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(BwdArgs a) {
  constexpr int DP = D + 1;     // padded row stride: column reads hit
  constexpr int SP = kTile + 1;  // distinct banks
  constexpr int DJ = D / 16;     // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kRows * DP;
  float* Ks = Os + kRows * DP;
  float* Vs = Ks + kTile * DP;
  float* Ss = Vs + kTile * DP;   // dS of this tile
  float* lse_s = Ss + kRows * SP;
  float* dl_s = lse_s + kRows;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ob =
      static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_f32<D>(qb, a.q_ss, q0, a.Sq, Qs, tid);
  load_f32<D>(ob, a.o_ss, q0, a.Sq, Os, tid);
  if (tid < kRows) {
    const bool ok = q0 + tid < a.Sq;
    lse_s[tid] = ok ? a.lse[(int64_t)bh * a.Sq + q0 + tid] : 0.f;
    dl_s[tid] = ok ? a.delta[(int64_t)bh * a.Sq + q0 + tid] : 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int q_hi = min(q0 + kRows, a.Sq);
  const int k_end = a.causal ? min(q_hi, a.Sk) : a.Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_f32<D>(kb, a.k_ss, k0, a.Sk, Ks, tid);
    load_f32<D>(vb, a.v_ss, k0, a.Sk, Vs, tid);
    __syncthreads();
    // scores and dP for rows ty*4+i, keys tx+16*j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * DP + d];
        ov[i] = Os[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, a)
                            ? expf(sc[i][j] * a.scale - lse_s[r])
                            : 0.f;
        Ss[r * SP + c] = p * (dp[i][j] - dl_s[r]) * a.scale;
      }
    }
    __syncthreads();
    // dq += dS K for rows ty*4+i, columns tx+16*j
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ss[(ty * 4 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }
  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= a.Sq) continue;
    float* row = dq + (((int64_t)b * a.Sq + s) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(BwdArgs a) {
  constexpr int DP = D + 1;
  constexpr int SP = kTile + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * DP;
  float* Qs = Vs + kRows * DP;
  float* Os = Qs + kTile * DP;
  float* Ps = Os + kTile * DP;   // p^T of this tile: [key][query]
  float* Ds = Ps + kRows * SP;   // ds^T
  float* lse_s = Ds + kRows * SP;
  float* dl_s = lse_s + kTile;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ob =
      static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_f32<D>(kb, a.k_ss, k0, a.Sk, Ks, tid);
  load_f32<D>(vb, a.v_ss, k0, a.Sk, Vs, tid);
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: query tiles from the one holding query k0 (tiles are aligned)
  const int qt0 = a.causal ? k0 / kTile : 0;
  const int n_tiles = (a.Sq + kTile - 1) / kTile;
  for (int qt = qt0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_f32<D>(qb, a.q_ss, q0, a.Sq, Qs, tid);
    load_f32<D>(ob, a.o_ss, q0, a.Sq, Os, tid);
    if (tid < kTile) {
      const bool ok = q0 + tid < a.Sq;
      lse_s[tid] = ok ? a.lse[(int64_t)bh * a.Sq + q0 + tid] : 0.f;
      dl_s[tid] = ok ? a.delta[(int64_t)bh * a.Sq + q0 + tid] : 0.f;
    }
    __syncthreads();
    // s^T and dP^T for keys ty*4+i, queries tx+16*j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * DP + d];
        vv[i] = Vs[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * DP + d];
        ov[j] = Os[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + c, k0 + r, a)
                            ? expf(sc[i][j] * a.scale - lse_s[c])
                            : 0.f;
        Ps[r * SP + c] = p;
        Ds[r * SP + c] = p * (dp[i][j] - dl_s[c]) * a.scale;
      }
    }
    __syncthreads();
    // dv += p^T dO, dk += ds^T Q for keys ty*4+i, columns tx+16*j
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * SP + c];
        dsv[i] = Ds[(ty * 4 + i) * SP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float ov = Os[c * DP + tx + 16 * j];
        const float qv = Qs[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], ov, dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
        }
      }
    }
  }
  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= a.Sk) continue;
    const int64_t off = (((int64_t)b * a.Sk + s) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[off + tx + 16 * j] = dk[i][j];
      dvp[off + tx + 16 * j] = dv[i][j];
    }
  }
}

// --------------------------------------------------- bf16 and f16 path
// Both kernels (element type T: __nv_bfloat16 or __half) are
// warp-specialised, 384 threads: warpgroup 0 is the
// producer (one thread issues every TMA load; the warpgroup gives most of
// its registers to the consumers, setmaxnreg 24 against 240), warpgroups 1
// and 2 the consumers, 64 of the block's 128 rows each. Shared memory holds
// 16-bit tiles as TMA writes them with SWIZZLE_128B: per 64-column box, one
// 128-byte row per sequence position (hopper.cuh).
constexpr int kBM = 128;           // rows a block owns (2 consumers x 64)
constexpr int kBN = 64;            // rows of a streamed tile
constexpr int kStages = 3;         // ring depth
constexpr int kWsThreads = 384;
constexpr int kConsumerWarps = 8;  // each releases a stage with one arrival
// the consumers take turns to issue their products (named barriers 3 and 4;
// 1 and 2 are the epilogue's)
constexpr int kTurnBarrier = 3;
constexpr uint32_t kRowBytes = 128;  // one row of a 64-column box
constexpr int kAcc = kBN / 2;        // score accumulators per thread
// streamed bytes that one group of heads may keep in the 50 MB L2
constexpr int64_t kL2Budget = 24ll << 20;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of the dq kernel: the block's Q and dO [D/64][kBM][64], then
// kStages K tiles and kStages V tiles [D/64][kBN][64] (every box 1024-byte
// aligned), then the barriers
template <int D>
struct DqSmem {
  static constexpr uint32_t kBlockBytes = kBM * D * 2;  // Q or dO
  static constexpr uint32_t kTileBytes = kBN * D * 2;   // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kO = kQ + kBlockBytes;
  static constexpr uint32_t kK = kO + kBlockBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  // qo_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr size_t kDynamic = kBytes + 1024;  // alignment slack
};

// shared memory of the dk/dv kernel: the block's K and V [D/64][kBM][64],
// then kStages Q tiles and kStages dO tiles [D/64][kBN][64], the tiles' lse
// and delta [kStages][kBN] float, then the barriers
template <int D>
struct DkvSmem {
  static constexpr uint32_t kBlockBytes = kBM * D * 2;  // K or V
  static constexpr uint32_t kTileBytes = kBN * D * 2;   // one Q or dO tile
  static constexpr uint32_t kVecBytes = kBN * 4;        // one tile's lse
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kBlockBytes;
  static constexpr uint32_t kQ = kV + kBlockBytes;
  static constexpr uint32_t kO = kQ + kStages * kTileBytes;
  static constexpr uint32_t kL = kO + kStages * kTileBytes;
  static constexpr uint32_t kDl = kL + kStages * kVecBytes;
  static constexpr uint32_t kBar = kDl + kStages * kVecBytes;
  // kv_full, then per stage full, empty
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr uint32_t kStageTx = 2 * kTileBytes + 2 * kVecBytes;
  static constexpr size_t kDynamic = kBytes + 1024;
};

// The block's (batch * head, first row) on the 1-D grid: heads run in
// groups of `group` whose streamed tensors fit in L2 together; inside a
// group the heaviest blocks of all its heads start first (under a causal
// mask the last query blocks for dq, `last_first`, and the first key blocks
// for dk/dv).
struct BlockPos {
  int bh, r0;
};

__device__ __forceinline__ BlockPos block_pos(int BH, int S, int group,
                                              bool last_first) {
  const int n_blocks = (S + kBM - 1) / kBM;
  const int first = blockIdx.x / (group * n_blocks) * group;
  const int in_group = blockIdx.x % (group * n_blocks);
  const int heads = min(group, BH - first);
  const int i = in_group / heads;
  return {first + in_group % heads, (last_first ? n_blocks - 1 - i : i) * kBM};
}

// acc = A B^T over D, issued (not committed): A = one consumer's 64 rows
// (a: its first row in the first 64-column box; a_box: bytes between boxes),
// B = a tile of kBN rows (b, b_box), both K-major as TMA wrote them. A step
// of 16 along D is 32 bytes inside a box.
template <typename T, int D>
__device__ __forceinline__ void wgmma_abt(float (&acc)[kAcc], uint32_t a,
                                          uint32_t a_box, uint32_t b,
                                          uint32_t b_box) {
  // descriptors as one base each plus constant offsets (the address field
  // counts 16-byte units and cannot overflow inside shared memory)
  const uint64_t da = hopper::desc_sw128(a, 16, 1024);
  const uint64_t db = hopper::desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss<T>(acc, da + (((kk / 4) * a_box + col) >> 4),
                                  db + (((kk / 4) * b_box + col) >> 4),
                                  kk > 0);
  }
}

// acc += X M, issued: X = 64 x kBN from registers (T A fragments, x[kk]
// for columns 16kk..16kk+15), M = a [kBN][D] tile read MN-major (transpose
// bit): a step of 16 is 16 rows (2048 bytes), its 64-column boxes lie kBN
// rows apart
template <typename T, int D>
__device__ __forceinline__ void wgmma_xm(float (&acc)[D / 2],
                                         const uint32_t (&x)[kBN / 16][4],
                                         uint32_t m) {
  const uint64_t dm = hopper::desc_sw128(m, kBN * kRowBytes, 1024);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    hopper::wgmma_rs<T, D, 1>(acc, x[kk], dm + ((kk * 16 * kRowBytes) >> 4),
                              1);
}

// a score-layout accumulator, rounded to T, as the A operand of the next
// product: columns 16kk..16kk+15 are x[8kk..8kk+7], two T to a register
template <typename T>
__device__ __forceinline__ void narrow(const float (&x)[kAcc],
                                       uint32_t (&a)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pt::pack2<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// dq's tile (rows: this thread's queries qpos[0], qpos[1]; columns: keys
// k0 + 8j + 2t + {0, 1}): ds = p (dp - delta) scale in place of the scores,
// p = 2^(s scale log2e - lse log2e) (lse2 = lse log2e), 0 where the mask
// hides the key; the mask is built only where `edge` says the tile needs one
__device__ __forceinline__ void grad_rows(float (&sc)[kAcc],
                                          const float (&dp)[kAcc],
                                          const float (&lse2)[2],
                                          const float (&dl)[2], float scale,
                                          float scale_log2, bool edge, int k0,
                                          int Sk, int causal,
                                          const int (&qpos)[2], int t) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = hopper::exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lse2[i]));
      if (edge) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        if (kpos >= Sk || (causal && kpos > qpos[i])) p = 0.f;
      }
      sc[4 * j + e] = p * (dp[4 * j + e] - dl[i]) * scale;
    }
  }
}

// dk/dv's transposed tile (rows: this thread's keys kpos[0], kpos[1];
// columns: queries q0 + 8j + 2t + {0, 1}, whose lse and delta the stage holds
// in shared memory): p^T in place of S^T and ds^T in place of dP^T, 0 where
// the mask hides the pair (a query past Sq included: its row of the stage
// holds zeros or the next head's values)
__device__ __forceinline__ void grad_cols(float (&st)[kAcc],
                                          float (&dpt)[kAcc],
                                          const float* lse_s,
                                          const float* dl_s, float scale,
                                          float scale_log2, bool edge, int q0,
                                          int Sq, int Sk, int causal,
                                          const int (&kpos)[2], int t) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      const int i = e >> 1;
      float p = hopper::exp2_approx(
          fmaf(st[4 * j + e], scale_log2, -(c ? l.y : l.x) * kLog2e));
      if (edge) {
        const int qpos = q0 + 8 * j + 2 * t + c;
        if (qpos >= Sq || kpos[i] >= Sk || (causal && kpos[i] > qpos))
          p = 0.f;
      }
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - (c ? d.y : d.x)) * scale;
    }
  }
}

// One consumer's 64 x D float gradient into rows first.. of a contiguous
// [B, S, H, D] T tensor: staged as T in the consumer's own rows of a
// block buffer (`stage`, its first row in box 0; boxes kBM rows apart;
// 16-byte chunks swizzled by row), then stored as 16-byte vectors. ct is the
// thread's index in the consumer warpgroup.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           unsigned char* stage, T* out,
                                           int b, int S, int H, int h,
                                           int first, int ct, int cw) {
  const int warp = ct >> 5;
  const int g = (ct & 31) >> 2;
  const int t = ct & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const uint32_t off = (j / 8) * kBM * kRowBytes + r * kRowBytes +
                           (((j % 8) ^ (r & 7)) * 16) + t * 4;
      *reinterpret_cast<uint32_t*>(stage + off) =
          pt::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
  hopper::named_barrier_sync(1 + cw, 128);
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = ct; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int j = idx % kChunks;
    const int s = first + r;
    if (s >= S) continue;
    const uint32_t off = (j / 8) * kBM * kRowBytes + r * kRowBytes +
                         (((j % 8) ^ (r & 7)) * 16);
    *reinterpret_cast<uint4*>(out + (((int64_t)b * S + s) * H + h) * D +
                              j * 8) =
        *reinterpret_cast<const uint4*>(stage + off);
  }
}

// the consumers' turn-taking: every wait for this warpgroup's turn is
// matched by one hand-over from the other; the second warpgroup lets the
// first go first and does not hand over after its last issue
__device__ __forceinline__ void my_turn(int cw) {
  hopper::named_barrier_sync(kTurnBarrier + cw, 256);
}

__device__ __forceinline__ void their_turn(int cw) {
  hopper::named_barrier_arrive(kTurnBarrier + 1 - cw, 256);
}

// the two score-side products of a tile, issued and committed as one group:
// x = A B^T and y = C E^T (dq: S = Q K^T, dP = dO V^T; dk/dv: S^T = K Q^T,
// dP^T = V dO^T), a and c one consumer's rows of a 128-row block, b and e
// a streamed tile
template <typename T, int D>
__device__ __forceinline__ void issue_scores(float (&x)[kAcc],
                                             float (&y)[kAcc], uint32_t a,
                                             uint32_t c, uint32_t b,
                                             uint32_t e) {
  hopper::wgmma_fence();
  wgmma_abt<T, D>(x, a, kBM * kRowBytes, b, kBN * kRowBytes);
  wgmma_abt<T, D>(y, c, kBM * kRowBytes, e, kBN * kRowBytes);
  hopper::wgmma_commit();
}

// dQ += dS K, issued and committed
template <typename T, int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2],
                                         const uint32_t (&dsa)[kBN / 16][4],
                                         uint32_t k) {
  hopper::wgmma_fence();
  wgmma_xm<T, D>(acc, dsa, k);
  hopper::wgmma_commit();
}

// dV += P^T dO and dK += dS^T Q, issued and committed as one group
template <typename T, int D>
__device__ __forceinline__ void issue_dkv(float (&dka)[D / 2],
                                          float (&dva)[D / 2],
                                          const uint32_t (&pa)[kBN / 16][4],
                                          const uint32_t (&dsa)[kBN / 16][4],
                                          uint32_t q, uint32_t o) {
  hopper::wgmma_fence();
  wgmma_xm<T, D>(dva, pa, o);
  wgmma_xm<T, D>(dka, dsa, q);
  hopper::wgmma_commit();
}

// dq for 128 queries of one (batch, head): K and V tiles of kBN keys stream
// through the ring; per tile S = Q K^T and dP = dO V^T (SS wgmma), then
// dQ += dS K (dS from registers, K MN-major). A K slot is released when its
// dQ product is done, a V slot when its dP product is.
template <typename T, int D>
__global__ void __launch_bounds__(kWsThreads, 1) dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int BH, int H,
    int Sq, int Sk, int group, float scale, float scale_log2, int causal) {
  using L = DqSmem<D>;
  constexpr int kHalves = D / 64;  // 64-column boxes per row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ;
  const uint32_t sO = base + L::kO;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t qo_full = base + L::kBar;
  const uint32_t k_full = qo_full + 8;  // each + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const BlockPos pos = block_pos(BH, Sq, group, true);
  const int bh = pos.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = pos.r0;
  const int k_end = causal ? min(q0 + kBM, Sk) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, kConsumerWarps);
      hopper::mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform role branch, so that ptxas gives each role its registers
  const int wg = __shfl_sync(pt::kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(qo_full, 2 * L::kBlockBytes);
#pragma unroll
      for (int c = 0; c < kHalves; ++c) {
        hopper::tma_load_4d(sQ + c * kBM * kRowBytes, &tm_q, qo_full, c * 64,
                            h, q0, b);
        hopper::tma_load_4d(sO + c * kBM * kRowBytes, &tm_do, qo_full,
                            c * 64, h, q0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
        const int k0 = n * kBN;
        hopper::mbar_wait(k_empty + 8 * s, free_parity);
        hopper::mbar_arrive_expect_tx(k_full + 8 * s, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_4d(sK + s * L::kTileBytes + c * kBN * kRowBytes,
                              &tm_k, k_full + 8 * s, c * 64, h, k0, b);
        hopper::mbar_wait(v_empty + 8 * s, free_parity);
        hopper::mbar_arrive_expect_tx(v_full + 8 * s, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_4d(sV + s * L::kTileBytes + c * kBN * kRowBytes,
                              &tm_v, v_full + 8 * s, c * 64, h, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hopper::setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;  // consumer warpgroup: rows cw*64..
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wrow = cw * 64 + warp * 16 + g;  // block rows wrow, wrow + 8
    const int qpos[2] = {q0 + wrow, q0 + wrow + 8};
    const int cw_first = q0 + cw * 64;
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = qpos[i] < Sq;
      lse2[i] = ok ? lse[(int64_t)bh * Sq + qpos[i]] * kLog2e : 0.f;
      dl[i] = ok ? delta[(int64_t)bh * Sq + qpos[i]] : 0.f;
    }
    const uint32_t q_rows = sQ + cw * 64 * kRowBytes;
    const uint32_t o_rows = sO + cw * 64 * kRowBytes;
    // a tile needs the mask if it reaches past Sk or above the diagonal of
    // this warpgroup's first row
    auto edge = [&](int k0) {
      return k0 + kBN > Sk || (causal && k0 + kBN - 1 > cw_first);
    };
    if (cw == 1) their_turn(cw);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kAcc], dp[kAcc];
    uint32_t dsa[kBN / 16][4];

    // tile 0: its scores and dS only
    hopper::mbar_wait(qo_full, 0);
    hopper::mbar_wait(k_full, 0);
    hopper::mbar_wait(v_full, 0);
    my_turn(cw);
    issue_scores<T, D>(sc, dp, q_rows, o_rows, sK, sV);
    their_turn(cw);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);
    hopper::fence_operands(dp);
    if (lane == 0) hopper::mbar_arrive(v_empty);
    grad_rows(sc, dp, lse2, dl, scale, scale_log2, edge(0), 0, Sk, causal,
              qpos, t);
    narrow<T>(sc, dsa);

    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int ps = (n - 1) % kStages;
      const int k0 = n * kBN;
      // the scores of tile n and dQ += dS K of tile n - 1, both in flight
      hopper::mbar_wait(k_full + 8 * s, (n / kStages) & 1);
      hopper::mbar_wait(v_full + 8 * s, (n / kStages) & 1);
      my_turn(cw);
      issue_scores<T, D>(sc, dp, q_rows, o_rows, sK + s * L::kTileBytes,
                         sV + s * L::kTileBytes);
      issue_dq<T, D>(acc, dsa, sK + ps * L::kTileBytes);
      their_turn(cw);
      hopper::wgmma_wait<1>();  // the scores
      hopper::fence_operands(sc);
      hopper::fence_operands(dp);
      if (lane == 0) hopper::mbar_arrive(v_empty + 8 * s);
      grad_rows(sc, dp, lse2, dl, scale, scale_log2, edge(k0), k0, Sk,
                causal, qpos, t);
      hopper::wgmma_wait<0>();  // dQ of tile n - 1
      hopper::fence_operands(acc);
      if (lane == 0) hopper::mbar_arrive(k_empty + 8 * ps);
      narrow<T>(sc, dsa);
    }
    {
      const int s = (n_tiles - 1) % kStages;
      my_turn(cw);
      issue_dq<T, D>(acc, dsa, sK + s * L::kTileBytes);
      if (cw == 0) their_turn(cw);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      if (lane == 0) hopper::mbar_arrive(k_empty + 8 * s);
    }

    // the warpgroup's rows of the Q tile are free now: only its own
    // products read them
    store_rows<T, D>(acc, smem + L::kQ + cw * 64 * kRowBytes, dq, b, Sq, H,
                     h, cw_first, ct & 127, cw);
  }
}

// dk/dv for 128 keys of one (batch, head): Q and dO tiles of kBN queries
// stream through the ring with their lse and delta; per tile S^T = K Q^T and
// dP^T = V dO^T (SS wgmma), then dV += P^T dO and dK += dS^T Q (P^T and
// dS^T from registers, dO and Q MN-major), one after the other (see the
// header: the consumer's registers do not hold both in flight). A slot is
// released when both gradient products of its tile are done.
template <typename T, int D>
__global__ void __launch_bounds__(kWsThreads, 1) dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_lse,
    const __grid_constant__ CUtensorMap tm_dl, T* __restrict__ dk,
    T* __restrict__ dv, int BH, int H, int Sq, int Sk, int group,
    float scale, float scale_log2, int causal) {
  using L = DkvSmem<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sO = base + L::kO;
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;  // each + 8 * stage
  const uint32_t empty = full + 8 * kStages;

  const BlockPos pos = block_pos(BH, Sk, group, false);
  const int bh = pos.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = pos.r0;
  // causal: query tiles from the one holding key k0 (tiles are aligned)
  const int qt0 = causal ? k0 / kBN : 0;
  const int n_tiles = (Sq + kBN - 1) / kBN - qt0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(pt::kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kBlockBytes);
#pragma unroll
      for (int c = 0; c < kHalves; ++c) {
        hopper::tma_load_4d(sK + c * kBM * kRowBytes, &tm_k, kv_full, c * 64,
                            h, k0, b);
        hopper::tma_load_4d(sV + c * kBM * kRowBytes, &tm_v, kv_full, c * 64,
                            h, k0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const int q0 = (qt0 + n) * kBN;
        hopper::mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full + 8 * s, L::kStageTx);
#pragma unroll
        for (int c = 0; c < kHalves; ++c) {
          hopper::tma_load_4d(sQ + s * L::kTileBytes + c * kBN * kRowBytes,
                              &tm_q, full + 8 * s, c * 64, h, q0, b);
          hopper::tma_load_4d(sO + s * L::kTileBytes + c * kBN * kRowBytes,
                              &tm_do, full + 8 * s, c * 64, h, q0, b);
        }
        hopper::tma_load_1d(base + L::kL + s * L::kVecBytes, &tm_lse,
                            full + 8 * s, bh * Sq + q0);
        hopper::tma_load_1d(base + L::kDl + s * L::kVecBytes, &tm_dl,
                            full + 8 * s, bh * Sq + q0);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hopper::setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7;  // consumer warpgroup: keys cw*64..
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int cw_first = k0 + cw * 64;
    const int kpos[2] = {cw_first + warp * 16 + g, cw_first + warp * 16 + g + 8};
    const uint32_t k_rows = sK + cw * 64 * kRowBytes;
    const uint32_t v_rows = sV + cw * 64 * kRowBytes;
    // a tile needs the mask if it holds queries past Sq, keys past Sk, or
    // pairs above the diagonal (a query before this warpgroup's last key)
    auto edge = [&](int q0) {
      return q0 + kBN > Sq || cw_first + 64 > Sk ||
             (causal && q0 < cw_first + 63);
    };
    // the lse and delta of stage s's queries
    auto lse_s = [&](int s) {
      return reinterpret_cast<const float*>(smem + L::kL + s * L::kVecBytes);
    };
    auto dl_s = [&](int s) {
      return reinterpret_cast<const float*>(smem + L::kDl + s * L::kVecBytes);
    };
    if (cw == 1) their_turn(cw);

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    float st[kAcc], dpt[kAcc];
    uint32_t pa[kBN / 16][4], dsa[kBN / 16][4];

    hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int q0 = (qt0 + n) * kBN;
      hopper::mbar_wait(full + 8 * s, (n / kStages) & 1);
      my_turn(cw);
      issue_scores<T, D>(st, dpt, k_rows, v_rows, sQ + s * L::kTileBytes,
                         sO + s * L::kTileBytes);
      their_turn(cw);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(st);
      hopper::fence_operands(dpt);
      grad_cols(st, dpt, lse_s(s), dl_s(s), scale, scale_log2, edge(q0), q0,
                Sq, Sk, causal, kpos, t);
      narrow<T>(st, pa);
      narrow<T>(dpt, dsa);
      my_turn(cw);
      issue_dkv<T, D>(dka, dva, pa, dsa, sQ + s * L::kTileBytes,
                      sO + s * L::kTileBytes);
      if (n + 1 < n_tiles || cw == 0) their_turn(cw);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dka);
      hopper::fence_operands(dva);
      if (lane == 0) hopper::mbar_arrive(empty + 8 * s);
    }

    // the warpgroup's rows of the K and V blocks are free now
    store_rows<T, D>(dka, smem + L::kK + cw * 64 * kRowBytes, dk, b, Sk, H,
                     h, cw_first, ct & 127, cw);
    store_rows<T, D>(dva, smem + L::kV + cw * 64 * kRowBytes, dv, b, Sk, H,
                     h, cw_first, ct & 127, cw);
  }
}

// heads per group: as few groups as keep a group's streamed bytes within
// kL2Budget, of equal size
inline int head_group(int BH, int64_t bytes_per_head) {
  const int64_t n_groups = std::max<int64_t>(
      1, ((int64_t)BH * bytes_per_head + kL2Budget - 1) / kL2Budget);
  return (int)(((int64_t)BH + n_groups - 1) / n_groups);
}

// the dynamic shared memory a warp-specialised kernel needs, and the 1-D
// grid's limit
template <typename Kernel>
cudaError_t ws_prepare(Kernel kernel, size_t smem, int64_t blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dq_wgmma(const BwdArgs& a, int B, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!hopper_host::encode_bshd<T>(&tm_q, a.q, B, a.Sq, a.H, D, a.q_sb,
                                    a.q_ss, a.q_sh, kBM) ||
      !hopper_host::encode_bshd<T>(&tm_do, a.dout, B, a.Sq, a.H, D, a.o_sb,
                                    a.o_ss, a.o_sh, kBM) ||
      !hopper_host::encode_bshd<T>(&tm_k, a.k, B, a.Sk, a.H, D, a.k_sb,
                                    a.k_ss, a.k_sh, kBN) ||
      !hopper_host::encode_bshd<T>(&tm_v, a.v, B, a.Sk, a.H, D, a.v_sb,
                                    a.v_ss, a.v_sh, kBN))
    return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * a.H * ((a.Sq + kBM - 1) / kBM);
  cudaError_t err =
      ws_prepare(dq_wgmma_kernel<T, D>, DqSmem<D>::kDynamic, blocks);
  if (err != cudaSuccess) return err;
  const int BH = B * a.H;
  dq_wgmma_kernel<T, D><<<(unsigned)blocks, kWsThreads, DqSmem<D>::kDynamic,
                          stream>>>(
      tm_q, tm_do, tm_k, tm_v, a.lse, a.delta, static_cast<T*>(a.dq), BH,
      a.H, a.Sq, a.Sk, head_group(BH, 4ll * a.Sk * D), a.scale,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_wgmma(const BwdArgs& a, int B, cudaStream_t stream) {
  const int64_t n_rows = (int64_t)B * a.H * a.Sq;  // lse and delta
  if (n_rows + kBN > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_lse, tm_dl;
  if (!hopper_host::encode_bshd<T>(&tm_q, a.q, B, a.Sq, a.H, D, a.q_sb,
                                    a.q_ss, a.q_sh, kBN) ||
      !hopper_host::encode_bshd<T>(&tm_do, a.dout, B, a.Sq, a.H, D, a.o_sb,
                                    a.o_ss, a.o_sh, kBN) ||
      !hopper_host::encode_bshd<T>(&tm_k, a.k, B, a.Sk, a.H, D, a.k_sb,
                                    a.k_ss, a.k_sh, kBM) ||
      !hopper_host::encode_bshd<T>(&tm_v, a.v, B, a.Sk, a.H, D, a.v_sb,
                                    a.v_ss, a.v_sh, kBM) ||
      !hopper_host::encode_1d_f32(&tm_lse, a.lse, n_rows, kBN) ||
      !hopper_host::encode_1d_f32(&tm_dl, a.delta, n_rows, kBN))
    return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * a.H * ((a.Sk + kBM - 1) / kBM);
  cudaError_t err =
      ws_prepare(dkv_wgmma_kernel<T, D>, DkvSmem<D>::kDynamic, blocks);
  if (err != cudaSuccess) return err;
  const int BH = B * a.H;
  dkv_wgmma_kernel<T, D><<<(unsigned)blocks, kWsThreads,
                           DkvSmem<D>::kDynamic, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_lse, tm_dl, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), BH, a.H, a.Sq, a.Sk,
      head_group(BH, 4ll * a.Sq * D + 8ll * a.Sq), a.scale, a.scale * kLog2e,
      a.causal);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int B, int rows,
                   int block_rows, int threads, const BwdArgs& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * a.H, (rows + block_rows - 1) / block_rows);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int H, int Sq, int Sk,
                  const int64_t* st, float scale, int causal) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.q_sb = st[0];
  a.q_ss = st[1];
  a.q_sh = st[2];
  a.k_sb = st[3];
  a.k_ss = st[4];
  a.k_sh = st[5];
  a.v_sb = st[6];
  a.v_ss = st[7];
  a.v_sh = st[8];
  a.o_sb = st[9];
  a.o_ss = st[10];
  a.o_sh = st[11];
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

// C entry points bound with ctypes (ops/_build.py). Each returns
// cudaGetLastError() after its launch (0 = launched); a shape it does not
// take returns cudaErrorInvalidValue without launching. Arguments: q, k, v,
// dO, lse, delta, the outputs (dq; or dk, dv), B, H, Sq, Sk, D, the strides
// (b, s, h) of q, k, v and dO as one array of 12, scale, causal, dtype,
// stream.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int Sq, int Sk, int D, const int64_t* strides,
                               float scale, int causal, int dtype,
                               void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                              H, Sq, Sk, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32 && D == 64)
    return launch(dq_f32_kernel<64>, dq_f32_smem<64>(), B, Sq, kRows,
                  kThreads, a, st);
  if (dtype == pt::kFloat32 && D == 128)
    return launch(dq_f32_kernel<128>, dq_f32_smem<128>(), B, Sq, kRows,
                  kThreads, a, st);
  if (dtype == pt::kBFloat16 && D == 64)
    return launch_dq_wgmma<__nv_bfloat16, 64>(a, B, st);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch_dq_wgmma<__nv_bfloat16, 128>(a, B, st);
  if (dtype == pt::kFloat16 && D == 64)
    return launch_dq_wgmma<__half, 64>(a, B, st);
  if (dtype == pt::kFloat16 && D == 128)
    return launch_dq_wgmma<__half, 128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, int D,
                                const int64_t* strides, float scale,
                                int causal, int dtype, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, H,
                              Sq, Sk, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32 && D == 64)
    return launch(dkv_f32_kernel<64>, dkv_f32_smem<64>(), B, Sk, kRows,
                  kThreads, a, st);
  if (dtype == pt::kFloat32 && D == 128)
    return launch(dkv_f32_kernel<128>, dkv_f32_smem<128>(), B, Sk, kRows,
                  kThreads, a, st);
  if (dtype == pt::kBFloat16 && D == 64)
    return launch_dkv_wgmma<__nv_bfloat16, 64>(a, B, st);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch_dkv_wgmma<__nv_bfloat16, 128>(a, B, st);
  if (dtype == pt::kFloat16 && D == 64)
    return launch_dkv_wgmma<__half, 64>(a, B, st);
  if (dtype == pt::kFloat16 && D == 128)
    return launch_dkv_wgmma<__half, 128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
