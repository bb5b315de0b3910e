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
// take two tensor-core kernels in 3xTF32 (mma.sync with each operand split
// into TF32 hi + lo parts, three products: float32 accuracy at up to 495 / 3
// TFLOP/s, where float FMAs reach 67; tf32.cuh), with the same split of the
// work: blocks of 64 rows, the other side's tiles of 32 rows in a two-stage
// cp.async ring, p and ds in registers (the float32 section below). Causal
// tiles stop at the diagonal and ragged sequence lengths are masked at the
// edge, so every S the forward takes has a backward (the TPU's
// multiple-of-128 gate and its XLA crossover below S = 1024 do not carry
// over).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

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

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- float32 path
// float32 runs both kernels on tensor cores in 3xTF32 (mma.sync m16n8k8,
// each operand split into TF32 hi + lo, three products: tf32.cuh); a warp
// owns 16 of its block's rows.
// - dq_tf32_kernel: a block owns kRows query rows of one (batch, head).
//   Its Q and dO stay in shared memory; K and V stream in tiles of kDqTile
//   keys through a two-stage cp.async ring, so tile n + 1's loads run under
//   tile n's products. Per tile a warp computes S = Q K^T and dP = dO V^T
//   (head dims relabelled), builds P and dS in registers (s scale and lse
//   in natural units, p = 2^(s scale log2 e - lse log2 e), 0 where the mask
//   hides the key; dS = p (dP - delta) scale in place of dP) and adds dS K
//   to dQ, dS's registers fed to the A operand as they are (keys
//   relabelled) and K read at keys 2t, 2t + 1.
// - dkv_tf32_kernel, its transpose: a block owns kRows key rows; its K
//   and V stay, Q and dO tiles of kDkvTile queries stream with their lse
//   and delta. Per tile S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//   registers (lse and delta indexed by the column, the query), then
//   dV += P^T dO and dK += dS^T Q, P^T's split fragments dead before dS^T's
//   are split.
// Accumulation (tf32.cuh's rule: no long chain of tensor-core sums): each
// 8-wide step of a score product sums its three products from zero and
// joins the scores in one FADD; each streamed tile's gradient product sums
// its tile / 8 steps from zero, one 8-column n-tile of the output at a time
// (the n-tiles outside the k-steps, so the sum is four registers and the
// accumulators are not doubled), and joins dQ, dV or dK in one FADD.
// Shared memory: the fixed side (Q and dO in dq, K and V in dk/dv) and dq's
// V tile are read one way, as A fragments or as the B operand of a score
// product (rows g, dims 2t: 8-byte loads), in rows of D + 8 floats, which
// that read takes from 32 distinct banks. K in dq, and Q and dO in dk/dv,
// are also the B operand of a gradient product (rows 2t, dim g: 4-byte
// loads), which D + 4 serves and D + 8 does not: those tiles are
// XOR-swizzled rows of D floats (tf32::swz), conflict-free both ways.
// Causal blocks stop at the diagonal (a warp skips a tile its mask empties)
// and start heaviest first (dq's last query blocks, dk/dv's first key
// blocks); only tiles that touch the diagonal or a ragged end build a mask.
// Rows past S load as zeros. Every row of q, k, v and dO must be 16-byte
// aligned (the wrapper copies a view that is not; the launchers refuse one).
// Sizes, chosen on the card (PERF.md): the kernels wait on latency more
// than they issue, so warps an SM count most. At D = 128 a block of eight
// warps (~205 KB of shared memory) beat four (one block an SM either way)
// and two blocks of four over 16-row tiles; dk/dv's dK and dV (128 floats a
// thread) then leave no register to spare, and a D split across two warps
// (64 each, half sums exchanged through shared memory) ran slower than
// this. At D = 64 dk/dv takes 64-query tiles (each split K/V fragment feeds
// eight steps), dq 32-key tiles (three blocks an SM).
// The fixed side is split per fragment as it is read, as the forward splits
// Q: split once a block into hi and lo planes, it doubled its shared memory
// (64-row blocks at D = 128) and its loads, and ran slower (PERF.md).
template <int D>
struct F32Bwd {
  static constexpr int kPad = D + 8;  // stride of one-way rows
  static constexpr int kStages = 2;   // ring depth
  static constexpr int kWarps = D == 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // rows a block owns
  static constexpr int kDqTile = 32;                // keys of dq's tile
  static constexpr int kDkvTile = D == 64 ? 64 : 32;  // queries of dk/dv's
  // dq: Q and dO, then per stage K (swizzled) and V
  static constexpr size_t kDqBytes =
      sizeof(float) * (2 * kRows * kPad + kStages * kDqTile * (D + kPad));
  // dk/dv: K and V, then per stage Q and dO (swizzled), lse and delta
  static constexpr size_t kDkvBytes =
      sizeof(float) * (2 * kRows * kPad + kStages * kDkvTile * (2 * D + 2));
  static_assert(kDqBytes <= 232448 && kDkvBytes <= 232448,
                "a block's shared memory");
};

// where a thread's reads of a swizzled tile lie: rows 8j + g at dims
// 8kk + 2t (sg: the XOR of row g), rows 8j + 2t and 8j + 2t + 1 at dims
// 8m + g (s0, s1: the XORs of those rows)
struct SwizzledReads {
  int g, sg, s0, s1;
  __device__ __forceinline__ SwizzledReads(int g_, int t)
      : g(g_), sg(tf32::swz(g_)), s0(tf32::swz(2 * t)),
        s1(tf32::swz(2 * t + 1)) {}
};

// acc += X M over one streamed tile: X its score-layout A fragments (hi,
// lo; columns relabelled), M the tile's swizzled [kN * 8][D] rows, read at
// rows 2t and 2t + 1 of each 8-row step (r0: row 2t of the first). Each
// 8-column n-tile of the output sums its kN steps from zero and joins acc
// in one FADD. A warp sync after every eight n-tiles keeps ptxas from
// hoisting the later n-tiles' loads above the earlier products: with dk/dv's
// two accumulators at D = 128 that hoisting spilled.
template <int D, int kN>
__device__ __forceinline__ void grad_product(float (&acc)[D / 8][4],
                                             const uint32_t (&xh)[kN][4],
                                             const uint32_t (&xl)[kN][4],
                                             const float* r0,
                                             const SwizzledReads& rd) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const float* r = r0 + 32 * (dn >> 2);
    const int c0 = ((8 * (dn & 3)) ^ rd.s0) + rd.g;
    const int c1 = D + ((8 * (dn & 3)) ^ rd.s1) + rd.g;
    float sum[4] = {};
#pragma unroll
    for (int j = 0; j < kN; ++j)
      tf32::mma_3xtf32(sum, xh[j], xl[j], r[8 * j * D + c0],
                       r[8 * j * D + c1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] += sum[e];
    if (dn % 8 == 7) __syncwarp();
  }
}

// dQ = dS K for kRows query rows of one (batch, head)
template <int D>
__global__ void __launch_bounds__(F32Bwd<D>::kThreads)
    dq_tf32_kernel(BwdArgs a) {
  using L = F32Bwd<D>;
  constexpr int kTile = L::kDqTile;
  constexpr int kTwoWay = kTile * D;        // a K tile, swizzled
  constexpr int kOneWay = kTile * L::kPad;  // a V tile
  constexpr int kN = kTile / 8;             // 8-key steps of a tile
  constexpr int kDK = D / 8;                // 8-dim steps of a row
  constexpr int kFixed = L::kRows * L::kPad;
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;                   // [kRows][kPad]
  float* Os = Qs + kFixed;                // [kRows][kPad]
  float* Ks = Os + kFixed;                // [stage][kTile][D], swizzled
  float* Vs = Ks + L::kStages * kTwoWay;  // [stage][kTile][kPad]

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  // causal blocks with the most key tiles first
  const int qblock = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qblock * L::kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int k_end = a.causal ? min(q0 + L::kRows, a.Sk) : a.Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  // (the head's K and V pointers recomputed at each load: see dk/dv's)
  auto load_kv = [&](int n) {
    const int s = n % L::kStages;
    const int bo = pt::opaque(b), ho = pt::opaque(h);
    const float* kb =
        static_cast<const float*>(a.k) + bo * a.k_sb + ho * a.k_sh;
    const float* vb =
        static_cast<const float*>(a.v) + bo * a.v_sb + ho * a.v_sh;
    tf32::load_rows_swizzled<D, kTile, L::kThreads>(
        Ks + s * kTwoWay, kb, a.k_ss, n * kTile, a.Sk, tid);
    tf32::load_rows<D, kTile, L::kPad, L::kThreads>(
        Vs + s * kOneWay, vb, a.v_ss, n * kTile, a.Sk, tid);
  };
  tf32::load_rows<D, L::kRows, L::kPad, L::kThreads>(
      Qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
      q0, a.Sq, tid);
  tf32::load_rows<D, L::kRows, L::kPad, L::kThreads>(
      Os, static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh,
      a.o_ss, q0, a.Sq, tid);
  pt::cp_async_commit();  // Q and dO
  load_kv(0);
  pt::cp_async_commit();  // tile 0
  if (n_tiles > 1) load_kv(1);
  pt::cp_async_commit();  // tile 1 (or nothing)

  // lse (log2 units) and delta of rows wrow + g and wrow + g + 8; rows past
  // Sq read zeros, so their dS is 0 (and they are not stored)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    const bool ok = r < a.Sq;
    lse2[i] = ok ? a.lse[(int64_t)bh * a.Sq + r] * kLog2e : 0.f;
    dl[i] = ok ? a.delta[(int64_t)bh * a.Sq + r] : 0.f;
  }
  const SwizzledReads rd(g, t);
  const int row = (warp * 16 + g) * L::kPad;  // row g of the warp's rows
  float acc[kDK][4];
#pragma unroll
  for (int j = 0; j < kDK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kTile;
    const float* Kt = Ks + (n % L::kStages) * kTwoWay;
    const float* Vt = Vs + (n % L::kStages) * kOneWay;
    pt::cp_async_wait<1>();  // every group but the newest: tile n is here
    __syncthreads();
    // a warp whose rows all lie above this causal tile has nothing in it
    if (!(a.causal && k0 > wrow + 15)) {
      // S = Q K^T and dP = dO V^T (rows g and g + 8, keys 8j + 2t + {0, 1})
      float sc[kN][4], dp[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < kDK; ++kk) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        tf32::a_fragment<L::kPad>(Qs + row, kk, t, qh, ql);
        tf32::a_fragment<L::kPad>(Os + row, kk, t, oh, ol);
        const int kc = ((8 * kk) ^ rd.sg) + 2 * t;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float2 kv =
              *reinterpret_cast<const float2*>(Kt + (8 * j + g) * D + kc);
          const float2 vv = *reinterpret_cast<const float2*>(
              Vt + (8 * j + g) * L::kPad + 8 * kk + 2 * t);
          float s4[4] = {}, p4[4] = {};
          tf32::mma_3xtf32(s4, qh, ql, kv.x, kv.y);
          tf32::mma_3xtf32(p4, oh, ol, vv.x, vv.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][e] += s4[e];
            dp[j][e] += p4[e];
          }
        }
      }
      // dS in place of dP; the mask only on tiles that reach past Sk or
      // above the warp's first row
      const bool edge =
          k0 + kTile > a.Sk || (a.causal && k0 + kTile - 1 > wrow);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = hopper::exp2_approx(
              fmaf(sc[j][e] * a.scale, kLog2e, -lse2[i]));
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= a.Sk || (a.causal && kpos > wrow + g + 8 * i))
              p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dl[i]) * a.scale;
        }
      // dQ += dS K
      uint32_t sh[kN][4], sl[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) tf32::score_fragment(dp[j], sh[j], sl[j]);
      grad_product<D, kN>(acc, sh, sl, Kt + 2 * t * D, rd);
    }
    __syncthreads();  // every warp is done with this stage
    if (n + 2 < n_tiles) load_kv(n + 2);
    pt::cp_async_commit();
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = wrow + g + 8 * i;
    if (s >= a.Sq) continue;
    float* out = dq + (((int64_t)b * a.Sq + s) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDK; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// dK = dS^T Q and dV = P^T dO for kRows key rows of one (batch, head)
template <int D>
__global__ void __launch_bounds__(F32Bwd<D>::kThreads)
    dkv_tf32_kernel(BwdArgs a) {
  using L = F32Bwd<D>;
  constexpr int kTile = L::kDkvTile;
  constexpr int kTwoWay = kTile * D;  // a Q or dO tile, swizzled
  constexpr int kN = kTile / 8;       // 8-query steps of a tile
  constexpr int kDK = D / 8;          // 8-dim steps of a row
  constexpr int kFixed = L::kRows * L::kPad;
  extern __shared__ __align__(16) float smem_f32[];
  float* Ks = smem_f32;                   // [kRows][kPad]
  float* Vs = Ks + kFixed;                // [kRows][kPad]
  float* Qs = Vs + kFixed;                // [stage][kTile][D], swizzled
  float* Os = Qs + L::kStages * kTwoWay;  // [stage][kTile][D], swizzled
  float* Ls = Os + L::kStages * kTwoWay;  // [stage][kTile] lse
  float* Ds = Ls + L::kStages * kTile;    // [stage][kTile] delta

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  // y runs in order: under a causal mask the first key blocks, which see
  // the most queries, start first
  const int k0 = blockIdx.y * L::kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wkey = k0 + warp * 16;  // the warp's first key
  // causal: query tiles from the one holding key k0 (tiles are aligned).
  // What the loop reads once a tile (the tile count, the head's pointers,
  // the thread's lse slot) is recomputed there through pt::opaque: held
  // across the loop beside dK and dV it spilled.
  const int qt0 = a.causal ? k0 / kTile : 0;
  auto n_tiles = [&] {
    return (a.Sq + kTile - 1) / kTile -
           (a.causal ? pt::opaque(k0) / kTile : 0);
  };
  auto load_q = [&](int n) {
    const int s = n % L::kStages;
    const int q0 = (qt0 + n) * kTile;
    const int bho = pt::opaque(static_cast<int>(blockIdx.x));
    const int bo = bho / a.H, ho = bho - bo * a.H;
    const float* qb =
        static_cast<const float*>(a.q) + bo * a.q_sb + ho * a.q_sh;
    const float* ob =
        static_cast<const float*>(a.dout) + bo * a.o_sb + ho * a.o_sh;
    tf32::load_rows_swizzled<D, kTile, L::kThreads>(
        Qs + s * kTwoWay, qb, a.q_ss, q0, a.Sq, tid);
    tf32::load_rows_swizzled<D, kTile, L::kThreads>(
        Os + s * kTwoWay, ob, a.o_ss, q0, a.Sq, tid);
    const int tq = pt::opaque(tid);
    if (tq < 2 * kTile) {  // the tile's lse, then its delta
      const int i = tq % kTile;
      const bool ok = q0 + i < a.Sq;
      const float* src = (tq < kTile ? a.lse : a.delta) +
                         (int64_t)bho * a.Sq + (ok ? q0 + i : 0);
      pt::cp_async4(hopper::smem_u32((tq < kTile ? Ls : Ds) + s * kTile + i),
                    src, ok);
    }
  };
  tf32::load_rows<D, L::kRows, L::kPad, L::kThreads>(
      Ks, static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh, a.k_ss,
      k0, a.Sk, tid);
  tf32::load_rows<D, L::kRows, L::kPad, L::kThreads>(
      Vs, static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh, a.v_ss,
      k0, a.Sk, tid);
  pt::cp_async_commit();  // K and V
  load_q(0);
  pt::cp_async_commit();  // tile 0
  if (n_tiles() > 1) load_q(1);
  pt::cp_async_commit();  // tile 1 (or nothing)

  const SwizzledReads rd(g, t);
  const int row = (warp * 16 + g) * L::kPad;  // row g of the warp's keys
  float dk[kDK][4], dv[kDK][4];
#pragma unroll
  for (int j = 0; j < kDK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int n = 0; n < n_tiles(); ++n) {
    const int q0 = (qt0 + n) * kTile;
    const int s = n % L::kStages;
    const float* Qt = Qs + s * kTwoWay;
    const float* Ot = Os + s * kTwoWay;
    pt::cp_async_wait<1>();
    __syncthreads();
    // a warp whose keys all lie after this causal tile's queries has
    // nothing in it
    if (!(a.causal && wkey > q0 + kTile - 1)) {
      // S^T = K Q^T and dP^T = V dO^T (keys g and g + 8, queries
      // 8j + 2t + {0, 1})
      float st[kN][4], dpt[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < kDK; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        tf32::a_fragment<L::kPad>(Ks + row, kk, t, kh, kl);
        tf32::a_fragment<L::kPad>(Vs + row, kk, t, vh, vl);
        const int qc = ((8 * kk) ^ rd.sg) + 2 * t;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float2 qv =
              *reinterpret_cast<const float2*>(Qt + (8 * j + g) * D + qc);
          const float2 ov =
              *reinterpret_cast<const float2*>(Ot + (8 * j + g) * D + qc);
          float s4[4] = {}, p4[4] = {};
          tf32::mma_3xtf32(s4, kh, kl, qv.x, qv.y);
          tf32::mma_3xtf32(p4, vh, vl, ov.x, ov.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] += s4[e];
            dpt[j][e] += p4[e];
          }
        }
      }
      // P^T in place of S^T, dS^T in place of dP^T; the mask where the tile
      // holds queries past Sq, keys past Sk or pairs above the diagonal (a
      // query before the warp's last key)
      const bool edge = q0 + kTile > a.Sq || wkey + 16 > a.Sk ||
                        (a.causal && q0 < wkey + 15);
      const float* lt = Ls + s * kTile + 2 * t;
      const float* dlt = Ds + s * kTile + 2 * t;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lt + 8 * j);
        const float2 d = *reinterpret_cast<const float2*>(dlt + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          float p = hopper::exp2_approx(fmaf(
              st[j][e] * a.scale, kLog2e, -(c ? l.y : l.x) * kLog2e));
          if (edge) {
            const int qpos = q0 + 8 * j + 2 * t + c;
            const int kpos = wkey + g + 8 * (e >> 1);
            if (qpos >= a.Sq || kpos >= a.Sk || (a.causal && kpos > qpos))
              p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (c ? d.y : d.x)) * a.scale;
        }
      }
      // dV += P^T dO, then dK += dS^T Q (P^T's split fragments are dead
      // before dS^T's are split)
      uint32_t xh[kN][4], xl[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) tf32::score_fragment(st[j], xh[j], xl[j]);
      grad_product<D, kN>(dv, xh, xl, Ot + 2 * t * D, rd);
#pragma unroll
      for (int j = 0; j < kN; ++j)
        tf32::score_fragment(dpt[j], xh[j], xl[j]);
      grad_product<D, kN>(dk, xh, xl, Qt + 2 * t * D, rd);
    }
    __syncthreads();  // every warp is done with this stage
    if (n + 2 < n_tiles()) load_q(n + 2);
    pt::cp_async_commit();
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
  const int bho = pt::opaque(static_cast<int>(blockIdx.x));  // as load_q
  const int bo = bho / a.H, ho = bho - bo * a.H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = wkey + g + 8 * i;
    if (s >= a.Sk) continue;
    const int64_t off =
        (((int64_t)bo * a.Sk + s) * a.H + ho) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDK; ++j) {
      *reinterpret_cast<float2*>(dkp + off + 8 * j) =
          make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvp + off + 8 * j) =
          make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
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

// a float32 kernel on a (B * H, row blocks) grid; every row of q, k, v and
// dO must be 16-byte aligned (pointer and b/s/h strides), as the kernels
// load rows with 16-byte copies
template <typename Kernel>
cudaError_t launch_tf32(Kernel kernel, size_t smem, int threads, int B,
                        int rows, int block_rows, const BwdArgs& a,
                        cudaStream_t stream) {
  for (const void* p : {a.q, a.k, a.v, a.dout})
    if ((uintptr_t)p % 16) return cudaErrorInvalidValue;
  for (int64_t st : {a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
                     a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh})
    if (st % 4) return cudaErrorInvalidValue;
  const int blocks = (rows + block_rows - 1) / block_rows;
  if (blocks > 65535) return cudaErrorInvalidValue;  // the grid's y limit
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * a.H, blocks), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tf32(const BwdArgs& a, int B, cudaStream_t stream) {
  using L = F32Bwd<D>;
  return launch_tf32(dq_tf32_kernel<D>, L::kDqBytes, L::kThreads, B, a.Sq,
                     L::kRows, a, stream);
}

template <int D>
cudaError_t launch_dkv_tf32(const BwdArgs& a, int B, cudaStream_t stream) {
  using L = F32Bwd<D>;
  return launch_tf32(dkv_tf32_kernel<D>, L::kDkvBytes, L::kThreads, B, a.Sk,
                     L::kRows, a, stream);
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
    return launch_dq_tf32<64>(a, B, st);
  if (dtype == pt::kFloat32 && D == 128)
    return launch_dq_tf32<128>(a, B, st);
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
    return launch_dkv_tf32<64>(a, B, st);
  if (dtype == pt::kFloat32 && D == 128)
    return launch_dkv_tf32<128>(a, B, st);
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
