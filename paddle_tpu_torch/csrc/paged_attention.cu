// Paged attention for Hopper (sm_90a): the port of the TPU kernel
// paddle_tpu/ops/pallas_paged_attention.py::paged_attention (kernel body
// _paged_kernel), kinds "decode" and "chunked" over float, bf16 or int8
// pools.
//
// What it computes: for each (row b, window position s, head h) the softmax
// attention of q[b, s, h] over the K/V slots of sequence b, read through its
// block table: logical token t lives in pool page tables[b, t / page_size] at
// offset t % page_size. The score is (q . k) * scale (scale after the dot, as
// the reference). The mask is a prefix of the context in both kinds:
//   decode:  t < ctx_len[b]
//   chunked: t <= positions[b, s] and valid[b, s] (and t < ctx_len[b])
// so each row has n_live slots, and a row with n_live == 0 (a dead decode lane
// or an invalid window position) writes zeros. Every token resolves its own
// page, so any page_size >= 1 is taken.
//
// Quantized pools (the reference's quantized branch, :95-101, :139-144): K and
// V are int8 [num_pages, page_size, H, D] with one f32 scale per (slot, head)
// in [num_pages, page_size, H]. The reference dequantizes to float32 tiles and
// keeps p in float32.
//
// What bounds it on the H100: decode reads every live K/V slot once and does
// 4*D flops per slot and head, far below the card's 295 flops/byte balance,
// so it is bound by the bytes of the context (3.35 TB/s): D*4 bytes a row in
// float, D*2 in bf16, D + 4 in int8. A window of S rows does S times the
// flops on the same bytes; at the engine's widths it stays bound by bytes up
// to a few hundred rows in bf16 (a long float32 window is bound by its
// 3xTF32 products, three TF32 products a product). The kernels, by q's type
// and the kind:
//
// - paged_attention_window_kernel (bf16 q, chunked; decode windows of more
//   than one row): blocks of four warps. A window of more than 16 rows takes
//   one block per (row b, head h, tile of 64 window rows), 16 rows a warp,
//   over the whole context. A window of at most 16 rows (the [8, k+1] verify
//   window) takes one 16-row tile whose four warps split each context tile
//   (16 tokens each) and merge their softmax states once; its context is
//   also split across blocks, eight tiles (512 tokens) a block, so that
//   ragged contexts spread over the card, and the combine kernel merges the
//   blocks' partial states. The context streams in tiles of 64 tokens
//   through a ring of 2-3 stages in shared memory, gathered with 16-byte
//   cp.async copies, each token row through its own page (a tile may span
//   pages; rows past the block's longest live prefix are zero-filled and
//   never read into a live score). Rows are padded by 16 bytes so that
//   ldmatrix reads them without bank conflicts; the query rows are staged
//   once in the ring's last stage (or the widened tiles) on their way to
//   registers. S = Q K^T and O += P V run on tensor cores (mma.sync
//   m16n8k16, bf16 in, float accumulators) with the online softmax in float
//   registers, in the exp2 domain. P is split into bf16 hi + lo parts, two
//   products, so it keeps ~16 bits (the plain version keeps p in float; the
//   reference rounds it to the pool type for bf16 pools and keeps float32
//   for int8). int8 tiles are widened to bf16 in shared memory once per tile
//   (int8 is exact in bf16); the K scale factors out of the dot (score_t =
//   s_k,t * (q . k_int,t)) and the V scale folds into p before the PV
//   product, so the maths is the reference's float32 maths reordered. The
//   tile loop stops at the block's longest live prefix, and a warp skips
//   tiles past its own rows' prefixes.
// - paged_attention_window_f32_kernel (float32 q, the same calls): the bf16
//   window kernel's structure (the same grids, split mode and combine, the
//   same gathering ring, the same stop at the longest live prefix) with
//   float tiles and both products on tensor cores in 3xTF32 (mma.sync
//   m16n8k8, tf32.cuh: each float split into TF32 hi + lo, three products,
//   small terms first). Over int8 pools an int8 value is exact in TF32, so
//   the pool side has no low part: Q K^T is q_lo k + q_hi k and P V is
//   p_lo v + p_hi v, two products each, with the K scale factored out of the
//   dot and the V scale folded into p as above. The tensor cores truncate
//   what they add to an accumulator, so no chain is long: each 8-dim step of
//   Q K^T sums its products from zero and joins the score in one FADD, and
//   each context tile's P V (32 or 64 tokens) sums from zero and joins the
//   output in one FFMA with the rescale. The softmax keeps the scale after
//   the dot and its max in natural units, as the plain version does
//   (p = 2^(s log2 e - m log2 e) in one FFMA). K and V tiles are each read
//   one way only, so each takes a padding instead of a swizzle: K rows of
//   D + 8 floats (the score product's B operand, rows g and dims 2t, 2t + 1:
//   8-byte loads) and V rows of D + 4 (the P V product's B operand, rows 2t
//   and 2t + 1 and dim g: 4-byte loads), both conflict-free and 16-byte
//   aligned for cp.async; Q stays in shared memory (rows of D + 8) and is
//   split per fragment. int8 tiles are widened to float once per tile.
// - paged_attention_decode_kernel (decode, one row, either q type): the
//   context of each (b, h) is split into chunks, one block each: 128 tokens
//   over bf16 and int8 pools, kChunkF32 over float pools, whose rows are
//   twice as long. A block issues its chunk's K rows and V rows as two
//   cp.async groups at once, scores one token a thread from shared memory
//   (no shuffle tree per token), takes the chunk's max and sum once, then
//   accumulates P V with each thread on 16 bytes of a row and one reduction
//   across the block. Its maths is float FMAs: a float32 row differs from
//   the plain version only in the order of its sums (per chunk, then the
//   merge). Decode is bound by bytes; tensor cores would buy nothing there.
// - paged_attention_combine_kernel: the split kernels write their partial
//   states (m, l, acc; m in the exp2 domain) to a float workspace, and one
//   block per (b, h, row) merges the parts that hold a live token of its
//   row, its loads issued together. When one block's part covers a (b, h)'s
//   whole context, that block writes the output itself and the combine
//   block returns at once. Blocks past a row's context exit at once; a dead
//   row writes zeros, and a NaN reaches the rows it reaches in the plain
//   version.
//
// On the card, chip_smoke.py holds every kernel against the plain version
// (ops/cuda_paged_attention.py::paged_attention_reference): float32 rows at
// atol/rtol 2e-5, two launches bit for bit and a NaN made on the card (0/0
// in a key) NaN in exactly the plain version's rows; bf16 rows at 2e-2 and
// per row at 0.03 of the row's rms.
//
// Each block loads its own page ids from the table, which replaces the TPU's
// scalar prefetch and the pages_per_tile-fold pool passing (BlockSpec
// workarounds).
#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace {

template <typename T>
__host__ __device__ constexpr T ceil_div(T a, T b) {
  return (a + b - 1) / b;
}

// ------------------------------------------------------ shared-memory copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

using pt::cp_async16;
using pt::cp_async4;
using pt::cp_async_commit;
using pt::cp_async_wait;

// ------------------------------------------------------------ tensor cores
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInf = __builtin_huge_valf();

// the pool slot of logical token t of a sequence (t below the table's
// capacity; a page id out of range is clamped into the pool)
__device__ __forceinline__ int64_t token_slot(const int* __restrict__ table,
                                              int t, int page_size,
                                              int num_pages) {
  int page = table[t / page_size];
  page = min(max(page, 0), num_pages - 1);
  return (int64_t)page * page_size + t % page_size;
}

// live prefix of window position s of row b (0 for a dead row)
__device__ __forceinline__ int live_prefix(const int* __restrict__ ctx_len,
                                           const unsigned char* __restrict__ valid,
                                           const int* __restrict__ positions,
                                           int b, int s, int S, int capacity,
                                           int chunked) {
  const int ctx_b = min(max(ctx_len[b], 0), capacity);
  if (!chunked) return ctx_b;
  const int idx = b * S + s;
  return valid[idx] ? max(min(positions[idx] + 1, ctx_b), 0) : 0;
}

// 16 int8 values widened to bf16 (exact), as two 16-byte words
__device__ __forceinline__ void widen_int8x16(const int4 v, uint4& lo,
                                              uint4& hi) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pt::pack_bf16(static_cast<float>(e[2 * i]),
                         static_cast<float>(e[2 * i + 1]));
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// ============================================================ window kernel
namespace win {

constexpr int kTok = 64;       // context tokens per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

constexpr int kSplitTiles = 8;  // tiles a block takes in split mode

// Shared-memory plan of one block. WQ warps along the window (16 rows
// each), kWarps / WQ along each context tile; TKV the pools' type. A
// 16-row block (WQ == 1) runs in split mode: it takes kSplitTiles tiles of
// the context and writes its partial softmax state for the combine kernel.
template <typename TKV, int D, int WQ>
struct Plan {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr bool kSplit = WQ == 1;
  static constexpr int BQ = 16 * WQ;                // window rows per block
  static constexpr int WK = kWarps / WQ;            // warps along a tile
  static constexpr int TOKW = kTok / WK;            // tokens per warp
  static constexpr int STAGES = kSplit ? 3 : (kQuant ? 3 : 2);
  static constexpr int ROW = D + 8;                 // bf16 row, padded
  static constexpr int ROW_B = ROW * 2;             // its bytes
  // a staged K or V tile: bf16 rows (padded), or raw int8 rows
  static constexpr int TILE_B = kQuant ? kTok * D : kTok * ROW_B;
  static constexpr int CH = D * (int)sizeof(TKV) / 16;  // 16 B chunks a row
  static constexpr int RING_OFF = 0;
  static constexpr int SCALE_OFF = RING_OFF + STAGES * 2 * TILE_B;
  static constexpr int WIDE_OFF =
      SCALE_OFF + (kQuant ? STAGES * 2 * kTok * 4 : 0);
  static constexpr int NLIVE_OFF = WIDE_OFF + (kQuant ? 2 * kTok * ROW_B : 0);
  static constexpr int BYTES = NLIVE_OFF + BQ * 4;
  // the query rows are staged where nothing is written before the first
  // tile is consumed (they go to registers first): the widened int8 tiles,
  // or the ring's last stage, which the prologue leaves empty
  static constexpr int Q_OFF =
      kQuant ? WIDE_OFF : RING_OFF + (STAGES - 1) * 2 * TILE_B;
  static_assert(BQ * ROW_B <= (kQuant ? 2 * kTok * ROW_B : 2 * TILE_B),
                "the query rows must fit where they are staged");
  // the warps' merge (WK > 1) reuses the ring after the last tile
  static constexpr int MERGE_B = WK * 16 * (D + 2) * 4;
  static_assert(WK == 1 || MERGE_B <= STAGES * 2 * TILE_B,
                "merge area must fit in the ring");
  static_assert((kTok * CH) % kThreads == 0, "tile copies per thread");
  static_assert(kSplit == (WK > 1), "split mode merges the warps' states");
};

template <typename TKV, int D, int WQ>
__global__ void __launch_bounds__(kThreads) paged_attention_window_kernel(
    const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ tables, const int* __restrict__ ctx_len,
    const unsigned char* __restrict__ valid,
    const int* __restrict__ positions, float* __restrict__ work_acc,
    float* __restrict__ work_m, float* __restrict__ work_l, int S, int H,
    int num_pages, int page_size, int P, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, float scale_log2, int chunked) {
  using L = Plan<TKV, D, WQ>;
  constexpr int BQ = L::BQ, WK = L::WK, TOKW = L::TOKW, STAGES = L::STAGES;
  constexpr int NT = TOKW / 8;      // score n-tiles a warp
  constexpr int DT = D / 8;         // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  int* n_live_s = reinterpret_cast<int*>(smem + L::NLIVE_OFF);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // split mode: one 16-row tile (S <= 16), blockIdx.y picks the context
  // chunk; otherwise blockIdx.y picks the query tile
  const int s0 = L::kSplit ? 0 : blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int capacity = P * page_size;
  const int* table = tables + (int64_t)b * P;

  if (tid < BQ)
    n_live_s[tid] = s0 + tid < S ? live_prefix(ctx_len, valid, positions, b,
                                               s0 + tid, S, capacity, chunked)
                                 : 0;
  __syncthreads();
  int kv_end = 0;
#pragma unroll 8
  for (int r = 0; r < BQ; ++r) kv_end = max(kv_end, n_live_s[r]);
  // this block's tiles [tb, te) of the context
  int tb = 0, te = ceil_div(kv_end, kTok);
  if constexpr (L::kSplit) {
    tb = blockIdx.y * kSplitTiles;
    te = min(te, tb + kSplitTiles);
    if (tb >= te) {
      // past every row's context; every row dead: the first block writes
      // the zeros
      if (te == 0 && blockIdx.y == 0)
        for (int i = tid; i < S * D; i += kThreads)
          out[(((int64_t)b * S + i / D) * H + h) * D + i % D] =
              pt::from_float<__nv_bfloat16>(0.f);
      return;
    }
  }
  const int n_tiles = te - tb;
  const int64_t slot_stride = (int64_t)H * D;

  // gather context tile `tile` into ring stage `st`: each 16-byte chunk of
  // a token row through the token's own page; rows past kv_end zero-filled
  auto load_tile = [&](int tile, int st) {
    unsigned char* kt = smem + L::RING_OFF + st * 2 * L::TILE_B;
    unsigned char* vt = kt + L::TILE_B;
#pragma unroll
    for (int i = 0; i < kTok * L::CH / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / L::CH, c = idx % L::CH;
      const int t = tile * kTok + r;
      const bool live = t < kv_end;
      const int64_t off =
          live ? token_slot(table, t, page_size, num_pages) * slot_stride +
                     h * D
               : 0;
      const int dst = L::kQuant ? r * D + c * 16 : r * L::ROW_B + c * 16;
      const TKV* ks = k_pool + off;
      const TKV* vs = v_pool + off;
      cp_async16(smem_addr(kt + dst),
                 reinterpret_cast<const unsigned char*>(ks) + c * 16, live);
      cp_async16(smem_addr(vt + dst),
                 reinterpret_cast<const unsigned char*>(vs) + c * 16, live);
    }
    if constexpr (L::kQuant) {
      // one f32 scale per (slot, head) for each token, beside its values
      float* sc = reinterpret_cast<float*>(smem + L::SCALE_OFF) +
                  st * 2 * kTok;
      const int r = tid % kTok;
      const int t = tile * kTok + r;
      const bool live = t < kv_end;
      const int64_t off =
          live ? token_slot(table, t, page_size, num_pages) * H + h : 0;
      const float* src = (tid < kTok ? k_scales : v_scales) + off;
      cp_async4(smem_addr(sc + (tid < kTok ? 0 : kTok) + r), src, live);
    }
  };

  if (n_tiles == 0) {
    // every row of the block is dead (or past S): zeros
    for (int i = tid; i < BQ * D; i += kThreads) {
      const int s = s0 + i / D;
      if (s < S)
        out[(((int64_t)b * S + s) * H + h) * D + i % D] =
            pt::from_float<__nv_bfloat16>(0.f);
    }
    return;
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(tb + st, st);
    cp_async_commit();
  }

  // the block's query rows, bf16, into shared memory (zeros past S)
  {
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(q) | (uintptr_t)(q_sb * 2) |
          (uintptr_t)(q_ss * 2) | (uintptr_t)(q_sh * 2)) &
         15) == 0;
    if (vec) {
      for (int i = tid; i < BQ * (D / 8); i += kThreads) {
        const int r = i / (D / 8), c = i % (D / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (s0 + r < S)
          v = *reinterpret_cast<const uint4*>(qb + (s0 + r) * q_ss + c * 8);
        *reinterpret_cast<uint4*>(q_s + r * L::ROW + c * 8) = v;
      }
    } else {
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int r = i / D, c = i % D;
        q_s[r * L::ROW + c] = s0 + r < S ? qb[(s0 + r) * q_ss + c]
                                         : pt::from_float<__nv_bfloat16>(0.f);
      }
    }
  }
  __syncthreads();

  // this warp's 16 rows and its share of each tile
  const int wq = warp % WQ, wk = warp / WQ;
  const int row0 = wq * 16;
  const int g = lane >> 2, c4 = lane & 3;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(smem_addr(q_s + (row0 + (lane & 15)) * L::ROW + kk * 16 +
                      (lane >> 4) * 8),
            qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
  const int nA = n_live_s[row0 + g], nB = n_live_s[row0 + g + 8];
  // longest live prefix among the warp's rows: tiles past it are skipped
  int w_end = max(nA, nB);
#pragma unroll
  for (int off = 16; off >= 4; off >>= 1)
    w_end = max(w_end, __shfl_xor_sync(pt::kFullMask, w_end, off));

  float mA = -kInf, mB = -kInf, lA = 0.f, lB = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile i is in, and the stage tile i - 1 read is free
    {
      const int nxt = i + STAGES - 1;
      if (nxt < n_tiles) load_tile(tb + nxt, nxt % STAGES);
      cp_async_commit();
    }
    const int it = tb + i;    // the tile's index in the context
    const int st = i % STAGES;
    const unsigned char* kt = smem + L::RING_OFF + st * 2 * L::TILE_B;
    const unsigned char* vt = kt + L::TILE_B;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (L::kQuant) {
      // widen the int8 tiles to bf16 once, for ldmatrix
      unsigned char* wide = smem + L::WIDE_OFF;
      for (int i = tid; i < 2 * kTok * (D / 16); i += kThreads) {
        const int kv = i / (kTok * (D / 16));
        const int r = (i / (D / 16)) % kTok, c = i % (D / 16);
        const int4 v = *reinterpret_cast<const int4*>(
            (kv ? vt : kt) + r * D + c * 16);
        uint4 lo, hi;
        widen_int8x16(v, lo, hi);
        uint4* dst = reinterpret_cast<uint4*>(wide + kv * kTok * L::ROW_B +
                                              r * L::ROW_B + c * 32);
        dst[0] = lo;
        dst[1] = hi;
      }
      ksc = reinterpret_cast<const float*>(smem + L::SCALE_OFF) +
            st * 2 * kTok;
      vsc = ksc + kTok;
      kt = wide;
      vt = wide + kTok * L::ROW_B;
      __syncthreads();
    }
    const int t0 = it * kTok + wk * TOKW;     // this warp's first token
    if (t0 >= w_end) continue;                // warp-uniform
    const int tw = wk * TOKW;                 // its first row in the tile

    // S = Q K^T over this warp's TOKW tokens
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        const int mi = lane >> 3;
        const int r = tw + jn * 16 + (mi >> 1) * 8 + (lane & 7);
        const int col = kk * 16 + (mi & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(kt + r * L::ROW_B + col * 2), b0, b1, b2, b3);
        mma_bf16(sc[2 * jn], qa[kk], b0, b1);
        mma_bf16(sc[2 * jn + 1], qa[kk], b2, b3);
      }
    }
    // scale (and the K scale), mask, row max over the quad
    float mxA = -kInf, mxB = -kInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tl = tw + j * 8 + 2 * c4 + e;    // token in the tile
        const int t = it * kTok + tl;
        float f = scale_log2;
        if constexpr (L::kQuant) f *= ksc[tl];
        sc[j][e] = t < nA ? sc[j][e] * f : -kInf;
        sc[j][2 + e] = t < nB ? sc[j][2 + e] * f : -kInf;
        mxA = fmaxf(mxA, sc[j][e]);
        mxB = fmaxf(mxB, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(pt::kFullMask, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(pt::kFullMask, mxB, off));
    }
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    // a row with nothing live yet keeps m = -inf and gets p = 0
    const float uA = mnA == -kInf ? 0.f : mnA;
    const float uB = mnB == -kInf ? 0.f : mnB;
    const float aA = exp2f(mA - uA), aB = exp2f(mB - uB);
    mA = mnA;
    mB = mnB;
    lA *= aA;
    lB *= aB;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= aA;
      o[j][1] *= aA;
      o[j][2] *= aB;
      o[j][3] *= aB;
    }
    // per 16 tokens: p, its row sums, P (the V scale folded in) as bf16
    // hi + lo parts, and O += P V
#pragma unroll
    for (int kb = 0; kb < NT / 2; ++kb) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kb + jj;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(sc[j][e] - (e < 2 ? uA : uB));
          if (e < 2) lA += p[e]; else lB += p[e];
        }
        if constexpr (L::kQuant) {
          const int tl = tw + j * 8 + 2 * c4;
          const float v0 = vsc[tl], v1 = vsc[tl + 1];
          p[0] *= v0;
          p[1] *= v1;
          p[2] *= v0;
          p[3] *= v1;
        }
        // A fragment: n-tile 2kb gives a0 (row g) / a1 (row g + 8), n-tile
        // 2kb + 1 gives a2 / a3
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = p[2 * e], x1 = p[2 * e + 1];
          const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hb);
          ph[2 * jj + e] = *reinterpret_cast<const uint32_t*>(&hb);
          pl[2 * jj + e] = pt::pack_bf16(x0 - hf.x, x1 - hf.y);
        }
      }
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        const int mi = lane >> 3;
        const int r = tw + kb * 16 + (mi & 1) * 8 + (lane & 7);
        const int col = dn * 16 + (mi >> 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(vt + r * L::ROW_B + col * 2), b0, b1, b2, b3);
        mma_bf16(o[2 * dn], ph, b0, b1);
        mma_bf16(o[2 * dn], pl, b0, b1);
        mma_bf16(o[2 * dn + 1], ph, b2, b3);
        mma_bf16(o[2 * dn + 1], pl, b2, b3);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    lA += __shfl_xor_sync(pt::kFullMask, lA, off);
    lB += __shfl_xor_sync(pt::kFullMask, lB, off);
  }
  const int64_t out_row = (int64_t)H * D;
  __nv_bfloat16* ob = out + ((int64_t)b * S) * out_row + h * D;
  if constexpr (WK == 1) {
    const float iA = lA > 0.f ? 1.f / lA : 0.f;
    const float iB = lB > 0.f ? 1.f / lB : 0.f;
    const int sA = s0 + row0 + g, sB = sA + 8;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + 2 * c4;
      if (sA < S)
        *reinterpret_cast<uint32_t*>(ob + sA * out_row + d) =
            pt::pack_bf16(o[j][0] * iA, o[j][1] * iA);
      if (sB < S)
        *reinterpret_cast<uint32_t*>(ob + sB * out_row + d) =
            pt::pack_bf16(o[j][2] * iB, o[j][3] * iB);
    }
  } else {
    // merge the WK warps' states of the same 16 rows (the ring is free)
    __syncthreads();
    float* m_w = reinterpret_cast<float*>(smem + L::RING_OFF);  // [WK][16]
    float* l_w = m_w + WK * 16;                                   // [WK][16]
    float* a_w = l_w + WK * 16;                                   // [WK][16][D]
    if (c4 == 0) {
      m_w[wk * 16 + g] = mA;
      m_w[wk * 16 + g + 8] = mB;
      l_w[wk * 16 + g] = lA;
      l_w[wk * 16 + g + 8] = lB;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + 2 * c4;
      float* ra = a_w + (wk * 16 + g) * D + d;
      float* rb = a_w + (wk * 16 + g + 8) * D + d;
      ra[0] = o[j][0];
      ra[1] = o[j][1];
      rb[0] = o[j][2];
      rb[1] = o[j][3];
    }
    __syncthreads();
    // the block's state of each row: the output itself when one block
    // took the whole context, else a partial state for the combine kernel
    const bool alone = ceil_div(kv_end, kSplitTiles * kTok) == 1;
    const int64_t part = ((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * S;
    for (int i = tid; i < S * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float mx = -kInf;
#pragma unroll
      for (int w = 0; w < WK; ++w) mx = fmaxf(mx, m_w[w * 16 + r]);
      float num = 0.f, den = 0.f;
      if (mx != -kInf) {
#pragma unroll
        for (int w = 0; w < WK; ++w) {
          const float e = exp2f(m_w[w * 16 + r] - mx);   // 0 for -inf
          den += l_w[w * 16 + r] * e;
          num += a_w[(w * 16 + r) * D + d] * e;
        }
      }
      if (alone) {
        ob[r * out_row + d] =
            pt::from_float<__nv_bfloat16>(den > 0.f ? num / den : 0.f);
      } else {
        work_acc[(part + r) * D + d] = num;
        if (d == 0) {
          work_m[part + r] = mx;
          work_l[part + r] = den;
        }
      }
    }
  }
}

}  // namespace win

// ==================================================== split-context decode
namespace dec {

constexpr int kChunk = 128;    // context tokens per block (bf16, int8 pools)
// ... over float pools: a float row is 512 bytes at D=128, so 64 tokens put
// as many K/V bytes in flight (67.6 KB) as 128 bf16 tokens
constexpr int kChunkF32 = 64;
constexpr int kThreads = 128;  // one token a thread when scoring
static_assert(kChunkF32 <= kChunk, "float q's workspace is sized for it");

template <typename TKV, int D>
struct Plan {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr bool kFloat = std::is_same<TKV, float>::value;
  static constexpr int CHUNK = kFloat ? kChunkF32 : kChunk;
  static constexpr int CH = D * (int)sizeof(TKV) / 16;   // 16 B chunks a row
  static constexpr int E = 16 / (int)sizeof(TKV);        // values a chunk
  static constexpr int ROW_B = D * (int)sizeof(TKV) + 16;  // padded row
  static constexpr int G = kThreads / CH;                // PV token groups
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + CHUNK * ROW_B;
  static constexpr int Q_OFF = V_OFF + CHUNK * ROW_B;          // float [D]
  static constexpr int P_OFF = Q_OFF + D * 4;                  // [CHUNK]
  static constexpr int KS_OFF = P_OFF + CHUNK * 4;             // [CHUNK]
  static constexpr int VS_OFF = KS_OFF + CHUNK * 4;            // [CHUNK]
  static constexpr int RED_OFF = VS_OFF + CHUNK * 4;           // [2][warps]
  static constexpr int ACC_OFF = RED_OFF + 2 * (kThreads / 32) * 4;
  static constexpr int SLOT_OFF = ACC_OFF + G * D * 4;         // [G][D]
  static constexpr int BYTES = SLOT_OFF + CHUNK * 4;           // int [CHUNK]
  static_assert(kThreads % CH == 0, "PV groups");
  static_assert(CHUNK <= kThreads, "one token a thread");
};

// the dot of q (float, in shared memory) with one 16-byte chunk of a K row,
// into four partial sums (dims 4i + k go to sum k)
template <typename TKV>
__device__ __forceinline__ void dot_chunk(const uint4 raw, const float4* qv,
                                          float (&dot)[4]) {
  if constexpr (std::is_same<TKV, int8_t>::value) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 qq = qv[j];
      dot[0] = fmaf(qq.x, static_cast<float>(e[4 * j]), dot[0]);
      dot[1] = fmaf(qq.y, static_cast<float>(e[4 * j + 1]), dot[1]);
      dot[2] = fmaf(qq.z, static_cast<float>(e[4 * j + 2]), dot[2]);
      dot[3] = fmaf(qq.w, static_cast<float>(e[4 * j + 3]), dot[3]);
    }
  } else if constexpr (std::is_same<TKV, float>::value) {
    const float4 qq = qv[0];
    dot[0] = fmaf(qq.x, __uint_as_float(raw.x), dot[0]);
    dot[1] = fmaf(qq.y, __uint_as_float(raw.y), dot[1]);
    dot[2] = fmaf(qq.z, __uint_as_float(raw.z), dot[2]);
    dot[3] = fmaf(qq.w, __uint_as_float(raw.w), dot[3]);
  } else {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 qq = qv[j];
      const float2 a = __bfloat1622float2(e[2 * j]);
      const float2 bb = __bfloat1622float2(e[2 * j + 1]);
      dot[0] = fmaf(qq.x, a.x, dot[0]);
      dot[1] = fmaf(qq.y, a.y, dot[1]);
      dot[2] = fmaf(qq.z, bb.x, dot[2]);
      dot[3] = fmaf(qq.w, bb.y, dot[3]);
    }
  }
}

// acc[0..E) += p times one 16-byte chunk of a V row
template <typename TKV, int E>
__device__ __forceinline__ void pv_chunk(const uint4 raw, float p,
                                         float (&acc)[E]) {
  if constexpr (std::is_same<TKV, int8_t>::value) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      acc[j] = fmaf(p, static_cast<float>(e[j]), acc[j]);
  } else if constexpr (std::is_same<TKV, float>::value) {
    acc[0] = fmaf(p, __uint_as_float(raw.x), acc[0]);
    acc[1] = fmaf(p, __uint_as_float(raw.y), acc[1]);
    acc[2] = fmaf(p, __uint_as_float(raw.z), acc[2]);
    acc[3] = fmaf(p, __uint_as_float(raw.w), acc[3]);
  } else {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(e[j]);
      acc[2 * j] = fmaf(p, v.x, acc[2 * j]);
      acc[2 * j + 1] = fmaf(p, v.y, acc[2 * j + 1]);
    }
  }
}

// TQ: q's and out's type (bf16 or float); TKV: the pools' (TQ, or int8)
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ ctx_len, TQ* __restrict__ out,
    float* __restrict__ work_acc, float* __restrict__ work_m,
    float* __restrict__ work_l, int H, int num_pages, int page_size, int P,
    int64_t q_sb, int64_t q_sh, float scale_log2) {
  using L = Plan<TKV, D>;
  constexpr int kChunkT = L::CHUNK;
  static_assert(D <= kThreads, "a thread per output column");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* p_s = reinterpret_cast<float*>(smem + L::P_OFF);
  float* ks_s = reinterpret_cast<float*>(smem + L::KS_OFF);
  float* vs_s = reinterpret_cast<float*>(smem + L::VS_OFF);
  float* red = reinterpret_cast<float*>(smem + L::RED_OFF);
  float* acc_s = reinterpret_cast<float*>(smem + L::ACC_OFF);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int chunk = blockIdx.y;
  const int capacity = P * page_size;
  const int ctx_b = min(max(ctx_len[b], 0), capacity);
  const int t0 = chunk * kChunkT;
  const int tid = threadIdx.x;
  if (t0 >= ctx_b) {
    // past the context: not part of the merge; a dead lane: zeros
    if (ctx_b == 0 && chunk == 0 && tid < D)
      out[(int64_t)bh * D + tid] = pt::from_float<TQ>(0.f);
    return;
  }
  const int n = min(kChunkT, ctx_b - t0);
  const int* table = tables + (int64_t)b * P;
  const int64_t slot_stride = (int64_t)H * D;

  // the chunk's pool slots, once a token: the table's latency and the
  // division stay off the copies' path (each 16-byte copy of a row would
  // resolve its page again)
  int* slot_s = reinterpret_cast<int*>(smem + L::SLOT_OFF);
  if (tid < n)
    slot_s[tid] = (int)token_slot(table, t0 + tid, page_size, num_pages);
  __syncthreads();
  // group 0: the chunk's K rows (and both scales); group 1: its V rows
  for (int i = tid; i < n * L::CH; i += kThreads) {
    const int r = i / L::CH, c = i % L::CH;
    const int64_t off = (int64_t)slot_s[r] * slot_stride + h * D;
    cp_async16(smem_addr(smem + L::K_OFF + r * L::ROW_B + c * 16),
               reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
               true);
  }
  if constexpr (L::kQuant) {
    if (tid < n) {
      const int64_t off = (int64_t)slot_s[tid] * H + h;
      cp_async4(smem_addr(ks_s + tid), k_scales + off, true);
      cp_async4(smem_addr(vs_s + tid), v_scales + off, true);
    }
  }
  cp_async_commit();
  for (int i = tid; i < n * L::CH; i += kThreads) {
    const int r = i / L::CH, c = i % L::CH;
    const int64_t off = (int64_t)slot_s[r] * slot_stride + h * D;
    cp_async16(smem_addr(smem + L::V_OFF + r * L::ROW_B + c * 16),
               reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
               true);
  }
  cp_async_commit();
  for (int d = tid; d < D; d += kThreads)
    q_s[d] = pt::to_float(q[b * q_sb + h * q_sh + d]);
  cp_async_wait<1>();
  __syncthreads();

  // one token a thread: its whole row against q (broadcast from shared)
  float s = -kInf;
  if (tid < n) {
    const unsigned char* kr = smem + L::K_OFF + tid * L::ROW_B;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < L::CH; ++c)
      dot_chunk<TKV>(*reinterpret_cast<const uint4*>(kr + c * 16),
                     reinterpret_cast<const float4*>(q_s + c * L::E), dot);
    // the K scale factors out of the dot
    s = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale_log2 *
        (L::kQuant ? ks_s[tid] : 1.f);
  }
  // the chunk's max and sum, once
  const int warp = tid >> 5, lane = tid & 31;
  float m = pt::warp_max(s);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float p = tid < n ? exp2f(s - m) : 0.f;   // token t0 is live
  float l = pt::warp_sum(p);
  if (lane == 0) red[kThreads / 32 + warp] = l;
  // the V scale folds into p
  if (tid < kChunkT) p_s[tid] = L::kQuant && tid < n ? p * vs_s[tid] : p;
  cp_async_wait<0>();
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) l += red[kThreads / 32 + w];

  // acc = sum_t p_t v_t: each thread E columns of every G-th token
  const int c = tid % L::CH, grp = tid / L::CH;
  float acc[L::E];
#pragma unroll
  for (int e = 0; e < L::E; ++e) acc[e] = 0.f;
  for (int t = grp; t < n; t += L::G)
    pv_chunk<TKV, L::E>(*reinterpret_cast<const uint4*>(
                            smem + L::V_OFF + t * L::ROW_B + c * 16),
                        p_s[t], acc);
#pragma unroll
  for (int e = 0; e < L::E; ++e) acc_s[grp * D + c * L::E + e] = acc[e];
  __syncthreads();
  float a = 0.f;
  if (tid < D) {
#pragma unroll
    for (int gi = 0; gi < L::G; ++gi) a += acc_s[gi * D + tid];
  }
  // the whole context in this chunk: the output itself (l >= 1: token t0
  // is live; a NaN score makes l NaN); else the partial state, for the
  // combine kernel
  if (ceil_div(ctx_b, kChunkT) == 1) {
    if (tid < D) out[(int64_t)bh * D + tid] = pt::from_float<TQ>(a / l);
    return;
  }
  const int64_t part = (int64_t)bh * gridDim.y + chunk;
  if (tid < D) work_acc[part * D + tid] = a;
  if (tid == 0) {
    work_m[part] = m;
    work_l[part] = l;
  }
}

}  // namespace dec

// Merge the split kernels' partial states: one block per (b, h) and window
// row s, a thread per column. The workspace holds acc [B*H, n_chunks, S, D],
// then m and l [B*H, n_chunks, S]. A row reads its parts that hold a live
// token; when one part covered the whole (b, h) the split kernel wrote the
// output itself, and a dead row gets zeros from there too. The parts' m and
// l are read by all threads at once, their weights staged in shared memory,
// and the acc loads of a group of parts issued together: a few L2 round
// trips, whatever the number of parts.
template <typename TO, int D>
__global__ void __launch_bounds__(D) paged_attention_combine_kernel(
    const float* __restrict__ work_acc, const float* __restrict__ work_m,
    const float* __restrict__ work_l, const int* __restrict__ ctx_len,
    const unsigned char* __restrict__ valid,
    const int* __restrict__ positions, TO* __restrict__ out,
    int S, int H, int capacity, int chunk_tokens, int n_chunks, int chunked) {
  constexpr int kWarps = D / 32;
  __shared__ float w_s[D];
  __shared__ float red[kWarps];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int s = blockIdx.y;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  // the split kernel's own test for "one part covered everything"
  int kv_end = 0;
  for (int r = 0; r < S; ++r)
    kv_end = max(kv_end, live_prefix(ctx_len, valid, positions, b, r, S,
                                     capacity, chunked));
  if (ceil_div(kv_end, chunk_tokens) <= 1) return;
  const int n_parts = ceil_div(
      live_prefix(ctx_len, valid, positions, b, s, S, capacity, chunked),
      chunk_tokens);
  const int64_t base = (int64_t)bh * n_chunks;
  float mx = -kInf;
  for (int c = d; c < n_parts; c += D)
    mx = fmaxf(mx, work_m[(base + c) * S + s]);
  mx = pt::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  float num = 0.f, den = 0.f;
  if (mx != -kInf) {
    for (int g = 0; g < n_parts; g += D) {
      __syncthreads();              // the previous group's weights are read
      const int c = g + d;
      float w = 0.f;
      if (c < n_parts) {
        const int64_t i = (base + c) * S + s;
        w = exp2f(work_m[i] - mx);   // 0 for -inf
        den += work_l[i] * w;
      }
      w_s[d] = w;
      __syncthreads();
      const int ng = min(D, n_parts - g);
#pragma unroll 16
      for (int j = 0; j < ng; ++j)
        num += w_s[j] * work_acc[((base + g + j) * S + s) * D + d];
    }
  }
  // den: each thread holds the sum over its own parts
  den = pt::warp_sum(den);
  __syncthreads();
  if (lane == 0) red[warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) den += red[w];
  // den is 0 only for a row with no live token (a live row's largest part
  // has l >= 1); a NaN den keeps the plain version's NaN
  out[(((int64_t)b * S + s) * H + h) * D + d] =
      pt::from_float<TO>(den != 0.f ? num / den : 0.f);
}

// ================================================== float32 window kernel
namespace win32 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// context tokens a tile: a split block's four warps take 16 tokens each of
// a 64-token tile (the combine kernel's chunks are win's: kSplitTiles of
// them); a 64-row block's warps each read the whole tile, 32 tokens, which
// keeps two blocks an SM in shared memory at D=128
constexpr int kSplitTok = 64;
constexpr int kWideTok = 32;
static_assert(kSplitTok == win::kTok, "split chunks are the bf16 kernel's");

// Shared-memory plan of one block: WQ warps along the window (16 rows
// each), kWarps / WQ along each context tile (WQ == 1: split mode, as the
// bf16 kernel's); TKV the pools' type (float, or int8 widened to float in
// shared memory once a tile). Strides in floats: K rows D + 8 and V rows
// D + 4 (each tile is read one way: see the header), Q rows D + 8.
template <typename TKV, int D, int WQ>
struct Plan {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr bool kSplit = WQ == 1;
  static constexpr int TOK = kSplit ? kSplitTok : kWideTok;
  static constexpr int BQ = 16 * WQ;                // window rows per block
  static constexpr int WK = kWarps / WQ;            // warps along a tile
  static constexpr int TOKW = TOK / WK;             // tokens per warp
  static constexpr int NT = TOKW / 8;               // 8-token steps a warp
  static constexpr int STAGES = kQuant ? 3 : 2;
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 4;
  static constexpr int QS = D + 8;
  static constexpr int CH = D * (int)sizeof(TKV) / 16;  // 16 B chunks a row
  // a staged K or V tile: float rows (padded), or raw int8 rows
  static constexpr int K_TILE_B = kQuant ? TOK * D : TOK * KS * 4;
  static constexpr int V_TILE_B = kQuant ? TOK * D : TOK * VS * 4;
  static constexpr int STAGE_B = K_TILE_B + V_TILE_B;
  static constexpr int RING_OFF = 0;
  static constexpr int SCALE_OFF = RING_OFF + STAGES * STAGE_B;
  static constexpr int WIDE_OFF =
      SCALE_OFF + (kQuant ? STAGES * 2 * TOK * 4 : 0);
  static constexpr int Q_OFF = WIDE_OFF + (kQuant ? TOK * (KS + VS) * 4 : 0);
  static constexpr int NLIVE_OFF = Q_OFF + BQ * QS * 4;
  static constexpr int SLOT_OFF = NLIVE_OFF + BQ * 4;   // int [STAGES][TOK]
  static constexpr int ORDER_OFF = SLOT_OFF + STAGES * TOK * 4;
  static constexpr int BYTES = ORDER_OFF + 16;
  // the warps' merge (WK > 1) reuses the ring after the last tile
  static constexpr int MERGE_B = WK * 16 * (D + 2) * 4;
  static_assert(WK == 1 || MERGE_B <= STAGES * STAGE_B,
                "merge area must fit in the ring");
  static_assert((TOK * CH) % kThreads == 0, "tile copies per thread");
  static_assert(2 * TOK <= kThreads, "a thread per token scale");
  static_assert(kSplit == (WK > 1), "split mode merges the warps' states");
  static_assert(TOKW % 8 == 0, "8-token steps");
};

// Rows of the batch with up to kRankRows rows are taken longest context
// first: the rank-i row of the batch by ctx_len (ties by index) for block
// rank i; with more rows, row i. Blocks start in index order, so a ragged
// batch in the given order would leave its longest rows for last.
constexpr int kRankRows = 64;

__device__ __forceinline__ int row_by_rank(const int* __restrict__ ctx_len,
                                           int B, int i, int* found) {
  if (B > kRankRows) return i;
  if (threadIdx.x == 0) *found = i;
  __syncthreads();
  for (int c = threadIdx.x; c < B; c += kThreads) {
    const int kc = ctx_len[c];
    int rank = 0;
    for (int o = 0; o < B; ++o) {
      const int ko = ctx_len[o];
      rank += ko > kc || (ko == kc && o < c);
    }
    if (rank == i) *found = c;
  }
  __syncthreads();
  return *found;
}

template <typename TKV, int D, int WQ>
__global__ void __launch_bounds__(kThreads) paged_attention_window_f32_kernel(
    const float* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, float* __restrict__ out,
    const int* __restrict__ tables, const int* __restrict__ ctx_len,
    const unsigned char* __restrict__ valid,
    const int* __restrict__ positions, float* __restrict__ work_acc,
    float* __restrict__ work_m, float* __restrict__ work_l, int S, int H,
    int num_pages, int page_size, int P, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, float scale, int chunked) {
  using L = Plan<TKV, D, WQ>;
  constexpr int TOK = L::TOK, BQ = L::BQ, WK = L::WK, TOKW = L::TOKW;
  constexpr int NT = L::NT, STAGES = L::STAGES;
  constexpr int DK = D / 8;         // 8-dim steps of a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q_OFF);
  int* n_live_s = reinterpret_cast<int*>(smem + L::NLIVE_OFF);
  int* slot_s = reinterpret_cast<int*>(smem + L::SLOT_OFF);

  // split mode: one 16-row tile (S <= 16), blockIdx.y picks the context
  // chunk; otherwise the blocks of one row of the batch (its heads and
  // query tiles) are consecutive, longest context first
  int b, h, s0;
  if constexpr (L::kSplit) {
    b = blockIdx.x / H;
    h = blockIdx.x % H;
    s0 = 0;
  } else {
    const int per_row = H * gridDim.y;
    const int lin = blockIdx.y * gridDim.x + blockIdx.x;
    b = row_by_rank(ctx_len, gridDim.x / H, lin / per_row,
                    reinterpret_cast<int*>(smem + L::ORDER_OFF));
    h = lin % H;
    s0 = (lin % per_row) / H * BQ;
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int capacity = P * page_size;
  const int* table = tables + (int64_t)b * P;

  if (tid < BQ)
    n_live_s[tid] = s0 + tid < S ? live_prefix(ctx_len, valid, positions, b,
                                               s0 + tid, S, capacity, chunked)
                                 : 0;
  __syncthreads();
  int kv_end = 0;
#pragma unroll 8
  for (int r = 0; r < BQ; ++r) kv_end = max(kv_end, n_live_s[r]);
  // this block's tiles [tb, te) of the context
  int tb = 0, te = ceil_div(kv_end, TOK);
  if constexpr (L::kSplit) {
    tb = blockIdx.y * win::kSplitTiles;
    te = min(te, tb + win::kSplitTiles);
    if (tb >= te) {
      // past every row's context; every row dead: the first block writes
      // the zeros
      if (te == 0 && blockIdx.y == 0)
        for (int i = tid; i < S * D; i += kThreads)
          out[(((int64_t)b * S + i / D) * H + h) * D + i % D] = 0.f;
      return;
    }
  }
  const int n_tiles = te - tb;
  const int64_t slot_stride = (int64_t)H * D;

  // the pool slots of tile `tile`'s tokens into slot ring entry `st`, an
  // iteration before the tile's copies are issued (the table's latency and
  // the division stay off the copies' path)
  auto fill_slots = [&](int tile, int st) {
    const int t = tile * TOK + tid;
    if (tid < TOK)
      slot_s[st * TOK + tid] =
          t < kv_end ? (int)token_slot(table, t, page_size, num_pages) : 0;
  };
  // gather context tile `tile` into ring stage `st`: each 16-byte chunk of
  // a token row through the token's own page; rows past kv_end zero-filled
  auto load_tile = [&](int tile, int st) {
    unsigned char* kt = smem + L::RING_OFF + st * L::STAGE_B;
    unsigned char* vt = kt + L::K_TILE_B;
#pragma unroll
    for (int i = 0; i < TOK * L::CH / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / L::CH, c = idx % L::CH;
      const int t = tile * TOK + r;
      const bool live = t < kv_end;
      const int64_t off =
          live ? (int64_t)slot_s[st * TOK + r] * slot_stride + h * D : 0;
      const int kd = L::kQuant ? r * D + c * 16 : r * L::KS * 4 + c * 16;
      const int vd = L::kQuant ? r * D + c * 16 : r * L::VS * 4 + c * 16;
      cp_async16(smem_addr(kt + kd),
                 reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
                 live);
      cp_async16(smem_addr(vt + vd),
                 reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
                 live);
    }
    if constexpr (L::kQuant) {
      // one f32 scale per (slot, head) for each token, beside its values
      if (tid < 2 * TOK) {
        float* sc = reinterpret_cast<float*>(smem + L::SCALE_OFF) +
                    st * 2 * TOK;
        const int r = tid % TOK;
        const int t = tile * TOK + r;
        const bool live = t < kv_end;
        const int64_t off = live ? (int64_t)slot_s[st * TOK + r] * H + h : 0;
        const float* src = (tid < TOK ? k_scales : v_scales) + off;
        cp_async4(smem_addr(sc + (tid < TOK ? 0 : TOK) + r), src, live);
      }
    }
  };

  if (n_tiles == 0) {
    // every row of the block is dead (or past S): zeros
    for (int i = tid; i < BQ * D; i += kThreads) {
      const int s = s0 + i / D;
      if (s < S) out[(((int64_t)b * S + s) * H + h) * D + i % D] = 0.f;
    }
    return;
  }
  // slots of the first STAGES tiles, then the first STAGES - 1 tiles' copies
#pragma unroll
  for (int st = 0; st < STAGES; ++st)
    if (st < n_tiles) fill_slots(tb + st, st);
  __syncthreads();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(tb + st, st);
    cp_async_commit();
  }

  // the block's query rows into shared memory (zeros past S): 16-byte
  // loads when every row is 16-byte aligned, else one float at a time
  {
    const float* qb = q + b * q_sb + h * q_sh;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(q) | (uintptr_t)(q_sb * 4) |
          (uintptr_t)(q_ss * 4) | (uintptr_t)(q_sh * 4)) &
         15) == 0;
    if (vec) {
      for (int i = tid; i < BQ * (D / 4); i += kThreads) {
        const int r = i / (D / 4), c = i % (D / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + r < S)
          v = *reinterpret_cast<const float4*>(qb + (s0 + r) * q_ss + c * 4);
        *reinterpret_cast<float4*>(q_s + r * L::QS + c * 4) = v;
      }
    } else {
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int r = i / D, c = i % D;
        q_s[r * L::QS + c] = s0 + r < S ? qb[(s0 + r) * q_ss + c] : 0.f;
      }
    }
  }
  __syncthreads();

  // this warp's 16 rows (g and g + 8 of its tile) and its share of a tile
  const int wq = warp % WQ, wk = warp / WQ;
  const int row0 = wq * 16;
  const int g = lane >> 2, c4 = lane & 3;
  const float* qrow = q_s + (row0 + g) * L::QS;
  const int nA = n_live_s[row0 + g], nB = n_live_s[row0 + g + 8];
  // longest live prefix among the warp's rows: tiles past it are skipped
  int w_end = max(nA, nB);
#pragma unroll
  for (int off = 16; off >= 4; off >>= 1)
    w_end = max(w_end, __shfl_xor_sync(pt::kFullMask, w_end, off));

  // running max (natural units) and this thread's columns' sum of rows g
  // and g + 8, and their outputs (columns 8j + 2t, 8j + 2t + 1)
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};
  float o[DK][4];
#pragma unroll
  for (int j = 0; j < DK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile i is in, and the stage tile i - 1 read is free
    {
      const int nxt = i + STAGES - 1;
      if (nxt < n_tiles) load_tile(tb + nxt, nxt % STAGES);
      cp_async_commit();
      // entry i % STAGES served tile i's copies, issued an iteration or
      // more ago: it takes the tile after next's slots
      if (i + STAGES < n_tiles) fill_slots(tb + i + STAGES, i % STAGES);
    }
    const int it = tb + i;    // the tile's index in the context
    const int st = i % STAGES;
    const unsigned char* stage = smem + L::RING_OFF + st * L::STAGE_B;
    const float* kt = reinterpret_cast<const float*>(stage);
    const float* vt = reinterpret_cast<const float*>(stage + L::K_TILE_B);
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (L::kQuant) {
      // widen the int8 tiles to float once (exact, and exact in TF32): four
      // values a thread, so neighbouring threads write neighbouring words
      float* wide_k = reinterpret_cast<float*>(smem + L::WIDE_OFF);
      float* wide_v = wide_k + TOK * L::KS;
      for (int j = tid; j < 2 * TOK * (D / 4); j += kThreads) {
        const int kv = j / (TOK * (D / 4));
        const int r = (j / (D / 4)) % TOK, c = j % (D / 4);
        const char4 v = *reinterpret_cast<const char4*>(
            stage + (kv ? L::K_TILE_B : 0) + r * D + c * 4);
        *reinterpret_cast<float4*>(
            (kv ? wide_v + r * L::VS : wide_k + r * L::KS) + c * 4) =
            make_float4(v.x, v.y, v.z, v.w);
      }
      ksc = reinterpret_cast<const float*>(smem + L::SCALE_OFF) +
            st * 2 * TOK;
      vsc = ksc + TOK;
      kt = wide_k;
      vt = wide_v;
      __syncthreads();
    }
    const int t0 = it * TOK + wk * TOKW;      // this warp's first token
    if (t0 >= w_end) continue;                // warp-uniform
    const int tw = wk * TOKW;                 // its first row in the tile

    // S = Q K^T over this warp's TOKW tokens: rows g, g + 8, tokens
    // 8j + 2t + {0, 1}; each 8-dim step's products summed from zero and
    // joined to the score in one rounded add
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ah[4], al[4];
      tf32::a_fragment<L::QS>(qrow, kk, c4, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            kt + (tw + 8 * j + g) * L::KS + kk * 8 + 2 * c4);
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (L::kQuant) {
          // q_lo k + q_hi k: an int8 value is exact in TF32
          tf32::mma_tf32(step, al, __float_as_uint(kv.x),
                         __float_as_uint(kv.y));
          tf32::mma_tf32(step, ah, __float_as_uint(kv.x),
                         __float_as_uint(kv.y));
        } else {
          tf32::mma_3xtf32(step, ah, al, kv.x, kv.y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += step[e];
      }
    }
    // the scale after the dot (and the K scale), the mask, the row max over
    // the quad; a NaN score is skipped by fmaxf and reaches p
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = tw + 8 * j + 2 * c4 + (e & 1);   // token in the tile
        const int t = it * TOK + tl;
        float f = scale;
        if constexpr (L::kQuant) f *= ksc[tl];
        const float x = t < (e < 2 ? nA : nB) ? sc[j][e] * f : -kInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(pt::kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(pt::kFullMask, mx[r], 2));
      // a row with nothing live yet keeps m = -inf and gets p = 0
      const float use = mx[r] == -kInf ? 0.f : mx[r];
      alpha[r] = hopper::exp2_approx((m[r] - use) * kLog2e);
      ml[r] = use * kLog2e;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p = 2^(s log2 e - m log2 e) and its row sums
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = hopper::exp2_approx(fmaf(sc[j][e], kLog2e, -ml[e >> 1]));
        l[e >> 1] += sc[j][e];
      }
    // O = O alpha + P V: tokens 8j..8j+7 relabelled (k-index t is token
    // 2t, t + 4 is token 2t + 1), so V is read at tokens 2t and 2t + 1. P
    // (the V scale folded in over int8 pools) is split into hi + lo in the
    // A operand's order one 8-token step at a time, and every 8-column
    // block of O sums this tile's products from zero in its own registers
    // (the blocks' product chains are independent) and joins O in one
    // rounded FFMA with the rescale
    const float* v0 = vt + (tw + 2 * c4) * L::VS + g;
    float pv[DK][4];
#pragma unroll
    for (int dn = 0; dn < DK; ++dn)
      pv[dn][0] = pv[dn][1] = pv[dn][2] = pv[dn][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (L::kQuant) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] *= vsc[tw + 8 * j + 2 * c4 + (e & 1)];
      }
      uint32_t ph[4], pl[4];
      tf32::score_fragment(sc[j], ph, pl);
#pragma unroll
      for (int dn = 0; dn < DK; ++dn) {
        const float va = v0[8 * j * L::VS + dn * 8];
        const float vb = v0[(8 * j + 1) * L::VS + dn * 8];
        if constexpr (L::kQuant) {
          // p_lo v + p_hi v: v exact in TF32
          tf32::mma_tf32(pv[dn], pl, __float_as_uint(va), __float_as_uint(vb));
          tf32::mma_tf32(pv[dn], ph, __float_as_uint(va), __float_as_uint(vb));
        } else {
          tf32::mma_3xtf32(pv[dn], ph, pl, va, vb);
        }
      }
    }
#pragma unroll
    for (int dn = 0; dn < DK; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dn][e] = fmaf(o[dn][e], alpha[e >> 1], pv[dn][e]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(pt::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(pt::kFullMask, l[r], 2);
  }
  const int64_t out_row = (int64_t)H * D;
  float* ob = out + ((int64_t)b * S) * out_row + h * D;
  if constexpr (WK == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = s0 + row0 + g + 8 * r;
      if (s >= S) continue;
      // l is 0 only for a dead row (a live row's max gives p = 1); a NaN l
      // keeps the plain version's NaN
      const float lr = l[r];
#pragma unroll
      for (int j = 0; j < DK; ++j)
        *reinterpret_cast<float2*>(ob + s * out_row + 8 * j + 2 * c4) =
            lr != 0.f ? make_float2(o[j][2 * r] / lr, o[j][2 * r + 1] / lr)
                      : make_float2(0.f, 0.f);
    }
  } else {
    // merge the WK warps' states of the same 16 rows (the ring is free)
    __syncthreads();
    float* m_w = reinterpret_cast<float*>(smem + L::RING_OFF);  // [WK][16]
    float* l_w = m_w + WK * 16;                                   // [WK][16]
    float* a_w = l_w + WK * 16;                                   // [WK][16][D]
    if (c4 == 0) {
      m_w[wk * 16 + g] = m[0];
      m_w[wk * 16 + g + 8] = m[1];
      l_w[wk * 16 + g] = l[0];
      l_w[wk * 16 + g + 8] = l[1];
    }
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      const int d = j * 8 + 2 * c4;
      *reinterpret_cast<float2*>(a_w + (wk * 16 + g) * D + d) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(a_w + (wk * 16 + g + 8) * D + d) =
          make_float2(o[j][2], o[j][3]);
    }
    __syncthreads();
    // the block's state of each row: the output itself when one block
    // took the whole context, else a partial state for the combine kernel
    // (its m in the exp2 domain, as the other split kernels write it)
    const bool alone = ceil_div(kv_end, win::kSplitTiles * TOK) == 1;
    const int64_t part = ((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * S;
    for (int i = tid; i < S * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float mxr = -kInf;
#pragma unroll
      for (int w = 0; w < WK; ++w) mxr = fmaxf(mxr, m_w[w * 16 + r]);
      float num = 0.f, den = 0.f;
      if (mxr != -kInf) {
#pragma unroll
        for (int w = 0; w < WK; ++w) {
          const float e = exp2f((m_w[w * 16 + r] - mxr) * kLog2e);  // 0: -inf
          den += l_w[w * 16 + r] * e;
          num += a_w[(w * 16 + r) * D + d] * e;
        }
      }
      if (alone) {
        ob[r * out_row + d] = den != 0.f ? num / den : 0.f;
      } else {
        work_acc[(part + r) * D + d] = num;
        if (d == 0) {
          work_m[part + r] = mxr * kLog2e;
          work_l[part + r] = den;
        }
      }
    }
  }
}

}  // namespace win32

// ------------------------------------------------------------- launchers
struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;
  const float* v_scales;
  void* out;
  const int* tables;
  const int* ctx_len;
  const unsigned char* valid;
  const int* positions;
  int B, S, H, num_pages, page_size, P;
  int64_t q_sb, q_ss, q_sh;
  float scale;
  int chunked;
  float* work;
  int64_t work_floats;
  cudaStream_t stream;
};

// Context chunks of the split kernels: a decode row takes `decode_chunk`
// tokens a block (dec::Plan's CHUNK); a window of at most 16 rows
// kSplitTiles tiles; other windows do not split (0).
inline int split_tokens(int kind, int S, int decode_chunk) {
  if (kind == 0 && S == 1) return decode_chunk;
  if (S <= 16) return win::kSplitTiles * win::kTok;
  return 0;
}

// Floats of the split kernels' workspace for context chunks of `chunk`
// tokens (0: none): acc [B*H, n_chunks, S, D], then m and l [B*H, n_chunks,
// S]
inline int64_t split_floats(int B, int S, int H, int D, int page_size,
                            int P, int chunk) {
  if (chunk == 0) return 0;
  const int64_t n_chunks = ceil_div<int64_t>((int64_t)P * page_size, chunk);
  return (int64_t)B * H * n_chunks * S * (D + 2);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  // above 48 KB a block's shared memory must be asked for
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// the window kernel of q's type: bf16 on m16n8k16 (the exp2 domain, so the
// scale goes in times log2 e), float32 in 3xTF32 (natural units)
template <typename TQ, typename TKV, int D, int WQ>
cudaError_t launch_window(const Args& a, float* work_acc, float* work_m,
                          float* work_l, int n_chunks) {
  constexpr bool kF32 = std::is_same<TQ, float>::value;
  using L = std::conditional_t<kF32, win32::Plan<TKV, D, WQ>,
                               win::Plan<TKV, D, WQ>>;
  auto kernel = [] {
    if constexpr (kF32)
      return win32::paged_attention_window_f32_kernel<TKV, D, WQ>;
    else
      return win::paged_attention_window_kernel<TKV, D, WQ>;
  }();
  static const cudaError_t attr = allow_smem(kernel, L::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.B * a.H, L::kSplit ? n_chunks : ceil_div(a.S, L::BQ));
  kernel<<<grid, win::kThreads, L::BYTES, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.k_scales, a.v_scales,
      static_cast<TQ*>(a.out), a.tables, a.ctx_len, a.valid, a.positions,
      work_acc, work_m, work_l, a.S, a.H, a.num_pages, a.page_size, a.P,
      a.q_sb, a.q_ss, a.q_sh, kF32 ? a.scale : a.scale * kLog2e, a.chunked);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_decode(const Args& a, float* work_acc, float* work_m,
                          float* work_l, int n_chunks) {
  using L = dec::Plan<TKV, D>;
  auto kernel = dec::paged_attention_decode_kernel<TQ, TKV, D>;
  static const cudaError_t attr = allow_smem(kernel, L::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.B * a.H, n_chunks);
  kernel<<<grid, dec::kThreads, L::BYTES, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.k_scales, a.v_scales, a.tables,
      a.ctx_len, static_cast<TQ*>(a.out), work_acc, work_m, work_l, a.H,
      a.num_pages, a.page_size, a.P, a.q_sb, a.q_sh, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_typed(const Args& a) {
  // one decode row: the split-context decode kernel; windows of at most 16
  // rows: 16-row window blocks over chunks of the context; both then merged
  // by the combine kernel. Longer windows: 64-row tiles of 16 rows a warp
  // over the whole context.
  const int kind = a.chunked ? 1 : 0;
  const int chunk = split_tokens(kind, a.S, dec::Plan<TKV, D>::CHUNK);
  if (chunk == 0)
    return launch_window<TQ, TKV, D, 4>(a, nullptr, nullptr, nullptr, 0);
  const int64_t n_chunks =
      ceil_div<int64_t>((int64_t)a.P * a.page_size, chunk);
  const int64_t parts = (int64_t)a.B * a.H * n_chunks * a.S;
  if (n_chunks > 65535 || a.work == nullptr ||
      a.work_floats < split_floats(a.B, a.S, a.H, D, a.page_size, a.P, chunk))
    return cudaErrorInvalidValue;
  float* work_acc = a.work;
  float* work_m = work_acc + parts * D;
  float* work_l = work_m + parts;
  const cudaError_t err =
      a.S == 1 && kind == 0
          ? launch_decode<TQ, TKV, D>(a, work_acc, work_m, work_l,
                                      (int)n_chunks)
          : launch_window<TQ, TKV, D, 1>(a, work_acc, work_m, work_l,
                                         (int)n_chunks);
  if (err != cudaSuccess) return err;
  paged_attention_combine_kernel<TQ, D>
      <<<dim3(a.B * a.H, a.S), D, 0, a.stream>>>(
          work_acc, work_m, work_l, a.ctx_len, a.valid, a.positions,
          static_cast<TQ*>(a.out), a.S, a.H, a.P * a.page_size, chunk,
          (int)n_chunks, a.chunked);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, int dtype, int kv_dtype) {
  const bool quant = kv_dtype == pt::kInt8;
  if (quant && (a.k_scales == nullptr || a.v_scales == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == pt::kBFloat16)
    return quant ? launch_typed<__nv_bfloat16, int8_t, D>(a)
                 : launch_typed<__nv_bfloat16, __nv_bfloat16, D>(a);
  return quant ? launch_typed<float, int8_t, D>(a)
               : launch_typed<float, float, D>(a);
}

}  // namespace

// Floats of workspace that pt_paged_attention needs for this call (the
// split kernels' partial states; 0 for calls that do not split). float32
// q gets the size for float pools, whose decode chunks are the shortest.
extern "C" int64_t pt_paged_workspace_floats(int B, int S, int H, int D,
                                             int page_size, int P, int kind,
                                             int dtype) {
  if ((dtype != pt::kBFloat16 && dtype != pt::kFloat32) || page_size < 1 ||
      P < 1)
    return 0;
  const int decode_chunk =
      dtype == pt::kFloat32 ? dec::kChunkF32 : dec::kChunk;
  return split_floats(B, S, H, D, page_size, P,
                      split_tokens(kind, S, decode_chunk));
}

// C entry point bound with ctypes (ops/_build.py). kind: 0 = decode,
// 1 = chunked (valid, one byte per position, and positions are read only
// for chunked). dtype is q's and out's type; kv_dtype the pools' (dtype
// itself, or pt::kInt8 with the f32 scale pools k_scales/v_scales, which are
// null otherwise). work: pt_paged_workspace_floats(...) floats of device
// memory (may be unused). Returns cudaGetLastError() after the launches; a
// shape or type it does not take returns cudaErrorInvalidValue without
// launching.
extern "C" int pt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const float* k_scales,
                                  const float* v_scales, void* out,
                                  const int* tables, const int* ctx_len,
                                  const unsigned char* valid,
                                  const int* positions, int B, int S, int H,
                                  int D, int num_pages, int page_size, int P,
                                  int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                  float scale, int kind, int dtype,
                                  int kv_dtype, float* work,
                                  int64_t work_floats, void* stream) {
  if (page_size < 1 || num_pages < 1 || P < 1 ||
      (int64_t)P * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype != dtype && kv_dtype != pt::kInt8)
    return (int)cudaErrorInvalidValue;
  if (dtype != pt::kFloat32 && dtype != pt::kBFloat16)
    return (int)cudaErrorInvalidValue;
  const Args a{q,         k_pool,     v_pool,    k_scales, v_scales, out,
               tables,    ctx_len,    valid,     positions, B,       S,
               H,         num_pages,  page_size, P,         q_sb,    q_ss,
               q_sh,      scale,      kind == 1 ? 1 : 0,   work,
               work_floats, static_cast<cudaStream_t>(stream)};
  if (D == 64) return (int)launch_d<64>(a, dtype, kv_dtype);
  if (D == 128) return (int)launch_d<128>(a, dtype, kv_dtype);
  return (int)cudaErrorInvalidValue;
}
