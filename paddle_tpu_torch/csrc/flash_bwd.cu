// Flash-attention backward for Hopper (sm_90a): the port of the two TPU
// kernels of paddle_tpu/ops/pallas_attention.py::_mha_bwd,
// _mha_bwd_dq_kernel (pallas_call at :288) and _mha_bwd_dkv_kernel (:313).
//
// What it computes, per (batch, head), from q, k, v, dO, the forward's row
// logsumexp lse and delta = rowsum(o * dO) (minus an optional lse cotangent,
// folded in by the wrapper):
//   p  = exp(q k^T * scale - lse)          (0 where the causal mask or a
//                                           ragged edge hides the key)
//   dp = dO v^T
//   ds = p * (dp - delta) * scale
//   dq = ds k        dk = ds^T q        dv = p^T dO
// with every product accumulated in float, as the reference. Two kernels, as
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
// What bounds it on the H100: dq is 3 products of 2*S^2*D flops per head, dk/dv
// 4, both halved when causal, against ~5*S*D elements moved: at training
// widths (S = 2048, D = 128) it is bound by operations. What the design does
// about it: bf16 inputs run every product on the tensor cores with
// mma.sync.m16n8k16 (float accumulation); each of a block's 4 warps owns 16
// rows, keeps its score, dP and gradient accumulators in registers, and turns
// the score accumulators straight into the A operand of the next product,
// rounding p (for dv) and ds (for dq, dk) to bf16 there, as the reference
// rounds them to the input type. The streamed tiles sit in shared memory in
// row-major form (for the q k^T and dO v^T products) and, where a product
// runs along the streamed rows, transposed as well, so every fragment load
// is one 32-bit word. float32 inputs take float-FMA kernels (exact float32,
// held to the 67 TFLOP/s float rate) over 64x64 tiles in shared memory, as
// the forward's float32 path. Causal tiles stop at the diagonal and ragged
// sequence lengths are masked at the edge, so every S the forward takes has a
// backward (the TPU's multiple-of-128 gate and its XLA crossover below
// S = 1024 do not carry over). wgmma + TMA and a fused kernel are later work.
#include "common.cuh"

namespace {

using pt::ld32;
using pt::mma_bf16;
using pt::pack_bf16;

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

// ---------------------------------------------------------------- bf16 path
using bf16 = __nv_bfloat16;
constexpr int kMmaRows = 64;     // rows a block owns: 4 warps x 16
constexpr int kMmaTile = 64;     // rows of a streamed tile
constexpr int kMmaThreads = 128;
constexpr int kTPitch = kMmaTile + 8;  // row pitch of the transposed tiles

template <int D>
constexpr size_t dq_bf16_smem() {
  // Q, dO, K, V [64][D + 8] and K transposed [D][72]
  return sizeof(bf16) * (size_t)(4 * kMmaRows * (D + 8) + D * kTPitch);
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  // K, V, Q, dO [64][D + 8], Q and dO transposed [D][72], lse and delta
  return sizeof(bf16) * (size_t)(4 * kMmaRows * (D + 8) + 2 * D * kTPitch) +
         sizeof(float) * 2 * kMmaTile;
}

// acc[nb] += A B^T for one warp: A = 16 rows of a [64][D + 8] tile starting
// at row wr, B = the 64 rows of another; acc[nb] is the 16 x 8 block of
// columns nb*8 .. nb*8+7 (rows g, g+8 / columns 2t, 2t+1 of a thread)
template <int D>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* A,
                                        const bf16* B, int wr, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = A + (wr + g) * LD + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(p0), ld32(p0 + 8 * LD), ld32(p0 + 8),
                            ld32(p0 + 8 * LD + 8)};
#pragma unroll
    for (int nb = 0; nb < kMmaTile / 8; ++nb) {
      const bf16* bp = B + (nb * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(acc[nb], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// out[j] += X M for one warp: X = the warp's 16 x 64 block held in C layout
// (x[nb], as mma_abt leaves it), rounded to bf16 here, M = a 64 x D tile given
// transposed (Mt [D][kTPitch]); out[j] is the 16 x 8 block of columns j*8..
template <int D>
__device__ __forceinline__ void mma_xm(float (*out)[4], float (*x)[4],
                                       const bf16* Mt, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < kMmaTile / 16; ++kb) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kb][0], x[2 * kb][1]),
                            pack_bf16(x[2 * kb][2], x[2 * kb][3]),
                            pack_bf16(x[2 * kb + 1][0], x[2 * kb + 1][1]),
                            pack_bf16(x[2 * kb + 1][2], x[2 * kb + 1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const bf16* bp = Mt + (j * 8 + g) * kTPitch + kb * 16 + 2 * t;
      mma_bf16(out[j], xa, ld32(bp), ld32(bp + 8));
    }
  }
}

// rows g and g + 8 of a warp's 16 x D accumulator into a contiguous
// [B, S, H, D] bf16 tensor at sequence positions pos[0], pos[1]
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, float (*acc)[4],
                                           const int* pos, int S, int b,
                                           int H, int h, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= S) continue;
    bf16* row = out + (((int64_t)b * S + pos[i]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) dq_bf16_kernel(BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr int NB = kMmaTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + kMmaRows * LD;
  bf16* Ks = Os + kMmaRows * LD;
  bf16* Vs = Ks + kMmaTile * LD;
  bf16* Kt = Vs + kMmaTile * LD;  // [D][kTPitch]

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kMmaRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;

  pt::load_rows<D, kMmaRows, kMmaThreads>(qb, a.q_ss, q0, a.Sq, Qs, tid);
  pt::load_rows<D, kMmaRows, kMmaThreads>(ob, a.o_ss, q0, a.Sq, Os, tid);
  // this thread's query rows wr + g (i = 0) and wr + g + 8 (i = 1)
  const int qpos[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = qpos[i] < a.Sq;
    lse_r[i] = ok ? a.lse[(int64_t)bh * a.Sq + qpos[i]] : 0.f;
    dl_r[i] = ok ? a.delta[(int64_t)bh * a.Sq + qpos[i]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int q_hi = min(q0 + kMmaRows, a.Sq);
  const int k_end = a.causal ? min(q_hi, a.Sk) : a.Sk;
  const int n_tiles = (k_end + kMmaTile - 1) / kMmaTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kMmaTile;
    __syncthreads();  // every warp is done with the previous tiles
    pt::load_rows<D, kMmaTile, kMmaThreads>(kb, a.k_ss, k0, a.Sk, Ks, tid);
    pt::load_rows<D, kMmaTile, kMmaThreads>(vb, a.v_ss, k0, a.Sk, Vs, tid);
    pt::load_rows_t<D, kMmaTile, kMmaThreads>(kb, a.k_ss, k0, a.Sk, Kt,
                                              kTPitch, tid);
    __syncthreads();
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_abt<D>(s, Qs, Ks, wr, g, t);    // q k^T
    mma_abt<D>(dp, Os, Vs, wr, g, t);   // dO v^T
    // ds, in place of the scores
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        const float p = visible(qpos[i], kpos, a)
                            ? expf(s[nb][e] * a.scale - lse_r[i])
                            : 0.f;
        s[nb][e] = p * (dp[nb][e] - dl_r[i]) * a.scale;
      }
    mma_xm<D>(acc, s, Kt, g, t);        // dq += ds k
  }
  store_rows<D>(static_cast<bf16*>(a.dq), acc, qpos, a.Sq, b, a.H, h, t);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) dkv_bf16_kernel(BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr int NB = kMmaTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMmaRows * LD;
  bf16* Qs = Vs + kMmaRows * LD;
  bf16* Os = Qs + kMmaTile * LD;
  bf16* Qt = Os + kMmaTile * LD;   // [D][kTPitch]
  bf16* Ot = Qt + D * kTPitch;     // [D][kTPitch]
  float* lse_s = reinterpret_cast<float*>(Ot + D * kTPitch);
  float* dl_s = lse_s + kMmaTile;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kMmaRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;

  pt::load_rows<D, kMmaRows, kMmaThreads>(kb, a.k_ss, k0, a.Sk, Ks, tid);
  pt::load_rows<D, kMmaRows, kMmaThreads>(vb, a.v_ss, k0, a.Sk, Vs, tid);
  // this thread's key rows wr + g (i = 0) and wr + g + 8 (i = 1)
  const int kpos[2] = {k0 + wr + g, k0 + wr + g + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // causal: query tiles from the one holding query k0 (tiles are aligned)
  const int qt0 = a.causal ? k0 / kMmaTile : 0;
  const int n_tiles = (a.Sq + kMmaTile - 1) / kMmaTile;
  for (int qt = qt0; qt < n_tiles; ++qt) {
    const int q0 = qt * kMmaTile;
    __syncthreads();
    pt::load_rows<D, kMmaTile, kMmaThreads>(qb, a.q_ss, q0, a.Sq, Qs, tid);
    pt::load_rows<D, kMmaTile, kMmaThreads>(ob, a.o_ss, q0, a.Sq, Os, tid);
    pt::load_rows_t<D, kMmaTile, kMmaThreads>(qb, a.q_ss, q0, a.Sq, Qt,
                                              kTPitch, tid);
    pt::load_rows_t<D, kMmaTile, kMmaThreads>(ob, a.o_ss, q0, a.Sq, Ot,
                                              kTPitch, tid);
    if (tid < kMmaTile) {
      const bool ok = q0 + tid < a.Sq;
      lse_s[tid] = ok ? a.lse[(int64_t)bh * a.Sq + q0 + tid] : 0.f;
      dl_s[tid] = ok ? a.delta[(int64_t)bh * a.Sq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_abt<D>(s, Ks, Qs, wr, g, t);    // s^T = k q^T
    mma_abt<D>(dp, Vs, Os, wr, g, t);   // dP^T = v dO^T
    // p^T in place of s^T, ds^T in place of dP^T
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + 2 * t + (e & 1);
        const float p = visible(q0 + c, kpos[e >> 1], a)
                            ? expf(s[nb][e] * a.scale - lse_s[c])
                            : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - dl_s[c]) * a.scale;
      }
    mma_xm<D>(dv, s, Ot, g, t);         // dv += p^T dO
    mma_xm<D>(dk, dp, Qt, g, t);        // dk += ds^T q
  }
  store_rows<D>(static_cast<bf16*>(a.dk), dk, kpos, a.Sk, b, a.H, h, t);
  store_rows<D>(static_cast<bf16*>(a.dv), dv, kpos, a.Sk, b, a.H, h, t);
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
    return launch(dq_bf16_kernel<64>, dq_bf16_smem<64>(), B, Sq, kMmaRows,
                  kMmaThreads, a, st);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch(dq_bf16_kernel<128>, dq_bf16_smem<128>(), B, Sq, kMmaRows,
                  kMmaThreads, a, st);
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
    return launch(dkv_bf16_kernel<64>, dkv_bf16_smem<64>(), B, Sk, kMmaRows,
                  kMmaThreads, a, st);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch(dkv_bf16_kernel<128>, dkv_bf16_smem<128>(), B, Sk,
                  kMmaRows, kMmaThreads, a, st);
  return (int)cudaErrorInvalidValue;
}
