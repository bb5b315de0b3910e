// Paged attention for Hopper (sm_90a): the port of the TPU kernel
// paddle_tpu/ops/pallas_paged_attention.py::paged_attention (kernel body
// _paged_kernel), kinds "decode" and "chunked" over float or bf16 pools.
//
// What it computes: for each (row b, window position s, head h) the softmax
// attention of q[b, s, h] over the K/V slots of sequence b, read through its
// block table: logical token t lives in pool page tables[b, t / page_size] at
// offset t % page_size. The score is (q . k) * scale (scale after the dot, as
// the reference). The mask is a prefix of the context in both kinds:
//   decode:  t < ctx_len[b]
//   chunked: t <= positions[b, s] and valid[b, s] (and t < ctx_len[b])
// so each row has n_live slots, and a row with n_live == 0 (a dead decode lane
// or an invalid window position) writes zeros.
//
// What bounds it on the H100: decode reads every live K/V slot once and does
// 4*D flops per slot and head, far below the card's 295 flops/byte balance,
// so it is bound by the bytes of the context (3.35 TB/s). What the design
// does about it: one block per (row, head, query tile) walks only the tokens
// up to n_live (nothing past the context is loaded, and the gathered context
// never exists in device memory). Its warps (sixteen for a decode row,
// eight for a chunked window's eight rows) split the context into 32-token
// tiles and each keeps its own online softmax, merged once at the end. A lane
// owns D/32 consecutive columns: every K or V row is one coalesced vector
// load per lane (8 bytes for bf16 at D=128), straight from the pool into
// registers (for a decode row in bursts of eight rows, so that one HBM
// latency covers eight tokens), and q . k is a warp-shuffle sum. Each block loads its own
// page ids from the table, which replaces the TPU's scalar prefetch and the
// pages_per_tile-fold pool passing (BlockSpec workarounds). Splitting one
// sequence over several blocks (when a batch has fewer (row, head) pairs than
// the card has SMs, or ragged lengths leave SMs idle) is the next step.
#include "common.cuh"

namespace {

constexpr int kTile = 32;  // tokens per warp tile: one per lane

// VEC consecutive elements of T, widened to float
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* __restrict__ p,
                                                   float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* __restrict__ p,
                                                   float* out) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(
    const __nv_bfloat16* __restrict__ p, float* out) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 fa = __bfloat1622float2(a);
  out[0] = fa.x; out[1] = fa.y;
}

// BQ query rows per block, NW warps, K/V rows loaded BURST at a time before
// they are used
template <typename T, int D, int BQ, int NW, int BURST>
__global__ void __launch_bounds__(NW * 32) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, T* __restrict__ out,
    const int* __restrict__ tables, const int* __restrict__ ctx_len,
    const unsigned char* __restrict__ valid, const int* __restrict__ positions, int S,
    int H, int num_pages, int page_size, int P, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, float scale, int chunked) {
  constexpr int VEC = D / 32;  // consecutive columns per lane
  constexpr int kThreads = NW * 32;
  __shared__ int n_live_s[BQ];
  __shared__ float m_w[NW][BQ];
  __shared__ float l_w[NW][BQ];
  __shared__ float acc_w[NW][BQ][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int s0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col = lane * VEC;
  const int capacity = P * page_size;  // slots the table can address
  const int ctx_b = min(max(ctx_len[b], 0), capacity);

  if (tid < BQ) {
    const int s = s0 + tid;
    int n = 0;
    if (s < S) {
      if (chunked) {
        const int idx = b * S + s;
        n = valid[idx] ? min(positions[idx] + 1, ctx_b) : 0;
      } else {
        n = ctx_b;
      }
    }
    n_live_s[tid] = max(n, 0);
  }
  // this lane's columns of every query row of the tile, in registers
  float qr[BQ][VEC];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    const int s = min(s0 + r, S - 1);
    const T* qp = q + b * q_sb + s * q_ss + h * q_sh + col;
#pragma unroll
    for (int j = 0; j < VEC; ++j) qr[r][j] = pt::to_float(qp[j]);
  }
  __syncthreads();
  int n_live[BQ];
  int kv_end = 0;
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    n_live[r] = n_live_s[r];
    kv_end = max(kv_end, n_live[r]);
  }

  float m[BQ], l[BQ], acc[BQ][VEC];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    m[r] = pt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
  }

  const int64_t slot_stride = (int64_t)H * D;
  const int* table = tables + (int64_t)b * P;
  const T* k_base = k_pool + h * D + col;
  const T* v_base = v_pool + h * D + col;

  for (int t0 = warp * kTile; t0 < kv_end; t0 += NW * kTile) {
    // lane i resolves the pool slot of token t0 + i through the table
    const int n_tile = min(kTile, kv_end - t0);
    int64_t slot = 0;
    if (lane < n_tile) {
      const int t = t0 + lane;
      int page = table[t / page_size];
      page = min(max(page, 0), num_pages - 1);
      slot = (int64_t)page * page_size + t % page_size;
    }
    // scores: lane i keeps the score of token t0 + i for every row
    float sc[BQ];
#pragma unroll
    for (int r = 0; r < BQ; ++r) sc[r] = pt::kNegInf;
    for (int i0 = 0; i0 < n_tile; i0 += BURST) {
      float kv[BURST][VEC];
#pragma unroll
      for (int u = 0; u < BURST; ++u) {
        const int64_t si = __shfl_sync(pt::kFullMask, slot, i0 + u);
        if (i0 + u < n_tile) {
          load_vec<T, VEC>(k_base + si * slot_stride, kv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) kv[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < BURST; ++u) {
#pragma unroll
        for (int r = 0; r < BQ; ++r) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) part = fmaf(qr[r][j], kv[u][j], part);
          const float s = pt::warp_sum(part) * scale;
          if (lane == i0 + u && i0 + u < n_tile && t0 + i0 + u < n_live[r])
            sc[r] = s;
        }
      }
    }
    // online softmax per row over this tile
    float p[BQ];
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      p[r] = 0.f;
      if (t0 >= n_live[r]) continue;  // uniform: no live token of row r here
      // token t0 is live, so m_new is a real score and masked lanes get 0
      const float m_new = fmaxf(m[r], pt::warp_max(sc[r]));
      p[r] = expf(sc[r] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + pt::warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] *= alpha;
    }
    // acc += P V
    for (int i0 = 0; i0 < n_tile; i0 += BURST) {
      float vv[BURST][VEC];
#pragma unroll
      for (int u = 0; u < BURST; ++u) {
        const int64_t si = __shfl_sync(pt::kFullMask, slot, i0 + u);
        if (i0 + u < n_tile) {
          load_vec<T, VEC>(v_base + si * slot_stride, vv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) vv[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < BURST; ++u) {
#pragma unroll
        for (int r = 0; r < BQ; ++r) {
          // p is 0 for masked tokens and lanes past the tile
          const float pi = __shfl_sync(pt::kFullMask, p[r], i0 + u);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[r][j] = fmaf(pi, vv[u][j], acc[r][j]);
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    if (lane == 0) {
      m_w[warp][r] = m[r];
      l_w[warp][r] = l[r];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_w[warp][r][col + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r;
    if (s >= S) continue;
    float o = 0.f;
    if (n_live_s[r] > 0) {
      float mx = pt::kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_w[w][r]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float e = expf(m_w[w][r] - mx);
        den += l_w[w][r] * e;
        num += acc_w[w][r][d] * e;
      }
      o = num / fmaxf(den, 1e-30f);
    }
    out[(((int64_t)b * S + s) * H + h) * D + d] = pt::from_float<T>(o);
  }
}

template <typename T, int D, int BQ, int NW, int BURST>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   void* out, const int* tables, const int* ctx_len,
                   const unsigned char* valid, const int* positions, int B, int S,
                   int H, int num_pages, int page_size, int P, int64_t q_sb,
                   int64_t q_ss, int64_t q_sh, float scale, int chunked,
                   cudaStream_t stream) {
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  paged_attention_kernel<T, D, BQ, NW, BURST><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<T*>(out), tables, ctx_len,
      valid, positions, S, H, num_pages, page_size, P, q_sb, q_ss, q_sh,
      scale, chunked);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k_pool,
                        const void* v_pool, void* out, const int* tables,
                        const int* ctx_len, const unsigned char* valid,
                        const int* positions, int B, int S, int H,
                        int num_pages, int page_size, int P, int64_t q_sb,
                        int64_t q_ss, int64_t q_sh, float scale, int chunked,
                        cudaStream_t stream) {
  // a decode step has one query row per block and sixteen warps splitting
  // its context, loading eight rows at a time; a chunked window eight rows
  // and eight warps, whose eight dot products per row already overlap loads
  if (S == 1)
    return launch<T, D, 1, 16, 8>(q, k_pool, v_pool, out, tables, ctx_len, valid,
                           positions, B, S, H, num_pages, page_size, P, q_sb,
                           q_ss, q_sh, scale, chunked, stream);
  return launch<T, D, 8, 8, 1>(q, k_pool, v_pool, out, tables, ctx_len, valid,
                         positions, B, S, H, num_pages, page_size, P, q_sb,
                         q_ss, q_sh, scale, chunked, stream);
}

}  // namespace

// C entry point bound with ctypes (ops/_build.py). kind: 0 = decode,
// 1 = chunked (valid, one byte per position, and positions are read only
// for chunked). Returns
// cudaGetLastError() after the launch; a shape it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int pt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, void* out,
                                  const int* tables, const int* ctx_len,
                                  const unsigned char* valid, const int* positions,
                                  int B, int S, int H, int D, int num_pages,
                                  int page_size, int P, int64_t q_sb,
                                  int64_t q_ss, int64_t q_sh, float scale,
                                  int kind, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_size < 1 || page_size > 64 || num_pages < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
#define PT_PAGED_ARGS                                                   \
  q, k_pool, v_pool, out, tables, ctx_len, valid, positions, B, S, H,   \
      num_pages, page_size, P, q_sb, q_ss, q_sh, scale, kind, st
  if (dtype == pt::kFloat32 && D == 64)
    return launch_rows<float, 64>(PT_PAGED_ARGS);
  if (dtype == pt::kFloat32 && D == 128)
    return launch_rows<float, 128>(PT_PAGED_ARGS);
  if (dtype == pt::kBFloat16 && D == 64)
    return launch_rows<__nv_bfloat16, 64>(PT_PAGED_ARGS);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch_rows<__nv_bfloat16, 128>(PT_PAGED_ARGS);
#undef PT_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
