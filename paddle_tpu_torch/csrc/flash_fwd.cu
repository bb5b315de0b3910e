// Flash-attention forward for Hopper (sm_90a): the port of the TPU kernel
// paddle_tpu/ops/pallas_attention.py::_mha_fwd (kernel body _mha_fwd_kernel).
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
// What bounds it on the H100: at serving prefill widths (S up to 2048, D=128)
// the work is 4*S^2*D/2 flops per (batch, head) against 4*S*D elements moved,
// so it is bound by operations. What the design does about it: bf16 inputs
// take the tensor-core kernel below (mma.sync, FlashAttention-2 register
// layout); float32 inputs take a float-FMA kernel (exact float32, held to the
// 67 TFLOP/s float rate): each block keeps a 64-row query tile and one 64-row
// key/value tile in shared memory (padded rows, so column reads hit distinct
// banks), and every thread owns a 4x4 score tile and a 4x(D/16) output tile
// in registers. Both stop causal blocks at the diagonal and mask ragged
// sequence lengths at the edge, so any S runs (the TPU's multiple-of-128 gate
// does not carry over). wgmma + TMA are the later step.
#include "common.cuh"

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


// ---------------------------------------------------------------- bf16 path
// The bf16 forward runs its two products on the tensor cores with
// mma.sync.m16n8k16 (bf16 inputs, float accumulation), in the FlashAttention-2
// register layout: each of the block's four warps owns 16 query rows, keeps
// its q fragments, its 16x64 score tile and its 16xD output accumulator in
// registers, turns the score accumulator straight into the probability
// operand of the second product (P rounded to bf16 there, as the reference
// kernel rounds p to v's type) and rescales its output rows in registers.
// K and V tiles of 64 keys are shared through shared memory (V transposed, so
// every fragment load is one 32-bit word, conflict-free with rows padded by
// 8 elements). Global loads are 16-byte vectors, so the wrapper requires
// 16-byte aligned rows.

constexpr int kMmaBQ = 64;       // query rows per block: 4 warps x 16
constexpr int kMmaBK = 64;       // keys per tile
constexpr int kMmaThreads = 128;
constexpr int kVtPitch = kMmaBK + 8;  // keys per transposed V row (padded)

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q tile, K tile [64][D + 8] and transposed V tile [D][72], all bf16
  return sizeof(__nv_bfloat16) *
         (size_t)(2 * kMmaBQ * (D + 8) + D * kVtPitch);
}

using pt::ld32;
using pt::mma_bf16;
using pt::pack_bf16;

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int Sq, int Sk, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, float scale, int causal) {
  constexpr int LD = D + 8;     // padded row pitch of the Q/K tiles
  constexpr int KK = D / 16;    // k-steps of q . k
  constexpr int NB = kMmaBK / 8;  // 8-key column blocks of the score tile
  constexpr int DB = D / 8;       // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kMmaBQ * LD;
  __nv_bfloat16* Vt = Ks + kMmaBK * LD;  // [D][kVtPitch]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kMmaBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // fragment row group
  const int t = lane & 3;       // thread in group

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  pt::load_rows<D, kMmaBQ, kMmaThreads>(qb, q_ss, q0, Sq, Qs, tid);
  __syncthreads();
  // this warp's q fragments: rows wr + g and wr + g + 8
  const int wr = warp * 16;
  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const __nv_bfloat16* p0 = Qs + (wr + g) * LD + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qf[kk][0] = ld32(p0);
    qf[kk][1] = ld32(p1);
    qf[kk][2] = ld32(p0 + 8);
    qf[kk][3] = ld32(p1 + 8);
  }

  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {pt::kNegInf, pt::kNegInf};
  float l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + wr + g, q0 + wr + g + 8};

  const int q_hi = min(q0 + kMmaBQ, Sq);
  const int k_end = causal ? min(q_hi, Sk) : Sk;
  const int n_tiles = (k_end + kMmaBK - 1) / kMmaBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    pt::load_rows<D, kMmaBK, kMmaThreads>(kb, k_ss, k0, Sk, Ks, tid);
    pt::load_rows_t<D, kMmaBK, kMmaThreads>(vb, v_ss, k0, Sk, Vt, kVtPitch,
                                            tid);
    __syncthreads();

    // S = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const __nv_bfloat16* kp = Ks + (nb * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nb], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }
    // scale, mask, online softmax; rows g (i = 0) and g + 8 (i = 1), each
    // spread over the four threads of a group
    float mx[2] = {pt::kNegInf, pt::kNegInf};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        float x = s[nb][e] * scale;
        if (kpos >= Sk || (causal && kpos > qpos[i])) x = pt::kNegInf;
        s[nb][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(pt::kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(pt::kFullMask, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(pt::kFullMask, rs[i], 1);
      rs[i] += __shfl_xor_sync(pt::kFullMask, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V: the score accumulators of key blocks 2kb and 2kb + 1 are
    // the A operand of k-step kb
#pragma unroll
    for (int kb2 = 0; kb2 < kMmaBK / 16; ++kb2) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kb2][0], s[2 * kb2][1]);
      pa[1] = pack_bf16(s[2 * kb2][2], s[2 * kb2][3]);
      pa[2] = pack_bf16(s[2 * kb2 + 1][0], s[2 * kb2 + 1][1]);
      pa[3] = pack_bf16(s[2 * kb2 + 1][2], s[2 * kb2 + 1][3]);
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        const __nv_bfloat16* vp = Vt + (j * 8 + g) * kVtPitch + kb2 * 16 +
                                  2 * t;
        mma_bf16(o[j], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // out = o / l, lse = m + log(l); rows g and g + 8 of this warp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int sq = qpos[i];
    if (sq >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (((int64_t)b * Sq + sq) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(o[j][2 * i] / lc, o[j][2 * i + 1] / lc);
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) = v2;
    }
    if (t == 0) lse[(int64_t)bh * Sq + sq] = m[i] + logf(lc);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Sq, int Sk,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                        int64_t v_sh, float scale, int causal,
                        cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kMmaBQ - 1) / kMmaBQ);
  using bf = __nv_bfloat16;
  flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<bf*>(out), lse, H, Sq, Sk, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
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
  if (dtype == pt::kBFloat16 && D == 64) return launch_bf16<64>(PT_FLASH_ARGS);
  if (dtype == pt::kBFloat16 && D == 128)
    return launch_bf16<128>(PT_FLASH_ARGS);
#undef PT_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
