// Flash attention: forward, fused backward and split backward (dq; dk/dv),
// hand-written kernels for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes).
//
// Replaces paddle_tpu/ops/pallas_attention.py: _flash_fwd (forward),
// _flash_bwd_fused (single-pass backward) and _flash_bwd's two split kernels
// (_bwd_dq_kernel, _bwd_dkv_kernel).  The TPU kernels run a sequential
// (batch*head, q-block, k-block) grid and carry the online-softmax state, or
// the dq / dk / dv sums, in VMEM scratch from one grid step to the next.
// Blocks of a CUDA grid run in parallel and in no order, so the inner axis
// becomes a loop INSIDE the block:
//
//   forward   grid (q-tiles, batch*head); the block loops over the k-tiles at
//             or below its diagonal with (m, l, acc) in shared memory, and
//             writes o (input dtype) and lse = m + log(l) as [b*h, t_q] f32;
//   backward  grid (k-tiles, batch*head); the block loops over the q-tiles at
//   (fused)   or past its diagonal, keeps dk and dv in f32 in shared memory,
//             recomputes p = exp(s - lse) from the saved lse, computes
//             delta = rowsum(do * o) - dlse itself, and adds its dq
//             contribution with f32 atomics into a zeroed [b, t_q, h, d] f32
//             buffer (the TPU kernel writes per-k-block partials instead: at
//             64-key tiles that buffer would be t_k/64 copies of q);
//   dk/dv     the fused backward's block without the dq product and its
//   (split)   atomics: one shared body (a template flag), so the split route's
//             dk and dv equal the fused route's bit for bit;
//   dq        grid (q-tiles, batch*head), heavy causal tiles first; the block
//   (split)   loads its q, do rows once, computes delta for them, walks the
//             k-tiles up to its diagonal recomputing s, p, dp and ds, keeps dq
//             in f32 in shared memory and writes it once in the input dtype:
//             no atomics and no zeroed f32 buffer, so dq is reproducible bit
//             for bit.
//
// The wrapper picks the fused or the split route by the reference's rule
// (the fused kernel's dq partials would pass 512 MiB: long t), so both
// packages run the same kernel family for the same program.  These kernels
// are the "simple" family: they serve f32 and the strides TMA cannot
// address.  bf16 inputs that TMA can address (d <= 128, 16-byte aligned
// strides and pointers) take the "sm90" family on every route: the forward
// in flash_fwd_sm90.cu, the fused backward and the split pair in
// flash_bwd_sm90.cu (wgmma, a TMA ring, a delta pre-pass).
//
// One interface for both layouts: tensors are addressed as [b, t, h, d] with
// the (batch, time, head) strides passed in, so the packed [b, t, h*d]
// projection output is read in place, with no pack/unpack transpose.
//
// Numerics follow the TPU kernels: scores and softmax state in f32, masked
// scores NEG_INF = -1e30, p cast to the input dtype before p.v and p^T.do, ds
// cast before ds^T.q and ds.k, the l == 0 -> 1 guard, causal rule
// q_pos >= k_pos (positions counted from 0 on both sides, so t_q > t_k is
// allowed).  Ragged t is masked: rows and keys past the end load as zeros,
// never count, and are never stored.  Element offsets are 64-bit.
//
// Matrix products: bf16 inputs go through the tensor cores (WMMA 16x16x16,
// f32 accumulate) with every operand and accumulator tile staged in shared
// memory; f32 inputs use plain f32 FMAs (no TF32), because the f32 contract
// is 2e-4.  Head dims up to 256 are zero-padded to 64, 128 or 256 in shared
// memory.  The reference sizes its blocks by the head width and sets no
// limit (pallas_attention.py _flash_fwd); here the 227 KB a block may take
// decides the tiles at 256: the forward keeps 64 query rows in bf16 and 32
// (two warps) in f32; the backwards take 32-key tiles (the dk and dv f32
// sums of a 64-key tile alone would be 133 KB).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.  At the
// training shape (b=8, h=6, t=4096, d=128, bf16, causal) the forward does
// 4*b*h*t^2*d/2 = 0.21 TFLOP over 0.2 GB, the backward 2.5 times that; at
// t=16384 the split dq kernel does three causal products (4.95 TFLOP) and the
// dk/dv kernel four (6.60 TFLOP).  These kernels are the simple correct
// design (accumulators round-trip through shared memory, one or two blocks of
// 4 to 8 warps an SM with block-wide syncs between the products, no cp.async
// / TMA pipeline, no wgmma), so they sit far below that bound; the sm90
// family is the fast design for the bf16 training paths (about 6x faster
// forward and fused backward, 6-12x the split pair on the H100), and these
// stay for f32 (whose 2e-4 contract rules out bf16 products) and odd
// strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels
constexpr int kBN = 64;            // keys per forward tile
constexpr int kBwdThreads = 256;

struct Geom {
  int B, H, TQ, TK, D;           // D: the real head dim (<= DP)
  long long q_sb, q_st, q_sh;    // element strides of q, o, do, dq
  long long k_sb, k_st, k_sh;    // element strides of k, v, dk, dv
  float scale;
  int causal;
  int vec;                       // 16-byte loads are safe
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copies a [rows, DP] tile into shared memory (row pitch ld).  Row r comes
// from src + r * row_stride; rows >= nvalid and columns >= d load as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, int DP,
                                          const T* src, long long row_stride,
                                          int nvalid, int rows, int d, int vec,
                                          int tid, int nthreads) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vec) {
    const int cpr = DP / V;
    for (int i = tid; i < rows * cpr; i += nthreads) {
      const int r = i / cpr;
      const int c = (i % cpr) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < nvalid && c < d)
        val = *reinterpret_cast<const uint4*>(src + (long long)r * row_stride +
                                              c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = tid; i < rows * DP; i += nthreads) {
      const int r = i / DP;
      const int c = i % DP;
      T val = from_f32<T>(0.f);
      if (r < nvalid && c < d) val = src[(long long)r * row_stride + c];
      dst[r * ld + c] = val;
    }
  }
}

// C[M, N] (+)= op(A)[M, K] . op(B)[K, N], all in shared memory, M and K
// multiples of 16, N a multiple of 16 * NACC.  The output is cut into units
// of one 16-row tile by NACC 16-column tiles, dealt round-robin to the
// block's warps; within a unit the A fragment of each k-step is loaded once
// and serves all NACC accumulators.  Call sites pick NACC so that every warp
// gets one unit; with one column group (N == 16 * NACC) warp w owns rows
// [16 w, 16 w + 16).  ACOL: A(m, k) = A[k * lda + m], else A[m * lda + k];
// BCOL: B(k, n) = B[n * ldb + k], else B[k * ldb + n].  bf16: WMMA on the
// tensor cores; f32: each lane owns a 2x4 patch of a tile, f32 FMAs.
template <typename T, bool ACOL, bool BCOL, bool ACC, int NACC>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const T* A,
                                           int lda, const T* B, int ldb, int M,
                                           int N, int K, int warp, int lane,
                                           int nwarps) {
  const int groups = N / (16 * NACC);
  const int units = (M / 16) * groups;
  for (int u = warp; u < units; u += nwarps) {
    const int m0 = (u / groups) * 16;
    const int nbase = (u % groups) * (16 * NACC);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      using LayA = typename std::conditional<ACOL, wmma::col_major,
                                             wmma::row_major>::type;
      using LayB = typename std::conditional<BCOL, wmma::col_major,
                                             wmma::row_major>::type;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NACC];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        if (ACC)
          wmma::load_matrix_sync(acc[j], C + m0 * ldc + nbase + 16 * j, ldc,
                                 wmma::mem_row_major);
        else
          wmma::fill_fragment(acc[j], 0.0f);
      }
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayA> a;
        wmma::load_matrix_sync(a, ACOL ? A + k0 * lda + m0 : A + m0 * lda + k0,
                               lda);
#pragma unroll
        for (int j = 0; j < NACC; ++j) {
          const int n0 = nbase + 16 * j;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayB> b;
          wmma::load_matrix_sync(
              b, BCOL ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        wmma::store_matrix_sync(C + m0 * ldc + nbase + 16 * j, acc[j], ldc,
                                wmma::mem_row_major);
    } else {
      const int ri = (lane >> 2) * 2;
      const int ci = (lane & 3) * 4;
      for (int t = 0; t < NACC; ++t) {
        const int n0 = nbase + 16 * t;
        float* c = C + m0 * ldc + n0;
        float acc[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = ACC ? c[(ri + i) * ldc + ci + j] : 0.f;
        for (int kk = 0; kk < K; ++kk) {
          float a[2], b[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            a[i] = ACOL ? A[kk * lda + m0 + ri + i]
                        : A[(m0 + ri + i) * lda + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = BCOL ? B[(n0 + ci + j) * ldb + kk]
                        : B[kk * ldb + n0 + ci + j];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[(ri + i) * ldc + ci + j] = acc[i][j];
      }
    }
  }
}

// Shared-memory pitches: operand tiles are padded by 16 bytes (keeps rows
// 16-byte aligned for the vector copies and off one bank), f32 tiles by 4.
template <typename T>
struct Pitch {
  static constexpr int pad = 16 / (int)sizeof(T);
};

// The forward runs one warp per 16 query rows: BM rows, 2 BM threads.
template <int BM>
__host__ __device__ constexpr int fwd_threads() {
  return 2 * BM;
}

template <typename T, int DP, int BM>
constexpr size_t fwd_smem_bytes() {
  constexpr int LD = DP + Pitch<T>::pad, LDP = kBN + Pitch<T>::pad;
  constexpr int LDS = kBN + 4, LDO = DP + 4;
  return sizeof(T) * (size_t)(BM * LD + 2 * kBN * LD + BM * LDP) +
         sizeof(float) * (size_t)(BM * LDS + BM * LDO + 2 * BM);
}

template <typename T, int DP, int BM, int BN>
constexpr size_t bwd_smem_bytes() {
  constexpr int LD = DP + Pitch<T>::pad, LDP = BN + Pitch<T>::pad;
  constexpr int LDS = BN + 4, LDO = DP + 4;
  return sizeof(T) * (size_t)(2 * BN * LD + 2 * BM * LD + 2 * BM * LDP) +
         sizeof(float) * (size_t)(2 * BM * LDS + 2 * BN * LDO + 2 * BM);
}

template <typename T, int DP, int BM, int BN>
constexpr size_t dq_smem_bytes() {
  constexpr int LD = DP + Pitch<T>::pad, LDP = BN + Pitch<T>::pad;
  constexpr int LDS = BN + 4, LDO = DP + 4;
  return sizeof(T) * (size_t)(2 * BM * LD + 2 * BN * LD + BM * LDP) +
         sizeof(float) * (size_t)(2 * BM * LDS + BM * LDO + 2 * BM);
}

template <typename T, int DP, int BM>
__global__ void __launch_bounds__(fwd_threads<BM>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Geom g) {
  constexpr int BN = kBN, NT = fwd_threads<BM>(), NW = NT / 32;
  static_assert(BM == 16 * NW, "one 16-row tile a warp");
  constexpr int LD = DP + Pitch<T>::pad, LDP = BN + Pitch<T>::pad;
  constexpr int LDS = BN + 4, LDO = DP + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);            // [BM, LD]
  T* Ks = Qs + BM * LD;                              // [BN, LD]
  T* Vs = Ks + BN * LD;                              // [BN, LD]
  T* Ps = Vs + BN * LD;                              // [BM, LDP] p, cast
  float* Ss = reinterpret_cast<float*>(Ps + BM * LDP);  // [BM, LDS] scores
  float* Os = Ss + BM * LDS;                         // [BM, LDO] acc
  float* ms = Os + BM * LDO;                         // [BM] running max
  float* ls = ms + BM;                               // [BM] running sum

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the last q-tiles of a causal row walk the most k-tiles: start them first
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * BM;
  const T* qb = q + (long long)b * g.q_sb + (long long)h * g.q_sh;
  const T* kb = k + (long long)b * g.k_sb + (long long)h * g.k_sh;
  const T* vb = v + (long long)b * g.k_sb + (long long)h * g.k_sh;

  load_tile<T>(Qs, LD, DP, qb + (long long)q0 * g.q_st, g.q_st, g.TQ - q0, BM,
               g.D, g.vec, tid, NT);
  for (int i = tid; i < BM * LDO; i += NT) Os[i] = 0.f;
  if (tid < BM) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  int nkt = (g.TK + BN - 1) / BN;
  if (g.causal) nkt = min(nkt, (q0 + BM - 1) / BN + 1);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the last tile's p.v has read Ks, Vs, Ps
    load_tile<T>(Ks, LD, DP, kb + (long long)k0 * g.k_st, g.k_st, g.TK - k0,
                 BN, g.D, g.vec, tid, NT);
    load_tile<T>(Vs, LD, DP, vb + (long long)k0 * g.k_st, g.k_st, g.TK - k0,
                 BN, g.D, g.vec, tid, NT);
    __syncthreads();
    // one unit a warp: warp w computes, rescales and accumulates rows
    // [16 w, 16 w + 16) itself, so warp-level syncs order these steps
    block_gemm<T, false, true, false, BN / 16>(Ss, LDS, Qs, LD, Ks, LD, BM,
                                               BN, DP, warp, lane, NW);
    __syncwarp();
    // online softmax: a lane holds two columns of the row
    for (int rr = 0; rr < BM / NW; ++rr) {
      const int r = warp * (BM / NW) + rr;
      const int qpos = q0 + r;
      float s0 = Ss[r * LDS + lane] * g.scale;
      float s1 = Ss[r * LDS + lane + 32] * g.scale;
      const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
      if (kp0 >= g.TK || (g.causal && kp0 > qpos)) s0 = kNegInf;
      if (kp1 >= g.TK || (g.causal && kp1 > qpos)) s1 = kNegInf;
      const float m_prev = ms[r];
      const float l_prev = ls[r];
      const float m2 = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_prev - m2);
      const float p0 = expf(s0 - m2), p1 = expf(s1 - m2);
      const float psum = warp_sum(p0 + p1);
      Ps[r * LDP + lane] = from_f32<T>(p0);
      Ps[r * LDP + lane + 32] = from_f32<T>(p1);
      __syncwarp();  // every lane has read ms[r], ls[r]
      if (lane == 0) {
        ms[r] = m2;
        ls[r] = l_prev * alpha + psum;
      }
      if (alpha != 1.f)  // the running max moved: rescale the row
        for (int d = lane; d < DP; d += 32) Os[r * LDO + d] *= alpha;
    }
    __syncwarp();
    block_gemm<T, false, false, true, DP / 16>(Os, LDO, Ps, LDP, Vs, LD, BM,
                                               DP, BN, warp, lane, NW);
  }
  __syncwarp();
  T* ob = o + (long long)b * g.q_sb + (long long)h * g.q_sh;
  for (int rr = 0; rr < BM / NW; ++rr) {
    const int r = warp * (BM / NW) + rr;
    const int qpos = q0 + r;
    if (qpos >= g.TQ) continue;
    const float l = ls[r];
    const float l_safe = l == 0.f ? 1.f : l;
    for (int d = lane; d < g.D; d += 32)
      ob[(long long)qpos * g.q_st + d] = from_f32<T>(Os[r * LDO + d] / l_safe);
    if (lane == 0) lse[(long long)bh * g.TQ + qpos] = ms[r] + logf(l_safe);
  }
}

// The k-major backward block: dk and dv of one k-tile, and (DQ) its dq
// share by atomics.  flash_bwd_kernel (fused route) and flash_bwd_dkv_kernel
// (split route) are this body with DQ true and false.
template <typename T, int DP, int BM, int BN, bool DQ>
__device__ __forceinline__ void bwd_kv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dlse,
    float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    const Geom& g, unsigned char* smem_raw) {
  constexpr int NW = kBwdThreads / 32;
  constexpr int LD = DP + Pitch<T>::pad, LDP = BN + Pitch<T>::pad;
  constexpr int LDS = BN + 4, LDO = DP + 4;
  T* Ks = reinterpret_cast<T*>(smem_raw);             // [BN, LD]
  T* Vs = Ks + BN * LD;                               // [BN, LD]
  T* Qs = Vs + BN * LD;                               // [BM, LD]
  T* dOs = Qs + BM * LD;                              // [BM, LD]
  T* Ps = dOs + BM * LD;                              // [BM, LDP] p, cast
  T* dSs = Ps + BM * LDP;                             // [BM, LDP] ds, cast
  float* Ss = reinterpret_cast<float*>(dSs + BM * LDP);  // [BM, LDS]
  float* dPs = Ss + BM * LDS;                         // [BM, LDS]
  float* dKs = dPs + BM * LDS;                        // [BN, LDO]
  float* dVs = dKs + BN * LDO;                        // [BN, LDO]
  float* lse_s = dVs + BN * LDO;                      // [BM]
  float* delta_s = lse_s + BM;                        // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int k0 = kt * BN;
  const long long qoff = (long long)b * g.q_sb + (long long)h * g.q_sh;
  const long long koff = (long long)b * g.k_sb + (long long)h * g.k_sh;

  load_tile<T>(Ks, LD, DP, k + koff + (long long)k0 * g.k_st, g.k_st,
               g.TK - k0, BN, g.D, g.vec, tid, kBwdThreads);
  load_tile<T>(Vs, LD, DP, v + koff + (long long)k0 * g.k_st, g.k_st,
               g.TK - k0, BN, g.D, g.vec, tid, kBwdThreads);
  for (int i = tid; i < 2 * BN * LDO; i += kBwdThreads) dKs[i] = 0.f;

  const int nqt = (g.TQ + BM - 1) / BM;
  // causal: q-tiles wholly above this k-tile's diagonal see none of its keys
  const int jq0 = g.causal ? k0 / BM : 0;
  for (int jq = jq0; jq < nqt; ++jq) {
    const int q0 = jq * BM;
    __syncthreads();  // the last q-tile's products and atomics are done
    load_tile<T>(Qs, LD, DP, q + qoff + (long long)q0 * g.q_st, g.q_st,
                 g.TQ - q0, BM, g.D, g.vec, tid, kBwdThreads);
    load_tile<T>(dOs, LD, DP, dout + qoff + (long long)q0 * g.q_st, g.q_st,
                 g.TQ - q0, BM, g.D, g.vec, tid, kBwdThreads);
    // delta = rowsum(do * o) - dlse, and the saved lse, one warp per row
    for (int r = warp; r < BM; r += NW) {
      const int qpos = q0 + r;
      float part = 0.f;
      if (qpos < g.TQ) {
        const T* dor = dout + qoff + (long long)qpos * g.q_st;
        const T* orow = o + qoff + (long long)qpos * g.q_st;
        for (int d = lane; d < g.D; d += 32)
          part += to_f32(dor[d]) * to_f32(orow[d]);
      }
      part = warp_sum(part);
      if (lane == 0) {
        float ls = 0.f, dl = 0.f;
        if (qpos < g.TQ) {
          ls = lse[(long long)bh * g.TQ + qpos];
          if (dlse != nullptr) dl = dlse[(long long)bh * g.TQ + qpos];
        }
        lse_s[r] = ls;
        delta_s[r] = part - dl;
      }
    }
    __syncthreads();
    block_gemm<T, false, true, false, BM / 32>(Ss, LDS, Qs, LD, Ks, LD, BM,
                                               BN, DP, warp, lane, NW);
    block_gemm<T, false, true, false, BM / 32>(dPs, LDS, dOs, LD, Vs, LD, BM,
                                               BN, DP, warp, lane, NW);
    __syncthreads();
    for (int i = tid; i < BM * BN; i += kBwdThreads) {
      const int r = i / BN, c = i % BN;
      const int qpos = q0 + r, kpos = k0 + c;
      const bool live = qpos < g.TQ && kpos < g.TK &&
                        !(g.causal && kpos > qpos);
      const float p =
          live ? expf(Ss[r * LDS + c] * g.scale - lse_s[r]) : 0.f;
      const float ds = p * (dPs[r * LDS + c] - delta_s[r]) * g.scale;
      Ps[r * LDP + c] = from_f32<T>(p);
      dSs[r * LDP + c] = from_f32<T>(ds);
    }
    __syncthreads();
    // dv += p^T . do ; dk += ds^T . q
    block_gemm<T, true, false, true, DP / 32>(dVs, LDO, Ps, LDP, dOs, LD, BN,
                                              DP, BM, warp, lane, NW);
    block_gemm<T, true, false, true, DP / 32>(dKs, LDO, dSs, LDP, Qs, LD, BN,
                                              DP, BM, warp, lane, NW);
    if constexpr (DQ) {
      // dq tile = ds . k, BN columns at a time into the two free score
      // buffers, a pair of column groups a pass
      for (int c0 = 0; c0 < DP; c0 += 2 * BN) {
        if (c0) __syncthreads();  // the last pass's atomics have read them
        for (int ch = 0; ch < 2 && c0 + ch * BN < DP; ++ch)
          block_gemm<T, false, false, false, BM / 32>(
              ch ? dPs : Ss, LDS, dSs, LDP, Ks + c0 + ch * BN, LD, BM, BN, BN,
              warp, lane, NW);
        __syncthreads();
        const int cols = min(2 * BN, DP - c0);
        for (int i = tid; i < BM * cols; i += kBwdThreads) {
          const int r = i / cols, dd = i % cols, d = c0 + dd;
          const int qpos = q0 + r;
          if (qpos < g.TQ && d < g.D) {
            const float* src = dd >= BN ? dPs : Ss;
            atomicAdd(dq + qoff + (long long)qpos * g.q_st + d,
                      src[r * LDS + dd % BN]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BN * DP; i += kBwdThreads) {
    const int r = i / DP, d = i % DP;
    const int kpos = k0 + r;
    if (kpos < g.TK && d < g.D) {
      const long long at = koff + (long long)kpos * g.k_st + d;
      dk[at] = from_f32<T>(dKs[r * LDO + d]);
      dv[at] = from_f32<T>(dVs[r * LDO + d]);
    }
  }
}

template <typename T, int DP, int BM, int BN>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ dlse, float* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bwd_kv_block<T, DP, BM, BN, true>(q, k, v, o, dout, lse, dlse, dq, dk, dv,
                                    g, smem_raw);
}

template <typename T, int DP, int BM, int BN>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlse, T* __restrict__ dk,
                     T* __restrict__ dv, Geom g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bwd_kv_block<T, DP, BM, BN, false>(q, k, v, o, dout, lse, dlse, nullptr,
                                     dk, dv, g, smem_raw);
}

// Split route, dq: one block owns a BM-row q-tile of one (batch, head) and
// walks the k-tiles up to its diagonal; dq stays in f32 in shared memory and
// is written once.  Heavy (late) causal q-tiles launch first.
template <typename T, int DP, int BM, int BN>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dlse, T* __restrict__ dq,
                    Geom g) {
  constexpr int NW = kBwdThreads / 32;
  constexpr int LD = DP + Pitch<T>::pad, LDP = BN + Pitch<T>::pad;
  constexpr int LDS = BN + 4, LDO = DP + 4;
  // dQ[BM, DP] += dS[BM, BN] . K[BN, DP]: one output unit a warp
  constexpr int NACC_DQ = BM * DP / (256 * NW);
  static_assert(NACC_DQ >= 1 && (BM / 16) * (DP / (16 * NACC_DQ)) == NW,
                "one dq unit a warp");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);             // [BM, LD]
  T* dOs = Qs + BM * LD;                              // [BM, LD]
  T* Ks = dOs + BM * LD;                              // [BN, LD]
  T* Vs = Ks + BN * LD;                               // [BN, LD]
  T* dSs = Vs + BN * LD;                              // [BM, LDP] ds, cast
  float* Ss = reinterpret_cast<float*>(dSs + BM * LDP);  // [BM, LDS]
  float* dPs = Ss + BM * LDS;                         // [BM, LDS]
  float* dQs = dPs + BM * LDS;                        // [BM, LDO]
  float* lse_s = dQs + BM * LDO;                      // [BM]
  float* delta_s = lse_s + BM;                        // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * BM;
  const long long qoff = (long long)b * g.q_sb + (long long)h * g.q_sh;
  const long long koff = (long long)b * g.k_sb + (long long)h * g.k_sh;

  load_tile<T>(Qs, LD, DP, q + qoff + (long long)q0 * g.q_st, g.q_st,
               g.TQ - q0, BM, g.D, g.vec, tid, kBwdThreads);
  load_tile<T>(dOs, LD, DP, dout + qoff + (long long)q0 * g.q_st, g.q_st,
               g.TQ - q0, BM, g.D, g.vec, tid, kBwdThreads);
  for (int i = tid; i < BM * LDO; i += kBwdThreads) dQs[i] = 0.f;
  // delta = rowsum(do * o) - dlse, and the saved lse, one warp per row
  for (int r = warp; r < BM; r += NW) {
    const int qpos = q0 + r;
    float part = 0.f;
    if (qpos < g.TQ) {
      const T* dor = dout + qoff + (long long)qpos * g.q_st;
      const T* orow = o + qoff + (long long)qpos * g.q_st;
      for (int d = lane; d < g.D; d += 32)
        part += to_f32(dor[d]) * to_f32(orow[d]);
    }
    part = warp_sum(part);
    if (lane == 0) {
      float ls = 0.f, dl = 0.f;
      if (qpos < g.TQ) {
        ls = lse[(long long)bh * g.TQ + qpos];
        if (dlse != nullptr) dl = dlse[(long long)bh * g.TQ + qpos];
      }
      lse_s[r] = ls;
      delta_s[r] = part - dl;
    }
  }
  int nkt = (g.TK + BN - 1) / BN;
  // causal: k-tiles wholly past this q-tile's last row see none of it
  if (g.causal) nkt = min(nkt, (q0 + BM - 1) / BN + 1);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the last k-tile's dq product has read Ks, dSs
    load_tile<T>(Ks, LD, DP, k + koff + (long long)k0 * g.k_st, g.k_st,
                 g.TK - k0, BN, g.D, g.vec, tid, kBwdThreads);
    load_tile<T>(Vs, LD, DP, v + koff + (long long)k0 * g.k_st, g.k_st,
                 g.TK - k0, BN, g.D, g.vec, tid, kBwdThreads);
    __syncthreads();
    block_gemm<T, false, true, false, BM / 32>(Ss, LDS, Qs, LD, Ks, LD, BM,
                                               BN, DP, warp, lane, NW);
    block_gemm<T, false, true, false, BM / 32>(dPs, LDS, dOs, LD, Vs, LD, BM,
                                               BN, DP, warp, lane, NW);
    __syncthreads();
    for (int i = tid; i < BM * BN; i += kBwdThreads) {
      const int r = i / BN, c = i % BN;
      const int qpos = q0 + r, kpos = k0 + c;
      const bool live = qpos < g.TQ && kpos < g.TK &&
                        !(g.causal && kpos > qpos);
      const float p =
          live ? expf(Ss[r * LDS + c] * g.scale - lse_s[r]) : 0.f;
      dSs[r * LDP + c] =
          from_f32<T>(p * (dPs[r * LDS + c] - delta_s[r]) * g.scale);
    }
    __syncthreads();
    block_gemm<T, false, false, true, NACC_DQ>(dQs, LDO, dSs, LDP, Ks, LD, BM,
                                               DP, BN, warp, lane, NW);
  }
  __syncthreads();
  T* dqb = dq + qoff;
  for (int i = tid; i < BM * DP; i += kBwdThreads) {
    const int r = i / DP, d = i % DP;
    const int qpos = q0 + r;
    if (qpos < g.TQ && d < g.D)
      dqb[(long long)qpos * g.q_st + d] = from_f32<T>(dQs[r * LDO + d]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int vec_ok(const Geom& g) {
  const int V = 16 / (int)sizeof(T);
  return g.D % V == 0 && g.q_sb % V == 0 && g.q_st % V == 0 &&
         g.q_sh % V == 0 && g.k_sb % V == 0 && g.k_st % V == 0 &&
         g.k_sh % V == 0;
}

template <typename T, int DP, int BM>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               Geom g, cudaStream_t st) {
  g.vec = vec_ok<T>(g) && aligned16(q) && aligned16(k) && aligned16(v);
  constexpr size_t smem = fwd_smem_bytes<T, DP, BM>();
  static_assert(smem <= 232448, "forward shared memory");
  auto kern = flash_fwd_kernel<T, DP, BM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((g.TQ + BM - 1) / BM), (unsigned)(g.B * g.H));
  kern<<<grid, fwd_threads<BM>(), smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      g);
  return (int)cudaGetLastError();
}

// The three backward kernels: the fused one (dq by atomics, dk, dv), the
// split route's dk/dv one and its dq one.
enum BwdKind { kFused = 0, kDkv = 1, kDq = 2 };

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP, int BM, int BN, int KIND>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* dlse, void* dq,
               void* dk, void* dv, Geom g, cudaStream_t st) {
  g.vec = vec_ok<T>(g) && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(dout);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* dlse_ = static_cast<const float*>(dlse);
  const unsigned bh = (unsigned)(g.B * g.H);
  const dim3 kgrid((unsigned)((g.TK + BN - 1) / BN), bh);
  static_assert(bwd_smem_bytes<T, DP, BM, BN>() <= 232448 &&
                    dq_smem_bytes<T, DP, BM, BN>() <= 232448,
                "backward shared memory");
  cudaError_t e;
  if constexpr (KIND == kFused) {
    const size_t smem = bwd_smem_bytes<T, DP, BM, BN>();
    auto kern = flash_bwd_kernel<T, DP, BM, BN>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<kgrid, kBwdThreads, smem, st>>>(
        q_, k_, v_, o_, do_, lse_, dlse_, static_cast<float*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), g);
  } else if constexpr (KIND == kDkv) {
    const size_t smem = bwd_smem_bytes<T, DP, BM, BN>();
    auto kern = flash_bwd_dkv_kernel<T, DP, BM, BN>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<kgrid, kBwdThreads, smem, st>>>(q_, k_, v_, o_, do_, lse_, dlse_,
                                           static_cast<T*>(dk),
                                           static_cast<T*>(dv), g);
  } else {
    const size_t smem = dq_smem_bytes<T, DP, BM, BN>();
    auto kern = flash_bwd_dq_kernel<T, DP, BM, BN>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return (int)e;
    const dim3 qgrid((unsigned)((g.TQ + BM - 1) / BM), bh);
    kern<<<qgrid, kBwdThreads, smem, st>>>(q_, k_, v_, o_, do_, lse_, dlse_,
                                           static_cast<T*>(dq), g);
  }
  return (int)cudaGetLastError();
}

bool geom_ok(const Geom& g) {
  return g.B >= 1 && g.H >= 1 && g.TQ >= 1 && g.TK >= 1 && g.D >= 1 &&
         g.D <= 256 && (long long)g.B * g.H <= 65535;
}

}  // namespace

// Every entry point launches on `stream`, allocates nothing and returns the
// cudaError_t of the launch (0 on success).  dtype: 0 = float32,
// 1 = bfloat16.  Strides are in elements; the last (head-dim) stride is 1.
// The wrapper (paddle_tpu_torch/kernels/flash_attention.py) checks shapes,
// dtypes and contiguity, and allocates o, lse, dq (the fused route's zeroed
// f32 one), dk and dv.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int TQ,
                                   int TK, int D, long long q_sb,
                                   long long q_st, long long q_sh,
                                   long long k_sb, long long k_st,
                                   long long k_sh, float scale, int causal,
                                   int dtype, void* stream) {
  Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale, causal, 0};
  if (!geom_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 64) return launch_fwd<float, 64, 64>(q, k, v, o, lse, g, st);
    if (D <= 128) return launch_fwd<float, 128, 64>(q, k, v, o, lse, g, st);
    return launch_fwd<float, 256, 32>(q, k, v, o, lse, g, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (D <= 64) return launch_fwd<bf, 64, 64>(q, k, v, o, lse, g, st);
    if (D <= 128) return launch_fwd<bf, 128, 64>(q, k, v, o, lse, g, st);
    return launch_fwd<bf, 256, 64>(q, k, v, o, lse, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int KIND>
int bwd_entry(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* dlse, void* dq,
              void* dk, void* dv, const Geom& g, int dtype, void* stream) {
  if (!geom_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (g.D <= 64)
      return launch_bwd<float, 64, 32, 64, KIND>(q, k, v, o, dout, lse, dlse,
                                                 dq, dk, dv, g, st);
    if (g.D <= 128)
      return launch_bwd<float, 128, 32, 64, KIND>(q, k, v, o, dout, lse, dlse,
                                                  dq, dk, dv, g, st);
    return launch_bwd<float, 256, 32, 32, KIND>(q, k, v, o, dout, lse, dlse,
                                                dq, dk, dv, g, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (g.D <= 64)
      return launch_bwd<bf, 64, 64, 64, KIND>(q, k, v, o, dout, lse, dlse, dq,
                                              dk, dv, g, st);
    if (g.D <= 128)
      return launch_bwd<bf, 128, 64, 64, KIND>(q, k, v, o, dout, lse, dlse,
                                               dq, dk, dv, g, st);
    return launch_bwd<bf, 256, 64, 32, KIND>(q, k, v, o, dout, lse, dlse, dq,
                                             dk, dv, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dlse may be null (no cotangent on lse).  dq must arrive zeroed: every
// k-tile's block adds its share with atomics.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, const void* dlse, void* dq,
                                   void* dk, void* dv, int B, int H, int TQ,
                                   int TK, int D, long long q_sb,
                                   long long q_st, long long q_sh,
                                   long long k_sb, long long k_st,
                                   long long k_sh, float scale, int causal,
                                   int dtype, void* stream) {
  Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale, causal, 0};
  return bwd_entry<kFused>(q, k, v, o, dout, lse, dlse, dq, dk, dv, g, dtype,
                           stream);
}

// Split route, dq in the input dtype (written once, no zeroing needed).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, void* dq, int B,
    int H, int TQ, int TK, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    float scale, int causal, int dtype, void* stream) {
  Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale, causal, 0};
  return bwd_entry<kDq>(q, k, v, o, dout, lse, dlse, dq, nullptr, nullptr, g,
                        dtype, stream);
}

// Split route, dk and dv.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, void* dk, void* dv,
    int B, int H, int TQ, int TK, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    float scale, int causal, int dtype, void* stream) {
  Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale, causal, 0};
  return bwd_entry<kDkv>(q, k, v, o, dout, lse, dlse, nullptr, dk, dv, g,
                         dtype, stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
