// The flash-attention forward for Hopper (sm_90a), hand-written CUDA C++
// bound to PyTorch through a plain C interface (ctypes), as the other
// sources here; the primitives (TMA, mbarriers, wgmma, descriptors, tensor
// maps) are sm90.cuh's.
//
// Replaces paddle_tpu/ops/pallas_attention.py: _flash_fwd (:363), the
// online-softmax forward that writes o and lse.  The wrapper
// (paddle_tpu_torch/kernels/flash_attention.py) takes this kernel for the
// inputs the sm90 rule admits (bf16, d <= 128, every stride and base
// pointer 16-byte aligned: what TMA can address); f32 and odd strides keep
// flash_attention.cu's flash_fwd_kernel.  The rule is static and counted.
//
//   grid      (q-tiles of 128 rows, b*h), the heaviest causal tiles first.
//   block     one producer warp (setmaxnreg 24) and two consumer
//             warpgroups (setmaxnreg 240) of 64 query rows each.  Q (128
//             rows) is loaded once by TMA and stays resident; K and V tiles
//             of 128 keys stream through a kFwdStages-deep ring that the
//             producer fills with TMA (completion on mbarriers).
//   per tile  S = Q.K^T by wgmma (A and B in shared memory, f32 sums in
//             registers); an online softmax in registers, in the exp2
//             domain (scores scaled by scale * log2(e)): the row max over
//             the four lanes of a quad that share an accumulator row
//             (shfl_xor 1, 2), the O accumulator (DP / 2 registers a
//             thread) rescaled only when the running max moved, the row
//             sum kept per thread and reduced over the quad once at the
//             end; p rounded to bf16 straight into the register A fragment;
//             O += P.V by wgmma with V read MN-major (the transpose bit).
//             Only tiles that cross the diagonal or the ragged key edge are
//             masked.  128-key tiles beat 64-key ones, and issuing the next
//             tile's S product before this tile's softmax lost 15-43% (a
//             second score tile in registers, a wait for both products,
//             spills at 128 keys), so the kernel does neither.
//   epilogue  o = O / l (the l == 0 -> 1 guard) in bf16; lse in natural log,
//             lse = m2 * ln(2) + log(l) with m2 the exp2-domain row max, as
//             [b*h, t_q] f32: the backward reads it and multiplies by
//             log2(e).
//
// Numerics are the TPU kernel's: scores and softmax state in f32, p cast to
// bf16 before p.v, masked scores excluded, causal rule q_pos >= k_pos with
// positions from 0 on both sides (t_q > t_k works).  Rows and keys past the
// end load as TMA's zero fill; such keys are masked, such rows never stored.
// The head dim is padded to 64 or 128 by the box's zero fill (d=16 works).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.  At b=8,
// h=6, d=128, bf16, causal the forward does 4 d flops a causal score entry:
// 0.206 TFLOP at t=4096 (0.2085 ms) and 3.30 TFLOP at t=16384 (3.336 ms).
// What the design does about it: both products run on wgmma with register
// accumulators, the next tile's loads are in flight while one is
// multiplied, p never leaves registers, and shared memory holds only Q and
// the ring (one block of 384 threads an SM).

#include <math.h>  // INFINITY

#include "sm90.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kFwdKT = 128;    // keys of a streamed K / V tile
constexpr int kFwdStages = 3;  // the ring's depth

template <int DP, int KT>
constexpr size_t fwd_smem_bytes() {
  return 1024 + (size_t)(DP / 64) * kBlockRows * 128 +
         (size_t)kFwdStages * 2 * (DP / 64) * KT * 128 +
         (2 * kFwdStages + 1) * sizeof(uint64_t);
}

// One tile's online-softmax step for a thread's two rows (ra, rb): the
// scores S (KT / 2 registers, scaled here) become p, the running max m and
// per-thread partial sum l move, O is rescaled when the max moved, and p is
// packed to bf16 A fragments.  g by value, as in flash_bwd_sm90.cu's body:
// the masking loop then keeps the lengths and the causal flag in registers.
template <int DP, int KT>
__device__ __forceinline__ void softmax_step(
    float (&S)[KT / 2], float (&O)[DP / 2], uint32_t (&P)[KT / 16][4],
    float& m_a, float& m_b, float& l_a, float& l_b, int k0, int ra, int rb,
    int gc, bool mask, const Geom g, float sl2) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    float x = S[i] * sl2;
    if (mask) {
      const int row = (i & 2) ? rb : ra;
      const int col = k0 + 8 * (i >> 2) + 2 * gc + (i & 1);
      if (col >= g.TK || (g.causal && col > row)) x = -INFINITY;
    }
    S[i] = x;
    if (i & 2)
      mx_b = fmaxf(mx_b, x);
    else
      mx_a = fmaxf(mx_a, x);
  }
  // the four lanes of a quad hold one accumulator row between them
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  // a row with no live key yet keeps exp2 away from -inf - -inf
  const float ms_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float ms_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float al_a = exp2f(m_a - ms_a), al_b = exp2f(m_b - ms_b);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const float p = exp2f(S[i] - ((i & 2) ? ms_b : ms_a));
    S[i] = p;
    if (i & 2)
      ps_b += p;
    else
      ps_a += p;
  }
  l_a = l_a * al_a + ps_a;
  l_b = l_b * al_b + ps_b;
  if (al_a != 1.f || al_b != 1.f) {  // the running max moved: rescale
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      O[4 * j] *= al_a;
      O[4 * j + 1] *= al_a;
      O[4 * j + 2] *= al_b;
      O[4 * j + 3] *= al_b;
    }
  }
  to_frags(S, P);
}

template <int DP, int KT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      Geom g) {
  constexpr int NH = DP / 64;
  constexpr int RES = NH * kBlockRows * 128;  // bytes of the Q tile
  constexpr int STG = NH * KT * 128;          // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = aligned_smem(smem_raw);   // [NH][kBlockRows][64]
  unsigned char* ring = Qs + RES;               // kFwdStages x {K, V}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFwdStages * 2 * STG);
  uint64_t* empty = full + kFwdStages;
  uint64_t* res = empty + kFwdStages;

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * kBlockRows;
  int nkt = (g.TK + KT - 1) / KT;
  // causal: k-tiles wholly past the block's last row see none of it
  if (g.causal) nkt = min(nkt, (min(q0 + kBlockRows, g.TQ) - 1) / KT + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(res, RES);
      for (int hf = 0; hf < NH; ++hf)
        tma_load(Qs + hf * kBlockRows * 128, &tm_q, res, 64 * hf, h, q0, b);
      for (int it = 0; it < nkt; ++it) {
        const int s = it % kFwdStages;
        mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * STG);
        unsigned char* Kt = ring + s * 2 * STG;
        for (int hf = 0; hf < NH; ++hf) {
          tma_load(Kt + hf * KT * 128, &tm_k, &full[s], 64 * hf, h, it * KT,
                   b);
          tma_load(Kt + STG + hf * KT * 128, &tm_v, &full[s], 64 * hf, h,
                   it * KT, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    const int r0 = q0 + wg * kRows;                 // this warpgroup's rows
    const int ra = r0 + warp * 16 + gr, rb = ra + 8;  // this thread's rows
    const int last_row = min(r0 + kRows, g.TQ) - 1;
    // the k-tiles this warpgroup computes: none past its last causal row
    int mine = r0 < g.TQ ? nkt : 0;
    if (g.causal) mine = min(mine, last_row / KT + 1);
    const float sl2 = g.scale * kLog2e;
    float O[DP / 2], S[KT / 2];
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) O[i] = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) S[i] = 0.f;
    const uint32_t qa = smem_u32(Qs) + wg * kRows * 128;
    const uint32_t ring_a = smem_u32(ring);
    mbar_wait(res, 0);
    for (int it = 0; it < nkt; ++it) {
      const int s = it % kFwdStages;
      mbar_wait(&full[s], (it / kFwdStages) & 1);
      if (it < mine) {
        const int k0 = it * KT;
        const uint32_t ks = ring_a + s * 2 * STG, vs = ks + STG;
        wgmma_fence();
        gemm_abt<DP, KT>(S, qa, kBlockRows, ks, KT);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(S);
        // only tiles that cross the diagonal or the ragged key edge mask
        const bool mask = (g.causal && k0 + KT - 1 > r0) || k0 + KT > g.TK;
        uint32_t P[KT / 16][4];
        softmax_step<DP, KT>(S, O, P, m_a, m_b, l_a, l_b, k0, ra, rb, gc,
                             mask, g, sl2);
        wgmma_fence();
        gemm_rs<DP, KT>(O, P, vs);  // O += P . V
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(O);
      }
      mbar_arrive(&empty[s]);
    }
    // the row sums: each lane of a quad holds a quarter of its row's
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float ls_a = l_a == 0.f ? 1.f : l_a;
    const float ls_b = l_b == 0.f ? 1.f : l_b;
    __nv_bfloat16* out = o + (long long)b * g.q_sb + (long long)h * g.q_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * gc;
      if (col < g.D) {
        if (ra < g.TQ)
          *reinterpret_cast<uint32_t*>(out + (long long)ra * g.q_st + col) =
              pack_bf16(O[4 * j] / ls_a, O[4 * j + 1] / ls_a);
        if (rb < g.TQ)
          *reinterpret_cast<uint32_t*>(out + (long long)rb * g.q_st + col) =
              pack_bf16(O[4 * j + 2] / ls_b, O[4 * j + 3] / ls_b);
      }
    }
    if (gc == 0) {
      const long long rowbase = (long long)bh * g.TQ;
      if (ra < g.TQ) lse[rowbase + ra] = m_a * kLn2 + logf(ls_a);
      if (rb < g.TQ) lse[rowbase + rb] = m_b * kLn2 + logf(ls_b);
    }
  }
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const Geom& g, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_map(&mq, q, g, g.TQ, g.q_sb, g.q_st, g.q_sh, kBlockRows)) ||
      (e = make_map(&mk, k, g, g.TK, g.k_sb, g.k_st, g.k_sh, kFwdKT)) ||
      (e = make_map(&mv, v, g, g.TK, g.k_sb, g.k_st, g.k_sh, kFwdKT)))
    return (int)e;
  const size_t smem = fwd_smem_bytes<DP, kFwdKT>();
  auto kern = flash_fwd_sm90_kernel<DP, kFwdKT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((g.TQ + kBlockRows - 1) / kBlockRows),
                  (unsigned)(g.B * g.H));
  kern<<<grid, kThreads, smem, st>>>(mq, mk, mv,
                                     static_cast<__nv_bfloat16*>(o), lse, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing and returns the cudaError_t of the
// launch (0 on success).  dtype 1 (bfloat16) only; strides in elements, the
// head-dim stride 1.  The wrapper (paddle_tpu_torch/kernels/
// flash_attention.py) checks shapes, dtypes and contiguity, applies the
// dispatch rule and allocates o (q's shape and strides) and lse [B*H, TQ].
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int TQ,
                              int TK, int D, long long q_sb, long long q_st,
                              long long q_sh, long long k_sb, long long k_st,
                              long long k_sh, float scale, int causal,
                              int dtype, void* stream) {
  const Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale,
               causal};
  const void* ptrs[4] = {q, k, v, o};
  if (dtype != 1 || !sm90_ok(g, ptrs, 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D <= 64) return launch_fwd<64>(q, k, v, o, l, g, st);
  return launch_fwd<128>(q, k, v, o, l, g, st);
}
