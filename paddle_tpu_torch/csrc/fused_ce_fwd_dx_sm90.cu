// The forward and the input gradient (dx) of the fused softmax-cross-entropy
// head for Hopper (sm_90a), hand-written CUDA C++ bound to PyTorch through a
// plain C interface (ctypes), as the other sources here; the primitives
// (TMA, mbarriers, wgmma, descriptors, tensor maps) are sm90.cuh's.
//
// Replaces paddle_tpu/ops/pallas_ce.py: the forward pallas_call of _ce_fwd
// (:153, _ce_fwd_kernel) and the dx pallas_call of _ce_bwd (:198,
// _ce_dx_kernel):
//
//   forward  lse = m + log(l) over the vocabulary (online max and sum),
//            loss = lse - s[y], s = x.w; an out-of-range label (-1 or >= V)
//            picks nothing (loss = lse); [N] f32 outputs only;
//   dx       dx = ds . w^T, ds = bf16((exp(s - lse) - onehot(y)) * g),
//            accumulated in f32 over the whole vocabulary and written once
//            in bf16; no atomics, so dx is the same bits from run to run.
//
// No [N, V] tensor reaches device memory.  The wrapper (paddle_tpu_torch/
// kernels/fused_ce.py) takes these kernels for the inputs its static rule
// admits (bf16, d <= 768, d and V multiples of 8, 16-byte aligned pointers:
// what TMA addresses); everything else keeps fused_ce.cu's ce_fwd_kernel
// and ce_dx_kernel.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations, 2 N d V flops
// a product; at N = 32768, d = 768, V = 32768 the forward (one product)
// 1.668 ms, dx (two) 3.335 ms.  What holds the simple family (fused_ce.cu)
// back: WMMA 16x16x16 with every score tile staged through f32 shared
// memory, cp.async with no second buffer, and (dx) 32 rows a block, so w is
// read 1,024 times.
//
//   forward  grid over 128-row blocks in clusters of two; one producer
//            warp (setmaxnreg 24) and two consumer warpgroups (setmaxnreg
//            240) of 64 rows.  A GEMM mainloop: the block's x chunk [128
//            rows, 64 d] and w chunk [64 d, 128 vocab] (16 KB each) stream
//            together through a 6-stage TMA ring; the two blocks of a
//            cluster walk the same w chunks, and each loads one half of
//            every chunk and multicasts it into both.  Measured on the H100
//            (benchmarks/kernel_variants.py): without the multicast, a
//            shallower ring or x resident ([128, 768], 192 KB: only w
//            re-read, but room for a 2-stage ring alone), all slower.  Per
//            128-column vocab tile the score
//            S [64, 128] f32 accumulates in registers over the d chunks by
//            wgmma (A = x K-major, B = the w chunk MN-major: vocab is w's
//            contiguous axis); then an online softmax in the exp2 domain, as
//            flash_fwd_sm90.cu's: the row max over the quad (shfl_xor 1, 2),
//            the per-thread sum reduced once at the end, the picked logit
//            where col == y.  Columns past V (TMA's zero fill scores them 0)
//            are masked out of the last tile's max and sum.
//            lse = m2 ln 2 + log(l), in natural log as the backward reads it.
//   dx       grid over 64-row blocks; the same producer and consumers.  The
//            [64, d] f32 accumulator is too large for one warpgroup's
//            registers at d = 768 (384 a thread), so d is split inside the
//            block: warpgroup h owns dx's d-half [64, DP/2] (192 registers a
//            thread at d = 768).  x's rows stay resident ([64, 768], 96 KB);
//            w streams in [DP, 32 vocab] tiles (48 KB) through a 2-stage
//            TMA ring in the 64-byte swizzle (32-column rows).  Per tile,
//            each warpgroup computes its partial score over its d-half by
//            wgmma (A = x K-major, B = w MN-major), writes it to its
//            exchange slot in shared memory, passes one named barrier and
//            adds the other half's partial (IEEE addition commutes: both
//            warpgroups hold the same bits); forms ds in registers, rounds
//            it to bf16 straight into the register A fragment, and adds
//            ds . w_half^T by wgmma (B = the same w tile read K-major: vocab
//            is the reduction) in 192-wide pieces.  The exchange slots are
//            double-buffered, so one barrier a tile orders both the write
//            and the reuse.  Nothing leaves the SM: no cluster launch and no
//            distributed-shared-memory round trip (the dW kernel's cost,
//            fused_ce_sm90.cu).  w is read from L2 N / 64 times.
//
// Shared memory (bytes, d = 768): forward 6 x 32,768 ring; dx 98,304 x +
// 2 x 49,152 ring + 32,768 exchange; each with 1,024 of alignment and the
// barriers, under the 232,448 a block may have.  dx with its w tiles
// multicast over clusters of two (kDxMc = 2) measured no faster: it reads
// only w from L2, where the forward reads x too.
//
// Ragged edges come from TMA's zero fill: rows past N have x = 0 (dx also
// g = 0) and are never stored; d past D has x = w = 0; vocab columns past V
// are masked in the forward and meet w = 0 in dx's second product.

#include <math.h>  // INFINITY

#include "sm90.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxD = 768;
// MC below: the blocks of a cluster (consecutive row blocks) that share
// each w load by TMA multicast; 1: no cluster.

// Every thread of the block, or of the cluster with multicast (whose
// producers write into each other's stages and barriers).
template <int MC>
__device__ __forceinline__ void sync_blocks() {
  if constexpr (MC > 1)
    cluster_sync();
  else
    __syncthreads();
}

// One consumer warp's release of a stage, after its products have read it:
// an arrival on the stage's empty barrier in every block whose producer
// writes into it (this one, and with multicast the cluster's others).
template <int MC>
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) {
    if constexpr (MC == 1)
      mbar_arrive(bar);
    else
      for (int q = 0; q < MC; ++q) mbar_arrive_remote(mapa(smem_u32(bar), q));
  }
}

// Box `box` of a streamed w stage: loaded for this block, or with
// multicast by one block of the cluster for all of them.
template <int MC>
__device__ __forceinline__ void load_w(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int box) {
  if constexpr (MC == 1)
    tma_load_2d(dst, map, bar, c0, c1);
  else if (box % MC == (int)cluster_rank())
    tma_load_2d_mc(dst, map, bar, c0, c1, (uint16_t)((1u << MC) - 1));
}

// No block of a cluster leaves while another may still arrive on its
// barriers.
template <int MC>
__device__ __forceinline__ void leave() {
  if constexpr (MC > 1) {
    __syncwarp();
    cluster_sync();
  }
}

constexpr int kWarpsC = kConsumers * 4;  // consumer warps a block

// -- the forward -------------------------------------------------------------

constexpr bool kStreamX = true;  // x streamed beside w (false: resident)
constexpr int kFwdBV = 128;      // vocab columns of a tile
constexpr int kFwdMc = 2;        // row blocks sharing each w chunk
constexpr int kFwdStages = kStreamX ? 6 : 2;  // chunks in flight
constexpr int kFwdWBytes = 64 * kFwdBV * 2;   // a w chunk: 2 boxes [64, 64]
constexpr int kFwdXChunk = kBlockRows * 128;  // an x chunk: [128 rows, 64 d]
constexpr int kFwdXBytes = kStreamX ? 0 : (kMaxD / 64) * kFwdXChunk;
constexpr int kFwdStageBytes = kFwdWBytes + (kStreamX ? kFwdXChunk : 0);

constexpr size_t fwd_smem_bytes() {
  return 1024 + (size_t)kFwdXBytes + (size_t)kFwdStages * kFwdStageBytes +
         (2 * kFwdStages + 1) * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kThreads, 1)
ce_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const int* __restrict__ y, float* __restrict__ loss,
                   float* __restrict__ lse, int N, int D, int V) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xs = aligned_smem(smem_raw);  // [D / 64][kBlockRows][64]
  unsigned char* ring = Xs + kFwdXBytes;       // kFwdStages x {w, (x)}
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kFwdStages * kFwdStageBytes);
  uint64_t* empty = full + kFwdStages;
  uint64_t* res = empty + kFwdStages;

  const int r0 = blockIdx.x * kBlockRows;
  const int nch = (D + 63) / 64;            // d chunks of 64
  const int nvt = (V + kFwdBV - 1) / kFwdBV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpsC * kFwdMc);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_blocks<kFwdMc>();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      if (!kStreamX) {
        mbar_expect_tx(res, nch * kFwdXChunk);
        for (int c = 0; c < nch; ++c)
          tma_load_2d(Xs + c * kFwdXChunk, &tm_x, res, 64 * c, r0);
      }
      int it = 0;
      for (int vt = 0; vt < nvt; ++vt)
        for (int c = 0; c < nch; ++c, ++it) {
          const int s = it % kFwdStages;
          mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kFwdStageBytes);
          unsigned char* st = ring + s * kFwdStageBytes;
          load_w<kFwdMc>(st, &tm_w, &full[s], vt * kFwdBV, 64 * c, 0);
          load_w<kFwdMc>(st + kFwdWBytes / 2, &tm_w, &full[s],
                         vt * kFwdBV + 64, 64 * c, 1);
          if (kStreamX)
            tma_load_2d(st + kFwdWBytes, &tm_x, &full[s], 64 * c, r0);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    const int ra = r0 + wg * kRows + warp * 16 + gr, rb = ra + 8;
    // the labels, an out-of-range one as -1: it picks no column
    int ya = ra < N ? y[ra] : -1, yb = rb < N ? y[rb] : -1;
    if (ya < 0 || ya >= V) ya = -1;
    if (yb < 0 || yb >= V) yb = -1;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    float pk_a = 0.f, pk_b = 0.f;
    float S[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) S[i] = 0.f;
    const uint32_t xa = smem_u32(Xs) + wg * kRows * 128;
    const uint32_t ring_a = smem_u32(ring);
    if (!kStreamX) mbar_wait(res, 0);
    int it = 0;
    for (int vt = 0; vt < nvt; ++vt) {
      const int v0 = vt * kFwdBV;
      // S = x . w_tile over the d chunks
      for (int c = 0; c < nch; ++c, ++it) {
        const int s = it % kFwdStages;
        mbar_wait(&full[s], (it / kFwdStages) & 1);
        const uint32_t st = ring_a + s * kFwdStageBytes;
        const uint32_t a = kStreamX ? st + kFwdWBytes + wg * kRows * 128
                                    : xa + c * kFwdXChunk;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128_tb(S, desc_k(a + kk * 32),
                           desc_mn(st + kk * 2048, kFwdWBytes / 2),
                           c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(S);
        release<kFwdMc>(&empty[s], lane);
      }
      // the online softmax: S[4 j + e] is row (e & 2 ? rb : ra), column
      // v0 + 8 j + 2 gc + (e & 1)
      const bool mask = v0 + kFwdBV > V;
      const bool in_a = (unsigned)(ya - v0) < (unsigned)kFwdBV;
      const bool in_b = (unsigned)(yb - v0) < (unsigned)kFwdBV;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = v0 + 8 * (i >> 2) + 2 * gc + (i & 1);
        if (i & 2) {
          if (in_b && col == yb) pk_b += S[i];
        } else {
          if (in_a && col == ya) pk_a += S[i];
        }
        float x2 = S[i] * kLog2e;
        if (mask && col >= V) x2 = -INFINITY;
        S[i] = x2;
        if (i & 2)
          mx_b = fmaxf(mx_b, x2);
        else
          mx_a = fmaxf(mx_a, x2);
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // every tile holds a live column (v0 < V), so the new max is finite
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2)
          ps_b += exp2f(S[i] - mn_b);
        else
          ps_a += exp2f(S[i] - mn_a);
      }
      l_a = l_a * exp2f(m_a - mn_a) + ps_a;
      l_b = l_b * exp2f(m_b - mn_b) + ps_b;
      m_a = mn_a;
      m_b = mn_b;
    }
    // each lane of a quad holds a quarter of its rows' sums and picks
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
      pk_a += __shfl_xor_sync(0xffffffffu, pk_a, o);
      pk_b += __shfl_xor_sync(0xffffffffu, pk_b, o);
    }
    if (gc == 0) {
      if (ra < N) {
        const float L = m_a * kLn2 + logf(l_a);
        lse[ra] = L;
        loss[ra] = L - pk_a;
      }
      if (rb < N) {
        const float L = m_b * kLn2 + logf(l_b);
        lse[rb] = L;
        loss[rb] = L - pk_b;
      }
    }
  }
  leave<kFwdMc>();
}

// -- dx ----------------------------------------------------------------------

constexpr int kDxBM = 64;      // rows of a block
constexpr int kDxBV = 32;      // vocab columns of a streamed w tile
constexpr int kDxStages = 2;   // w tiles in flight
constexpr int kXchSlots = 2;   // exchange slots a warpgroup (1: one stage)
constexpr int kDxMc = 1;       // row blocks sharing each w tile
constexpr int kPartBytes = kDxBM * kDxBV * 4;  // a warpgroup's partial scores
static_assert(kXchSlots == 2 || kDxStages == 1,
              "one slot is reused safely only behind a one-stage ring");

// The w tile's descriptors: rows of kDxBV columns, read MN-major (vocab
// contiguous) by the score product and K-major by the dx product.
__device__ __forceinline__ uint64_t w_desc_mn(uint32_t addr) {
  if constexpr (kDxBV == 64)
    return desc_mn(addr, 0);  // one 64-column group: no lbo read
  else
    return desc_mn64(addr, 0);
}
__device__ __forceinline__ uint64_t w_desc_k(uint32_t addr) {
  if constexpr (kDxBV == 64)
    return desc_k(addr);
  else
    return desc_k64(addr);
}
// S[64 x BV] = x_half . w_tile over a warpgroup's NCH 64-column chunks of
// d (x at `xa` K-major, the tile's rows at `wt` read MN-major); issued, not
// committed
template <int NCH, int BV>
__device__ __forceinline__ void score_mma(float (&S)[BV / 2], uint32_t xa,
                                          uint32_t wt) {
#pragma unroll
  for (int kk = 0; kk < NCH * 4; ++kk) {
    const uint64_t da = desc_k(xa + (kk >> 2) * kDxBM * 128 + (kk & 3) * 32);
    const uint64_t db = w_desc_mn(wt + kk * 16 * BV * 2);
    if constexpr (BV == 64)
      wgmma_ss_n64_tb(S, da, db, kk > 0);
    else
      wgmma_ss_n32_tb(S, da, db, kk > 0);
  }
}

// NCH: the 64-column chunks of d a consumer warpgroup owns (DP = 128 NCH)
template <int NCH>
constexpr size_t dx_smem_bytes() {
  return 1024 + (size_t)2 * NCH * kDxBM * 128 +
         (size_t)kDxStages * 2 * NCH * 64 * kDxBV * 2 +
         (size_t)kXchSlots * kConsumers * kPartBytes +
         (2 * kDxStages + 1) * sizeof(uint64_t);
}

template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
ce_dx_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const int* __restrict__ y, const float* __restrict__ lse,
                  const float* __restrict__ g, __nv_bfloat16* __restrict__ dx,
                  int N, int D, int V) {
  constexpr int DP = 2 * NCH * 64;            // d, padded
  constexpr int XBYTES = DP / 64 * kDxBM * 128;
  constexpr int WBYTES = DP * kDxBV * 2;      // DP rows of 64 bytes
  constexpr int HALF = NCH * 64;              // d a warpgroup owns
  // the second product in pieces of PN columns (wgmma's N <= 256)
  constexpr int PN = NCH % 3 == 0 ? 192 : HALF;
  constexpr int NP = HALF / PN;
  static_assert(PN == 64 || PN == 128 || PN == 192, "dx pieces");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xs = aligned_smem(smem_raw);  // [DP / 64][kDxBM][64]
  unsigned char* ring = Xs + XBYTES;           // kDxStages x [DP][kDxBV]
  // [kXchSlots][kConsumers][kDxBV / 8][128] float4: thread t's partial at
  // i4 * 128 + t
  float4* xch = reinterpret_cast<float4*>(ring + kDxStages * WBYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(xch) +
      kXchSlots * kConsumers * kPartBytes);
  uint64_t* empty = full + kDxStages;
  uint64_t* res = empty + kDxStages;

  const int r0 = blockIdx.x * kDxBM;
  const int nvt = (V + kDxBV - 1) / kDxBV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpsC * kDxMc);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_blocks<kDxMc>();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(res, XBYTES);
      for (int c = 0; c < DP / 64; ++c)
        tma_load_2d(Xs + c * kDxBM * 128, &tm_x, res, 64 * c, r0);
      for (int it = 0; it < nvt; ++it) {
        const int s = it % kDxStages;
        mbar_wait(&empty[s], ((it / kDxStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], WBYTES);
        unsigned char* wt = ring + s * WBYTES;
        for (int b = 0; b < DP / 64; ++b)
          load_w<kDxMc>(wt + b * 64 * kDxBV * 2, &tm_w, &full[s], it * kDxBV,
                        64 * b, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    const int ra = r0 + warp * 16 + gr, rb = ra + 8;
    // the rows' statistics; rows past N have g = 0 (ds = 0)
    const float l2a = ra < N ? lse[ra] * kLog2e : 0.f;
    const float l2b = rb < N ? lse[rb] * kLog2e : 0.f;
    const float ga = ra < N ? g[ra] : 0.f, gb = rb < N ? g[rb] : 0.f;
    const int ya = ra < N ? y[ra] : -1, yb = rb < N ? y[rb] : -1;
    float acc[NP][PN / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PN / 2; ++i) acc[p][i] = 0.f;
    float S[kDxBV / 2];
#pragma unroll
    for (int i = 0; i < kDxBV / 2; ++i) S[i] = 0.f;
    uint32_t P[kDxBV / 16][4];
    const uint32_t xa = smem_u32(Xs) + wg * NCH * kDxBM * 128;
    const uint32_t ring_a = smem_u32(ring) + wg * HALF * kDxBV * 2;
    mbar_wait(res, 0);
    for (int it = 0; it < nvt; ++it) {
      const int s = it % kDxStages;
      const uint32_t wt = ring_a + s * WBYTES;  // this warpgroup's d rows
      // the partial score over this warpgroup's d-half
      mbar_wait(&full[s], (it / kDxStages) & 1);
      wgmma_fence();
      score_mma<NCH, kDxBV>(S, xa, wt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
      // the other half's partial, through this tile's exchange slot
      constexpr int SLOT = kPartBytes / 16;  // float4 a slot
      const int slot = (it % kXchSlots) * kConsumers;
      float4* mine = xch + (slot + wg) * SLOT + t;
      const float4* other = xch + (slot + 1 - wg) * SLOT + t;
#pragma unroll
      for (int i4 = 0; i4 < kDxBV / 8; ++i4)
        mine[i4 * 128] = make_float4(S[4 * i4], S[4 * i4 + 1], S[4 * i4 + 2],
                                     S[4 * i4 + 3]);
      named_bar_sync(1, kConsumers * 128);
#pragma unroll
      for (int i4 = 0; i4 < kDxBV / 8; ++i4) {
        const float4 o = other[i4 * 128];
        S[4 * i4] += o.x;
        S[4 * i4 + 1] += o.y;
        S[4 * i4 + 2] += o.z;
        S[4 * i4 + 3] += o.w;
      }
      // ds = (exp(s - lse) - onehot) * g: S[4 j + e] is row (e & 2 ? rb :
      // ra), column v0 + 8 j + 2 gc + (e & 1)
      const int v0 = it * kDxBV;
#pragma unroll
      for (int i = 0; i < kDxBV / 2; ++i) {
        const int col = v0 + 8 * (i >> 2) + 2 * gc + (i & 1);
        const bool b = i & 2;
        const float p = exp2f(fmaf(S[i], kLog2e, -(b ? l2b : l2a)));
        S[i] = (p - (col == (b ? yb : ya) ? 1.f : 0.f)) * (b ? gb : ga);
      }
      to_frags(S, P);  // rounds ds to bf16, as the TPU kernel does
      // dx_half += ds . w_half^T (the w tile K-major: vocab the reduction)
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < kDxBV / 16; ++kk) {
          const uint64_t db = w_desc_k(wt + p * PN * kDxBV * 2 + kk * 32);
          if constexpr (PN == 192)
            wgmma_rs_n192_kb(acc[p], P[kk], db);
          else if constexpr (PN == 128)
            wgmma_rs_n128_kb(acc[p], P[kk], db);
          else
            wgmma_rs_n64_kb(acc[p], P[kk], db);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      release<kDxMc>(&empty[s], lane);
    }
    // dx in bf16, written once: acc[p][4 j + e] is row (e & 2 ? rb : ra),
    // column wg HALF + p PN + 8 j + 2 gc + (e & 1)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int col = wg * HALF + p * PN + 8 * j + 2 * gc;
        if (col < D) {
          if (ra < N)
            *reinterpret_cast<uint32_t*>(dx + (long long)ra * D + col) =
                pack_bf16(acc[p][4 * j], acc[p][4 * j + 1]);
          if (rb < N)
            *reinterpret_cast<uint32_t*>(dx + (long long)rb * D + col) =
                pack_bf16(acc[p][4 * j + 2], acc[p][4 * j + 3]);
        }
      }
  }
  leave<kDxMc>();
}

// -- host side ---------------------------------------------------------------

// A grid of `blocks` row blocks of `kern`, rounded up to whole clusters of
// `mc` blocks.
cudaError_t launch_rows(const void* kern, unsigned blocks, int mc,
                        size_t smem, cudaStream_t st, void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + mc - 1) / mc * mc, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = mc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = mc > 1 ? 1 : 0;
  e = cudaLaunchKernelExC(&cfg, kern, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool args_ok(const void* const* ptrs, int n, int N, int D, int V, int dtype) {
  if (dtype != 1 || N < 1 || D < 1 || D > kMaxD || D % 8 != 0 || V < 1 ||
      V % 8 != 0)
    return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

// x [N, D] as 2-D boxes of [rows, 64] and w [D, V] as boxes of [64, wcols]
// (both bf16, the swizzle that a row of the box's bytes needs)
cudaError_t make_ce_maps(CUtensorMap* mx, CUtensorMap* mw, const void* x,
                         const void* w, int N, int D, int V, int rows,
                         int wcols) {
  const cuuint64_t xd[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t xs[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xb[2] = {64, (cuuint32_t)rows};
  const cuuint64_t wd[2] = {(cuuint64_t)V, (cuuint64_t)D};
  const cuuint64_t ws[1] = {(cuuint64_t)V * 2};
  const cuuint32_t wb[2] = {(cuuint32_t)wcols, 64};
  cudaError_t e;
  if ((e = encode_map(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xd, xs, xb,
                      CU_TENSOR_MAP_SWIZZLE_128B)))
    return e;
  return encode_map(mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, wd, ws, wb,
                    wcols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int NCH>
int launch_dx(const CUtensorMap& mx, const CUtensorMap& mw, const void* y,
              const void* lse, const void* g, void* dx, int N, int D, int V,
              cudaStream_t st) {
  constexpr size_t smem = dx_smem_bytes<NCH>();
  static_assert(smem <= 232448, "dx shared memory");
  CUtensorMap x_map = mx, w_map = mw;
  void* args[] = {&x_map, &w_map, &y, &lse, &g, &dx, &N, &D, &V};
  return (int)launch_rows(reinterpret_cast<const void*>(ce_dx_sm90_kernel<NCH>),
                          (unsigned)((N + kDxBM - 1) / kDxBM), kDxMc, smem, st,
                          args);
}

}  // namespace

// Both launch on `stream`, allocate nothing and return the cudaError_t of
// the launch (0 on success).  dtype 1 (bfloat16) only; x [N, D] and w [D, V]
// row-major, y [N] int32, lse and g [N] float32; loss and lse [N] float32
// (forward) and dx [N, D] bf16 are written whole.  D <= 768, D and V
// multiples of 8, every pointer 16-byte aligned.  The wrapper
// (paddle_tpu_torch/kernels/fused_ce.py) checks shapes, dtypes and
// contiguity, applies the dispatch rule and allocates the outputs.
extern "C" int fused_ce_fwd_sm90(const void* x, const void* w, const void* y,
                                 void* loss, void* lse, int N, int D, int V,
                                 int dtype, void* stream) {
  const void* ptrs[5] = {x, w, y, loss, lse};
  if (!args_ok(ptrs, 5, N, D, V, dtype)) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t e;
  if ((e = bind_device_of(x)) ||
      (e = make_ce_maps(&mx, &mw, x, w, N, D, V, kBlockRows, 64)))
    return (int)e;
  static_assert(fwd_smem_bytes() <= 232448, "forward shared memory");
  void* args[] = {&mx, &mw, &y, &loss, &lse, &N, &D, &V};
  return (int)launch_rows(reinterpret_cast<const void*>(ce_fwd_sm90_kernel),
                          (unsigned)((N + kBlockRows - 1) / kBlockRows),
                          kFwdMc, fwd_smem_bytes(),
                          static_cast<cudaStream_t>(stream),
                          args);
}

extern "C" int fused_ce_dx_sm90(const void* x, const void* w, const void* y,
                                const void* lse, const void* g, void* dx,
                                int N, int D, int V, int dtype, void* stream) {
  const void* ptrs[6] = {x, w, y, lse, g, dx};
  if (!args_ok(ptrs, 6, N, D, V, dtype)) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t e;
  if ((e = bind_device_of(x)) ||
      (e = make_ce_maps(&mx, &mw, x, w, N, D, V, kDxBM, kDxBV)))
    return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128) return launch_dx<1>(mx, mw, y, lse, g, dx, N, D, V, st);
  if (D <= 256) return launch_dx<2>(mx, mw, y, lse, g, dx, N, D, V, st);
  if (D <= 384) return launch_dx<3>(mx, mw, y, lse, g, dx, N, D, V, st);
  return launch_dx<6>(mx, mw, y, lse, g, dx, N, D, V, st);
}

extern "C" const char* fused_ce_fwd_dx_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
