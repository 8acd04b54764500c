// The flash-attention backward for Hopper (sm_90a): a delta pre-pass, the
// fused kernel, and the split route's q-major dq kernel and k-major dk/dv
// kernel, hand-written CUDA C++ bound to PyTorch through a plain C
// interface (ctypes), as the other sources here; the primitives (TMA,
// mbarriers, wgmma, descriptors, tensor maps) are sm90.cuh's.
//
// Replaces paddle_tpu/ops/pallas_attention.py: _flash_bwd_fused (:843, the
// fused route), _flash_bwd's split pair, _bwd_dq_kernel (called at :900)
// and _bwd_dkv_kernel (:921), and the delta = rowsum(do * o) - dlse that
// they compute inside (:418, :543).  The wrapper
// (paddle_tpu_torch/kernels/flash_attention.py) takes these kernels for
// bf16 inputs with d <= 128 whose strides and base pointers are 16-byte
// aligned (what TMA can address), and the simple kernels of
// flash_attention.cu for everything else; the rule is static and counted.
//
//   delta   one half-warp a query row (b, t, h): 16-byte vector loads of o
//           and do, f32 sum, minus dlse; written [b*h, t_q] f32 once, read
//           by row in every kernel below (none reads o).  Bound by bytes.
//   dq      grid (q-tiles of 128 rows, b*h), heavy causal tiles first.  Two
//           consumer warpgroups own 64 query rows each; their Q and dO
//           tiles stay resident in shared memory.  K and V tiles of 64 keys
//           stream through a 3-stage ring that one producer warp feeds with
//           TMA (cp.async.bulk.tensor, completion on mbarriers).  Per k-tile
//           a consumer runs S = Q.K^T and dP = dO.V^T as wgmma (A and B in
//           shared memory, f32 sums in registers), p = exp2(s * scale *
//           log2(e) - lse * log2(e)) and ds = p * (dp - delta) * scale in
//           registers, rounds ds to bf16 straight into the A-operand fragment
//           (the accumulator layout is the register A layout) and adds
//           dQ += dS.K by wgmma with K read MN-major (the transpose bit).
//           dQ, 64 x d f32 a warpgroup, lives in registers and is written
//           once in bf16: no atomics, the same bits run to run.
//   dk/dv   grid (k-tiles of 128 keys, b*h), the longest causal walk first.
//           K and V resident (64 keys a consumer warpgroup); Q, dO tiles of
//           64 rows stream through the ring with lse and delta for the same
//           rows staged beside them by the producer warp.  The scores are
//           computed transposed, keys as the wgmma M dimension: S^T = K.Q^T,
//           dP^T = V.dO^T, p^T and ds^T in registers, then dV += P^T.dO and
//           dK += dS^T.Q with A from registers and B MN-major from the ring.
//           dK and dV (64 x d f32 each) stay in registers for the whole walk
//           (setmaxnreg: 240 registers a consumer thread, 24 a producer) and
//           are written once.
//   fused   the dk/dv kernel's body (one template, DQ set) plus the dq
//           product: each warpgroup stores its bf16 dS^T in a swizzled
//           shared tile, a named barrier joins the two, and each computes
//           its columns of the tile's dQ = dS.K by wgmma (A read transposed
//           from shared memory, B the resident K), added into a zeroed f32
//           dq with 16-byte vector reductions: one add a dq element per
//           128-key block, against the simple kernel's scalar atomic per
//           64-key tile.  dk and dv are the split route's bits; dq is
//           reproducible to f32 rounding only (atomics).
//
// Common: a tile wholly above the causal diagonal is never visited, and only
// tiles that cross it (or a ragged edge) are masked.  Ragged t: TMA fills
// rows past the end with zeros, masked entries give p = 0, and rows past the
// end are never stored.  The causal rule is q_pos >= k_pos with positions
// from 0 on both sides (t_q > t_k works).  Numerics are the TPU kernels':
// scores and softmax state in f32, p rounded to bf16 before p^T.do, ds
// rounded before ds^T.q and ds.k.  Tensor maps address [b, t, h, d] with the
// (batch, time, head) strides, so the packed [b, t, h*d] projections are
// read in place.  The head dim is padded to 64 or 128 by the box and TMA's
// zero fill.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations for dq (three
// causal products, 4.95 TFLOP at b=8, t=16384, h=6, d=128), dk/dv (four,
// 6.60 TFLOP) and the fused kernel (five, 0.516 TFLOP at t=4096: 0.521 ms);
// bytes for delta (0.40 GB read at t=16384).  What the design does about
// it: the products run on wgmma with register accumulators, and the next
// tile's TMA load is in flight while the current one is multiplied.

#include "sm90.cuh"

namespace {

// bytes of one bf16 dS^T tile of the fused kernel: the block's 128 keys by
// a streamed tile's 64 queries
constexpr int kDsBytes = kBlockRows * kTile * 2;

template <int DP, bool DQ = false>
constexpr size_t sm90_smem_bytes() {
  constexpr size_t res = (size_t)(DP / 64) * kBlockRows * 128;
  constexpr size_t stg = (size_t)(DP / 64) * kTile * 128;
  return 1024 + 2 * res + kStages * 2 * stg + (DQ ? 2 * kDsBytes : 0) +
         kStages * 2 * kTile * sizeof(float) +
         (2 * kStages + 1) * sizeof(uint64_t);
}

// -- delta pre-pass ------------------------------------------------------------

// delta[b*h, t] = rowsum(do * o) - dlse: one half-warp a row, rows in
// (b, t, h) order so neighbouring half-warps read neighbouring heads; each
// lane reads 16-byte vectors (8 bf16) of o and do.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ dlse,
                       float* __restrict__ delta, int B, int H, int TQ, int D,
                       long long sb, long long st, long long sh) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 16;
  const int sub = threadIdx.x % 16;
  const long long nrows = (long long)B * TQ * H;
  float part = 0.f;
  int b = 0, t = 0, h = 0;
  if (row < nrows) {
    h = (int)(row % H);
    t = (int)((row / H) % TQ);
    b = (int)(row / ((long long)H * TQ));
    const long long off = (long long)b * sb + (long long)t * st +
                          (long long)h * sh;
    for (int c = sub * 8; c < D; c += 16 * 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + off + c);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + off + c);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(x2[i]);
        const float2 d = __bfloat1622float2(y2[i]);
        part += a.x * d.x + a.y * d.y;
      }
    }
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
  if (row < nrows && sub == 0) {
    const long long at = ((long long)b * H + h) * TQ + t;
    delta[at] = part - (dlse != nullptr ? dlse[at] : 0.f);
  }
}

// -- dq: q-major -------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Geom g) {
  constexpr int NH = DP / 64;
  constexpr int RES = NH * kBlockRows * 128;  // bytes of a resident tile
  constexpr int STG = NH * kTile * 128;       // bytes of a streamed tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = aligned_smem(smem_raw);   // [NH][kBlockRows][64]
  unsigned char* dOs = Qs + RES;
  unsigned char* ring = dOs + RES;              // kStages x {K, V}
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + kStages * 2 * STG + kStages * 2 * kTile * sizeof(float));
  uint64_t* empty = full + kStages;
  uint64_t* res = empty + kStages;

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * kBlockRows;
  int nkt = (g.TK + kTile - 1) / kTile;
  // causal: k-tiles wholly past the block's last row see none of it
  if (g.causal) nkt = min(nkt, (min(q0 + kBlockRows, g.TQ) - 1) / kTile + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(res, 2 * RES);
      for (int hf = 0; hf < NH; ++hf) {
        tma_load(Qs + hf * kBlockRows * 128, &tm_q, res, 64 * hf, h, q0, b);
        tma_load(dOs + hf * kBlockRows * 128, &tm_do, res, 64 * hf, h, q0, b);
      }
      for (int it = 0; it < nkt; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * STG);
        unsigned char* Ks = ring + s * 2 * STG;
        for (int hf = 0; hf < NH; ++hf) {
          tma_load(Ks + hf * kTile * 128, &tm_k, &full[s], 64 * hf, h,
                   it * kTile, b);
          tma_load(Ks + STG + hf * kTile * 128, &tm_v, &full[s], 64 * hf, h,
                   it * kTile, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    const int r0 = q0 + wg * kRows;                 // this warpgroup's rows
    const int ra = r0 + warp * 16 + gr, rb = ra + 8;  // this thread's rows
    const bool live = r0 < g.TQ;
    const int last_row = min(r0 + kRows, g.TQ) - 1;
    const float sl2 = g.scale * kLog2e;
    const long long rowbase = (long long)bh * g.TQ;
    float lse_a = 0.f, lse_b = 0.f, del_a = 0.f, del_b = 0.f;
    if (ra < g.TQ) {
      lse_a = lse[rowbase + ra] * kLog2e;
      del_a = delta[rowbase + ra];
    }
    if (rb < g.TQ) {
      lse_b = lse[rowbase + rb] * kLog2e;
      del_b = delta[rowbase + rb];
    }
    float acc[DP / 2], S[32], dP[32];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = dP[i] = 0.f;
    const uint32_t qa = smem_u32(Qs) + wg * kRows * 128;
    const uint32_t da = smem_u32(dOs) + wg * kRows * 128;
    mbar_wait(res, 0);
    for (int it = 0; it < nkt; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const int k0 = it * kTile;
      if (live && !(g.causal && k0 > last_row)) {
        const uint32_t ks = smem_u32(ring + s * 2 * STG), vs = ks + STG;
        wgmma_fence();
        gemm_abt<DP>(S, qa, kBlockRows, ks, kTile);
        wgmma_commit();
        gemm_abt<DP>(dP, da, kBlockRows, vs, kTile);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(S);
        // only tiles that cross the diagonal or the ragged key edge mask
        const bool mask = (g.causal && k0 + kTile - 1 > r0) || k0 + kTile > g.TK;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i & 2) ? rb : ra;
          const int col = k0 + 8 * (i >> 2) + 2 * gc + (i & 1);
          float p = exp2f(S[i] * sl2 - ((i & 2) ? lse_b : lse_a));
          if (mask && (col >= g.TK || (g.causal && col > row))) p = 0.f;
          S[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dP);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dP[i] = S[i] * (dP[i] - ((i & 2) ? del_b : del_a)) * g.scale;
        uint32_t a[4][4];
        to_frags(dP, a);
        wgmma_fence();
        gemm_rs<DP>(acc, a, ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(&empty[s]);
    }
    if (live) {
      __nv_bfloat16* out =
          dq + (long long)b * g.q_sb + (long long)h * g.q_sh;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * gc;
        if (col < g.D) {
          if (ra < g.TQ)
            *reinterpret_cast<uint32_t*>(out + (long long)ra * g.q_st + col) =
                pack_bf16(acc[4 * j], acc[4 * j + 1]);
          if (rb < g.TQ)
            *reinterpret_cast<uint32_t*>(out + (long long)rb * g.q_st + col) =
                pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

// -- dk/dv (and, fused, dq): k-major ------------------------------------------

// The k-major body: dK and dV of a 128-key block and, with DQ, the block's
// share of dQ.  flash_bwd_sm90_dkv_kernel (split route) and
// flash_bwd_sm90_fused_kernel (fused route) are this body with DQ false and
// true, so the two routes' dk and dv are the same bits.
//
// DQ: once a q-tile's dS^T (64 keys x 64 queries a consumer warpgroup) is
// in registers, each warpgroup stores it in bf16 into a swizzled shared
// tile (double-buffered by q-tile parity), a named barrier joins the two
// warpgroups, and warpgroup w computes dQ_tile = dS . K with A the dS^T tile
// read transposed and B the resident K read MN-major: at DP = 128 its 64
// columns of dQ over all 128 keys, at DP = 64 all 64 columns over its own
// 64 keys.  32 f32 accumulators a thread; the tile is added into the zeroed
// f32 dq with 16-byte vector reductions (atomicAdd on float4, a
// red.global.add.v4.f32): a lane swaps one f32 pair with its neighbour so
// that it holds four consecutive columns of one row.
//
// g comes by value: through a reference to the kernel parameter the
// compiler reloads the lengths and the causal flag in the masking loop and
// branches once an element (the dk/dv kernel measured 10% slower so).
template <int DP, bool DQ>
__device__ __forceinline__ void bwd_kv_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_do, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq32,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const Geom g, unsigned char* smem_raw) {
  constexpr int NH = DP / 64;
  constexpr int RES = NH * kBlockRows * 128;
  constexpr int STG = NH * kTile * 128;
  unsigned char* Ks = aligned_smem(smem_raw);   // [NH][kBlockRows][64]
  unsigned char* Vs = Ks + RES;
  unsigned char* ring = Vs + RES;               // kStages x {Q, dO}
  unsigned char* dSs = ring + kStages * 2 * STG;  // DQ: 2 x [128 keys][64]
  float* stats = reinterpret_cast<float*>(dSs + (DQ ? 2 * kDsBytes : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* res = empty + kStages;

  const int kt = blockIdx.x;  // k-tile 0 walks the most q-tiles: first
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int k0 = kt * kBlockRows;
  const int nqt = (g.TQ + kTile - 1) / kTile;
  // causal: q-tiles wholly above this block's first key see none of it
  const int jq0 = g.causal ? min(k0 / kTile, nqt) : 0;
  const int nit = nqt - jq0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const long long rowbase = (long long)bh * g.TQ;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < kConsumers * 128 + 32) {
      // the producer warp: lane 0 issues the copies, every lane stages
      // lse * log2(e) and delta of the tile's rows
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(res, 2 * RES);
        for (int hf = 0; hf < NH; ++hf) {
          tma_load(Ks + hf * kBlockRows * 128, &tm_k, res, 64 * hf, h, k0, b);
          tma_load(Vs + hf * kBlockRows * 128, &tm_v, res, 64 * hf, h, k0, b);
        }
      }
      for (int it = 0; it < nit; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int q0 = (jq0 + it) * kTile;
        float* ls = stats + s * 2 * kTile;
        for (int r = lane; r < kTile; r += 32) {
          const int qp = q0 + r;
          float l2 = 0.f, dl = 0.f;
          if (qp < g.TQ) {
            l2 = lse[rowbase + qp] * kLog2e;
            dl = delta[rowbase + qp];
          }
          ls[r] = l2;
          ls[kTile + r] = dl;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * STG);
          unsigned char* Qt = ring + s * 2 * STG;
          for (int hf = 0; hf < NH; ++hf) {
            tma_load(Qt + hf * kTile * 128, &tm_q, &full[s], 64 * hf, h, q0,
                     b);
            tma_load(Qt + STG + hf * kTile * 128, &tm_do, &full[s], 64 * hf,
                     h, q0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    const int kw0 = k0 + wg * kRows;                  // this warpgroup's keys
    const int ka = kw0 + warp * 16 + gr, kb = ka + 8;  // this thread's keys
    const bool live = kw0 < g.TK;
    const float sl2 = g.scale * kLog2e;
    float dK[DP / 2], dV[DP / 2], S[32], dP[32];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dK[i] = dV[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = dP[i] = 0.f;
    const uint32_t ksa = smem_u32(Ks) + wg * kRows * 128;
    const uint32_t vsa = smem_u32(Vs) + wg * kRows * 128;
    mbar_wait(res, 0);
    for (int it = 0; it < nit; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const int q0 = (jq0 + it) * kTile;
      const bool mine = live && !(g.causal && q0 + kTile - 1 < kw0);
      // DQ: this q-tile's dS^T buffer; WG1's keys (64..127) are live here
      unsigned char* dsb = dSs + (it & 1) * kDsBytes;
      const bool live1 = k0 + kRows < g.TK &&
                         !(g.causal && q0 + kTile - 1 < k0 + kRows);
      if (mine) {
        const uint32_t qs = smem_u32(ring + s * 2 * STG), dos = qs + STG;
        const float* ls = stats + s * 2 * kTile;
        wgmma_fence();
        gemm_abt<DP>(S, ksa, kBlockRows, qs, kTile);    // S^T = K.Q^T
        wgmma_commit();
        gemm_abt<DP>(dP, vsa, kBlockRows, dos, kTile);  // dP^T = V.dO^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(S);
        // DQ also masks keys past t_k (their zero-filled K rows meet dS in
        // the dq product, and a non-finite p there would poison it)
        const bool mask = (g.causal && q0 < kw0 + kRows - 1) ||
                          q0 + kTile > g.TQ || (DQ && kw0 + kRows > g.TK);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * gc;  // this thread's two query columns
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int key = (e & 2) ? kb : ka;
            const int qp = q0 + c + (e & 1);
            float p = exp2f(S[i] * sl2 - ((e & 1) ? l2.y : l2.x));
            if (mask && (qp >= g.TQ || (g.causal && qp < key) ||
                         (DQ && key >= g.TK)))
              p = 0.f;
            S[i] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dP);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(ls + kTile + 8 * j + 2 * gc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dP[i] = S[i] * (dP[i] - ((e & 1) ? dl.y : dl.x)) * g.scale;
          }
        }
        uint32_t pa[4][4], sa[4][4];
        to_frags(S, pa);
        to_frags(dP, sa);
        if constexpr (DQ) {
          // dS^T rows are this thread's keys, columns its query pairs: row
          // r's 16-byte chunk j sits at chunk j ^ (r % 8) (128-byte swizzle)
          const int r_a = wg * kRows + warp * 16 + gr, r_b = r_a + 8;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 2 * kk + (i >> 1), r = (i & 1) ? r_b : r_a;
              *reinterpret_cast<uint32_t*>(dsb + r * 128 +
                                           ((j ^ (r & 7)) << 4) + gc * 4) =
                  sa[kk][i];
            }
          fence_proxy_async();
        }
        wgmma_fence();
        gemm_rs<DP>(dV, pa, dos);  // dV += P^T . dO
        gemm_rs<DP>(dK, sa, qs);   // dK += dS^T . Q
        wgmma_commit();
        if constexpr (!DQ) {
          wgmma_wait<0>();
          fence_regs(dV);
          fence_regs(dK);
        }
      }
      if constexpr (DQ) {
        // every visited q-tile reaches some key of the block (q0 + 63 >=
        // k0), so WG0's keys are live and both warpgroups meet here
        const bool run = DP == 128 || mine;
        if (DP == 128)
          named_bar_sync(1, kConsumers * 128);
        else if (mine)
          named_bar_sync(2 + wg, 128);
        float dQ[32];
        if (run) {
          // DP = 128: columns 64 wg.., keys 0..63 (+ 64..127 when live1);
          // DP = 64: all columns over this warpgroup's own keys
          const int nkk = DP == 128 ? (live1 ? 8 : 4) : 4;
          const uint32_t as = smem_u32(dsb) + (DP == 128 ? 0 : wg * kRows * 128);
          const uint32_t bs =
              smem_u32(Ks) + wg * (DP == 128 ? kBlockRows : kRows) * 128;
#pragma unroll
          for (int i = 0; i < 32; ++i) dQ[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            if (kk < nkk)
              wgmma_ss_n64_tt(dQ, desc_mn(as + kk * 2048, 64 * 128),
                              desc_mn(bs + kk * 2048, kBlockRows * 128),
                              kk > 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
        if (mine) {
          fence_regs(dV);
          fence_regs(dK);
        }
        if (run) {
          fence_regs(dQ);
          const int ra = q0 + warp * 16 + gr, rb = ra + 8;
          const int cbase = DP == 128 ? wg * 64 : 0;
          const bool even = (gc & 1) == 0;
          const int row = even ? ra : rb;
          float* out = dq32 + (long long)b * g.q_sb + (long long)h * g.q_sh +
                       (long long)row * g.q_st;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // even lanes keep row a and take the neighbour's row-a pair,
            // odd lanes row b: four consecutive columns of one row each
            const float s0 = even ? dQ[4 * j + 2] : dQ[4 * j];
            const float s1 = even ? dQ[4 * j + 3] : dQ[4 * j + 1];
            const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
            const float4 v4 = even ? make_float4(dQ[4 * j], dQ[4 * j + 1], r0, r1)
                                   : make_float4(r0, r1, dQ[4 * j + 2],
                                                 dQ[4 * j + 3]);
            const int col = cbase + 8 * j + 2 * (gc & ~1);
            if (row < g.TQ && col < g.D)
              atomicAdd(reinterpret_cast<float4*>(out + col), v4);
          }
        }
      }
      mbar_arrive(&empty[s]);
    }
    if (live) {
      const long long off = (long long)b * g.k_sb + (long long)h * g.k_sh;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * gc;
        if (col < g.D) {
          if (ka < g.TK) {
            const long long at = off + (long long)ka * g.k_st + col;
            *reinterpret_cast<uint32_t*>(dk + at) =
                pack_bf16(dK[4 * j], dK[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(dv + at) =
                pack_bf16(dV[4 * j], dV[4 * j + 1]);
          }
          if (kb < g.TK) {
            const long long at = off + (long long)kb * g.k_st + col;
            *reinterpret_cast<uint32_t*>(dk + at) =
                pack_bf16(dK[4 * j + 2], dK[4 * j + 3]);
            *reinterpret_cast<uint32_t*>(dv + at) =
                pack_bf16(dV[4 * j + 2], dV[4 * j + 3]);
          }
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq32,  // null, unused
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Geom g) {
  extern __shared__ unsigned char smem_raw[];
  bwd_kv_body<DP, false>(tm_q, tm_do, tm_k, tm_v, lse, delta, dq32, dk, dv, g,
                         smem_raw);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_fused_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq32,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Geom g) {
  extern __shared__ unsigned char smem_raw[];
  bwd_kv_body<DP, true>(tm_q, tm_do, tm_k, tm_v, lse, delta, dq32, dk, dv, g,
                        smem_raw);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, const Geom& g,
              cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, dout, k, v, g, true);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sm90_smem_bytes<DP>();
  auto kern = flash_bwd_sm90_dq_kernel<DP>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((g.TQ + kBlockRows - 1) / kBlockRows),
                  (unsigned)(g.B * g.H));
  kern<<<grid, kThreads, smem, st>>>(m[0], m[1], m[2], m[3], lse, delta,
                                     static_cast<__nv_bfloat16*>(dq), g);
  return (int)cudaGetLastError();
}

// The k-major launch: the split route's dk/dv kernel, or (DQ) the fused
// route's kernel, which also adds dq into the zeroed f32 dq32.  Both take
// one parameter list, so one launch serves either.
template <int DP, bool DQ>
int launch_kv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq32, void* dk,
              void* dv, const Geom& g, cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, dout, k, v, g, false);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sm90_smem_bytes<DP, DQ>();
  auto kern = DQ ? flash_bwd_sm90_fused_kernel<DP>
                 : flash_bwd_sm90_dkv_kernel<DP>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((g.TK + kBlockRows - 1) / kBlockRows),
                  (unsigned)(g.B * g.H));
  kern<<<grid, kThreads, smem, st>>>(m[0], m[1], m[2], m[3], lse, delta, dq32,
                                     static_cast<__nv_bfloat16*>(dk),
                                     static_cast<__nv_bfloat16*>(dv), g);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, allocates nothing and returns the
// cudaError_t of the launch (0 on success).  dq, dk/dv and the fused
// kernel take dtype 1 (bfloat16) only.  Strides are in elements; the
// head-dim stride is 1.  The wrapper (paddle_tpu_torch/kernels/
// flash_attention.py) checks shapes, dtypes and contiguity, applies the
// dispatch rule and allocates delta, dq (dq32), dk and dv.

// delta [B*H, TQ] f32 = rowsum(do * o) - dlse (dlse may be null), for the
// bf16 tensors the sm90 kernels take: D and every stride a multiple of 8
// elements, o and do 16-byte aligned.
extern "C" int flash_bwd_sm90_delta(const void* o, const void* dout,
                                    const void* dlse, void* delta, int B,
                                    int H, int TQ, int D, long long sb,
                                    long long st, long long sh,
                                    void* stream) {
  if (B < 1 || H < 1 || TQ < 1 || D < 1 || D % 8 != 0 || sb % 8 != 0 ||
      st % 8 != 0 || sh % 8 != 0 || !aligned16(o) || !aligned16(dout))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * TQ * H * 16;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  flash_bwd_delta_kernel<<<blocks, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(dlse), static_cast<float*>(delta), B, H, TQ,
      D, sb, st, sh);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_sm90_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int TQ, int TK, int D, long long q_sb,
                                 long long q_st, long long q_sh,
                                 long long k_sb, long long k_st,
                                 long long k_sh, float scale, int causal,
                                 int dtype, void* stream) {
  const Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale,
               causal};
  const void* ptrs[5] = {q, k, v, dout, dq};
  if (dtype != 1 || !sm90_ok(g, ptrs, 5)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D <= 64) return launch_dq<64>(q, k, v, dout, l, dl, dq, g, st);
  return launch_dq<128>(q, k, v, dout, l, dl, dq, g, st);
}

extern "C" int flash_bwd_sm90_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int H, int TQ, int TK, int D,
                                  long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh, float scale,
                                  int causal, int dtype, void* stream) {
  const Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale,
               causal};
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  if (dtype != 1 || !sm90_ok(g, ptrs, 6)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D <= 64)
    return launch_kv<64, false>(q, k, v, dout, l, dl, nullptr, dk, dv, g, st);
  return launch_kv<128, false>(q, k, v, dout, l, dl, nullptr, dk, dv, g, st);
}

// The fused route: dk, dv (the split route's bits) and dq added with f32
// vector atomics into dq32, a zeroed f32 tensor of q's shape and strides.
extern "C" int flash_bwd_sm90_fused(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq32, void* dk, void* dv, int B,
                                    int H, int TQ, int TK, int D,
                                    long long q_sb, long long q_st,
                                    long long q_sh, long long k_sb,
                                    long long k_st, long long k_sh,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  const Geom g{B, H, TQ, TK, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, scale,
               causal};
  const void* ptrs[7] = {q, k, v, dout, dq32, dk, dv};
  if (dtype != 1 || !sm90_ok(g, ptrs, 7)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dq = static_cast<float*>(dq32);
  if (D <= 64)
    return launch_kv<64, true>(q, k, v, dout, l, dl, dq, dk, dv, g, st);
  return launch_kv<128, true>(q, k, v, dout, l, dl, dq, dk, dv, g, st);
}

extern "C" const char* flash_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
