// A design reading, not a kernel of the port: the fused CE head's dx built
// as the mirror of the sm90 dW kernel (csrc/fused_ce_sm90.cu), d split over
// a thread-block cluster and the partial scores exchanged through
// distributed shared memory.  benchmarks/kernel_variants.py builds it and
// times it beside the shipped dx (csrc/fused_ce_fwd_dx_sm90.cu, d split
// inside the block); nothing else builds or calls it.
//
//   dx = ds . w^T, ds = bf16((exp(x.w - lse) - onehot(y)) * g)
//
//   cluster   c = ceil(d / 256) blocks, one per 256-wide d slice; grid
//             (c, ceil(N / 128)).  Block r keeps its slice of 128 rows of x
//             resident ([128, 256], by TMA once) and streams its slice of
//             w in [256, 64 vocab] tiles through a 2-stage TMA ring.
//   per tile  each consumer warpgroup (64 rows) computes its partial score
//             S [64, 64] over the block's slice by wgmma (A = x K-major, B
//             = w MN-major), pushes it into the same warpgroup of every
//             other block of the cluster with one bulk copy each, adds what
//             it received in rank order (every block holds the same full
//             scores), forms ds in registers as bf16 A fragments and adds
//             ds . w_slice^T by wgmma (B = the w tile K-major): dx[64 rows,
//             slice] in 2 x 64 f32 registers a thread.  The exchange's
//             barriers are the dW kernel's.
//
// Ragged edges come from TMA's zero fill, as in the shipped kernels.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBV = 64;         // vocab columns of a streamed w tile
constexpr int kSlice = 256;     // d a block of the cluster owns
constexpr int kMaxCluster = 3;  // d <= 768
constexpr int kRing = 2;        // w tiles in flight
constexpr int kXBytes = kBlockRows * kSlice * 2;  // 4 boxes [128, 64]
constexpr int kWBytes = kSlice * kBV * 2;         // 4 boxes [64 d, 64 v]
constexpr int kPartBytes = 128 * 32 * 4;          // a warpgroup's partial
constexpr int kSendBytes = kConsumers * kPartBytes;
constexpr int kRecvBytes = kConsumers * (kMaxCluster - 1) * kPartBytes;

constexpr size_t smem_bytes() {
  return 1024 + (size_t)kXBytes + (size_t)kRing * kWBytes + kSendBytes +
         kRecvBytes + (2 * kRing + 1 + 2 * kConsumers) * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kThreads, 1)
ce_dx_cluster_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const int* __restrict__ y, const float* __restrict__ lse,
                     const float* __restrict__ g,
                     __nv_bfloat16* __restrict__ dx, int N, int D, int V) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xs = aligned_smem(smem_raw);  // [4][kBlockRows][64]
  unsigned char* ring = Xs + kXBytes;          // kRing x [4][64][64]
  float4* send = reinterpret_cast<float4*>(ring + kRing * kWBytes);
  float4* recv = send + kSendBytes / 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(recv) + kRecvBytes);
  uint64_t* empty = full + kRing;
  uint64_t* res = empty + kRing;
  uint64_t* recvd = res + 1;
  uint64_t* freed = recvd + kConsumers;

  const int c = (int)cluster_blocks();
  const int r = (int)cluster_rank();
  const int r0 = blockIdx.y * kBlockRows;
  const int d0 = r * kSlice;
  const int nvt = (V + kBV - 1) / kBV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_init(res, 1);
    for (int i = 0; i < kConsumers; ++i) {
      mbar_init(&recvd[i], 1);
      mbar_init(&freed[i], c > 1 ? c - 1 : 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(res, kXBytes);
      for (int ch = 0; ch < kSlice / 64; ++ch)
        tma_load_2d(Xs + ch * kBlockRows * 128, &tm_x, res, d0 + 64 * ch,
                    r0);
      for (int it = 0; it < nvt; ++it) {
        const int s = it % kRing;
        mbar_wait(&empty[s], ((it / kRing) & 1) ^ 1);
        mbar_expect_tx(&full[s], kWBytes);
        for (int b = 0; b < kSlice / 64; ++b)
          tma_load_2d(ring + s * kWBytes + b * 64 * 128, &tm_w, &full[s],
                      it * kBV, d0 + 64 * b);
      }
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    const int ra = r0 + wg * kRows + warp * 16 + gr, rb = ra + 8;
    const float l2a = ra < N ? lse[ra] * kLog2e : 0.f;
    const float l2b = rb < N ? lse[rb] * kLog2e : 0.f;
    const float ga = ra < N ? g[ra] : 0.f, gb = rb < N ? g[rb] : 0.f;
    const int ya = ra < N ? y[ra] : -1, yb = rb < N ? y[rb] : -1;
    float acc[2][64];  // dx[rows, slice columns 0..127 and 128..255]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    float S[32];
    uint32_t P[4][4];
    const uint32_t xa = smem_u32(Xs) + wg * kRows * 128;
    const uint32_t ring_a = smem_u32(ring);
    float4* tx = send + wg * 8 * 128 + t;
    const float4* rx = recv + wg * (kMaxCluster - 1) * 8 * 128 + t;
    const uint32_t rx_base =
        smem_u32(recv) + wg * (kMaxCluster - 1) * kPartBytes;
    mbar_wait(res, 0);
    for (int it = 0; it < nvt; ++it) {
      const int s = it % kRing;
      mbar_wait(&full[s], (it / kRing) & 1);
      const uint32_t wt = ring_a + s * kWBytes;
      // the partial score over the block's slice (16 k-steps of 16 d)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk)
        wgmma_ss_n64_tb(
            S, desc_k(xa + (kk >> 2) * kBlockRows * 128 + (kk & 3) * 32),
            desc_mn(wt + kk * 2048, 0), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
      if (c > 1) {
        if (it > 0) mbar_wait(&freed[wg], (it - 1) & 1);
#pragma unroll
        for (int i4 = 0; i4 < 8; ++i4)
          tx[i4 * 128] = make_float4(S[4 * i4], S[4 * i4 + 1], S[4 * i4 + 2],
                                     S[4 * i4 + 3]);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (t == 0) {
          mbar_expect_tx(&recvd[wg], (c - 1) * kPartBytes);
          for (int q = 0; q < c; ++q)
            if (q != r)
              bulk_copy_cluster(mapa(rx_base + (r - (r > q)) * kPartBytes, q),
                                smem_u32(tx - t), kPartBytes,
                                mapa(smem_u32(&recvd[wg]), q));
        }
        mbar_wait(&recvd[wg], it & 1);
        // the full scores, summed in rank order in every block
#pragma unroll
        for (int i4 = 0; i4 < 8; ++i4) {
          float4 p[kMaxCluster];
#pragma unroll
          for (int q = 0; q < kMaxCluster; ++q)
            p[q] = q == r ? make_float4(S[4 * i4], S[4 * i4 + 1],
                                        S[4 * i4 + 2], S[4 * i4 + 3])
                 : q < c  ? rx[((q - (q > r)) * 8 + i4) * 128]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          float4 sum = p[0];
#pragma unroll
          for (int q = 1; q < kMaxCluster; ++q)
            if (q < c) {
              sum.x += p[q].x;
              sum.y += p[q].y;
              sum.z += p[q].z;
              sum.w += p[q].w;
            }
          S[4 * i4] = sum.x;
          S[4 * i4 + 1] = sum.y;
          S[4 * i4 + 2] = sum.z;
          S[4 * i4 + 3] = sum.w;
        }
        named_bar_sync(1 + wg, 128);
        if (t == 0)
          for (int q = 0; q < c; ++q)
            if (q != r) mbar_arrive_remote(mapa(smem_u32(&freed[wg]), q));
      }
      // ds = (exp(s - lse) - onehot) * g: S[4 j + e] is row (e & 2 ? rb :
      // ra), column v0 + 8 j + 2 gc + (e & 1)
      const int v0 = it * kBV;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = v0 + 8 * (i >> 2) + 2 * gc + (i & 1);
        const bool b = i & 2;
        const float p = exp2f(fmaf(S[i], kLog2e, -(b ? l2b : l2a)));
        S[i] = (p - (col == (b ? yb : ya) ? 1.f : 0.f)) * (b ? gb : ga);
      }
      to_frags(S, P);
      // dx[rows, slice] += ds . w_slice^T (the w tile K-major)
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < kBV / 16; ++kk)
          wgmma_rs_n128_kb(acc[h], P[kk], desc_k(wt + h * 128 * 128 + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = d0 + 128 * h + 8 * j + 2 * gc;
        if (col < D) {
          if (ra < N)
            *reinterpret_cast<uint32_t*>(dx + (long long)ra * D + col) =
                pack_bf16(acc[h][4 * j], acc[h][4 * j + 1]);
          if (rb < N)
            *reinterpret_cast<uint32_t*>(dx + (long long)rb * D + col) =
                pack_bf16(acc[h][4 * j + 2], acc[h][4 * j + 3]);
        }
      }
  }
  // no block leaves while another may still copy into its receive slots
  // or arrive on its barriers
  cluster_sync();
}

}  // namespace

// fused_ce_dx_sm90's contract (csrc/fused_ce_fwd_dx_sm90.cu).
extern "C" int fused_ce_dx_cluster(const void* x, const void* w,
                                   const void* y, const void* lse,
                                   const void* g, void* dx, int N, int D,
                                   int V, int dtype, void* stream) {
  if (dtype != 1 || N < 1 || D < 1 || D > kMaxCluster * kSlice || V < 1 ||
      D % 8 != 0 || V % 8 != 0 || (N + kBlockRows - 1) / kBlockRows > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {x, w, y, lse, g, dx};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = bind_device_of(x);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mx, mw;
  const cuuint64_t xd[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t xs[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xb[2] = {64, kBlockRows};
  const cuuint64_t wd[2] = {(cuuint64_t)V, (cuuint64_t)D};
  const cuuint64_t ws[1] = {(cuuint64_t)V * 2};
  const cuuint32_t wb[2] = {kBV, 64};
  if ((e = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xd, xs,
                      xb, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (e = encode_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, wd, ws,
                      wb, CU_TENSOR_MAP_SWIZZLE_128B)))
    return (int)e;
  const size_t smem = smem_bytes();
  static_assert(smem_bytes() <= 232448, "shared memory");
  e = cudaFuncSetAttribute(ce_dx_cluster_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned cl = (unsigned)((D + kSlice - 1) / kSlice);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (unsigned)((N + kBlockRows - 1) / kBlockRows), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dx);
  void* args[] = {&mx, &mw, &y, &lse, &g, &out, &N, &D, &V};
  e = cudaLaunchKernelExC(&cfg,
                          reinterpret_cast<const void*>(ce_dx_cluster_kernel),
                          args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
