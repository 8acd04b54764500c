// The weight gradient of the fused softmax-cross-entropy head for Hopper
// (sm_90a), hand-written CUDA C++ bound to PyTorch through a plain C
// interface (ctypes), as the other sources here; the primitives (TMA,
// mbarriers, wgmma, descriptors, clusters, tensor maps) are sm90.cuh's.
//
// Replaces paddle_tpu/ops/pallas_ce.py: the dW pallas_call of _ce_bwd
// (:211, _ce_dw_kernel):
//
//   dW[d, v] = sum_n x[n, d] ds[n, v],
//   ds = bf16((exp(x.w - lse) - onehot(y)) * g)   (an out-of-range label,
//                                                  -1 or >= V, no onehot)
//
// with f32 accumulation, dW written once in bf16, and the [N, V] scores
// never in device memory.  The wrapper (paddle_tpu_torch/kernels/
// fused_ce.py) takes this kernel for the inputs its static rule admits
// (bf16, d <= 768, d and V multiples of 8, 16-byte aligned pointers: what
// TMA addresses); everything else keeps fused_ce.cu's ce_dw_kernel.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations, two
// products of 2 N d V flops: 3.335 ms at N = 32768, d = 768, V = 32768.
// What held the WMMA kernel back was x traffic: a block owned 32 vocab
// columns and streamed all of x, 1024 times in all.  Here a block owns 128
// columns (x is read V / 128 times) and the [128, d] f32 accumulator, too
// large for one SM's registers at d = 768, is split along d across a
// thread-block cluster:
//
//   cluster   c = ceil(d / 256) blocks (1..3), one per 256-wide d slice;
//             grid (c, ceil(V / 128)).  Block r of the cluster reads only
//             its slice of w (resident, [256, 128], by TMA once) and of x.
//   block     one producer warp (setmaxnreg 24) feeds x tiles [64 rows,
//             256 d] and the rows' lse, g, y through a 2-deep TMA ring (the
//             exchange areas take a third stage's shared memory); two
//             consumer warpgroups (setmaxnreg 240) own 64 vocab columns
//             each.
//   per tile  S^T[v, n] over the block's slice by wgmma (A = w^T read
//             transposed from shared memory, B = the x tile K-major), f32
//             in registers.  The c partial score tiles are summed through
//             distributed shared memory: each warpgroup stages its partial
//             in its own shared memory and one thread pushes it into the
//             same warpgroup of every other block with one bulk copy each
//             (the bytes complete on the receiver's barrier), then the
//             warpgroup adds what it received in rank order, so every
//             block of the cluster holds the same full scores and the
//             flops stay at two products; ds in registers, rounded to
//             bf16 straight into the register A fragment; dW^T[v, slice]
//             += ds^T . x by wgmma (B = the same x tile read MN-major),
//             2 x 64 f32 registers a thread for the whole row loop.
//   cost      measured on the H100 at the path shape: 5.3 ms with every
//             block alone (no cluster, no exchange), 6.2 with the cluster
//             launch, 11.4 with the exchange.  The exchange's bytes are
//             not what costs (an eighth of them saves 1.3-1.4 ms), nor
//             waiting for the other blocks (a block exchanging with itself
//             takes as long): every tile waits out its copies' round trip.
//             A cluster-scope release on the remote arrival cost another
//             3.3-3.5 ms and is not used.
//             Tried and slower: 32-row tiles with double-buffered
//             exchange areas, a reduce-scatter of the partials with an
//             all-gather of the ds fragments, the previous tile's dW
//             product under the exchange, the two warpgroups half a tile
//             apart, plain remote stores, st.async per 16 bytes.
//   epilogue  the accumulator is staged through shared memory as bf16 and
//             written once, 16 bytes a thread: no atomics, so dW is the
//             same bits from run to run.
//
// Ragged edges come from TMA's zero fill: rows past N have x = 0 and g = 0
// (ds = 0), d past D has x = w = 0, vocab columns past V are computed and
// never stored.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBV = 128;        // vocab columns a cluster owns (64 a warpgroup)
constexpr int kBM = 64;         // rows of x a streamed tile
constexpr int kSlice = 256;     // d a block of the cluster owns
constexpr int kMaxCluster = 3;  // d <= 768
constexpr int kDwStages = 2;    // x tiles in flight (the exchange slots
                                // take a third stage's shared memory)
constexpr int kXBytes = kBM * kSlice * 2;  // an x tile: 4 boxes [kBM, 64]
constexpr int kWBytes = kSlice * 64 * 2;   // a warpgroup's w^T [kSlice, 64]
constexpr int kStatBytes = 3 * kBM * 4;    // lse, g, y of a tile
constexpr int kPartBytes = 128 * 32 * 4;   // a warpgroup's partial scores
// the partials sent (a warpgroup's) and received (a slot a warpgroup and
// other block of the cluster)
constexpr int kSendBytes = kConsumers * kPartBytes;
constexpr int kRecvBytes = kConsumers * (kMaxCluster - 1) * kPartBytes;
constexpr int kOutPitch = kBV + 8;  // bf16 pitch of the staged dW tile

static_assert(kSlice * kOutPitch * 2 <=
                  kConsumers * kWBytes + kDwStages * kXBytes,
              "the staged dW tile fits over the operand tiles");

constexpr size_t dw_smem_bytes() {
  return 1024 + (size_t)kConsumers * kWBytes + (size_t)kDwStages * kXBytes +
         (size_t)kDwStages * kStatBytes + kSendBytes + kRecvBytes +
         (2 * kDwStages + 1 + 2 * kConsumers) * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kThreads, 1)
ce_dw_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_lse,
                  const __grid_constant__ CUtensorMap tm_g,
                  const __grid_constant__ CUtensorMap tm_y,
                  __nv_bfloat16* __restrict__ dw, int N, int D, int V) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ws = aligned_smem(smem_raw);     // [2][kSlice][64] bf16
  unsigned char* Xs = Ws + kConsumers * kWBytes;  // kDwStages x [4][kBM][64]
  unsigned char* St = Xs + kDwStages * kXBytes;   // kDwStages x {lse, g, y}
  float4* send = reinterpret_cast<float4*>(St + kDwStages * kStatBytes);
  float4* recv = send + kSendBytes / 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(recv) + kRecvBytes);
  uint64_t* empty = full + kDwStages;
  uint64_t* res = empty + kDwStages;
  // a warpgroup's: every other block's partial of this tile is in
  // (recvd); every other block has added this block's last one (freed)
  uint64_t* recvd = res + 1;
  uint64_t* freed = recvd + kConsumers;

  const int c = (int)cluster_blocks();
  const int r = (int)cluster_rank();
  const int v0 = blockIdx.y * kBV;
  const int d0 = r * kSlice;
  const int nt = (N + kBM - 1) / kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_init(res, 1);
    for (int i = 0; i < kConsumers; ++i) {
      mbar_init(&recvd[i], 1);  // the local expect_tx; the bytes complete it
      mbar_init(&freed[i], c > 1 ? c - 1 : 1);  // one arrival a peer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before a remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(res, kConsumers * kWBytes);
      for (int hf = 0; hf < kConsumers; ++hf)
        tma_load_2d(Ws + hf * kWBytes, &tm_w, res, v0 + 64 * hf, d0);
      for (int it = 0; it < nt; ++it) {
        const int s = it % kDwStages;
        mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kXBytes + kStatBytes);
        unsigned char* xt = Xs + s * kXBytes;
        for (int ch = 0; ch < kSlice / 64; ++ch)
          tma_load_2d(xt + ch * kBM * 128, &tm_x, &full[s], d0 + 64 * ch,
                      it * kBM);
        unsigned char* st = St + s * kStatBytes;
        tma_load_1d(st, &tm_lse, &full[s], it * kBM);
        tma_load_1d(st + kBM * 4, &tm_g, &full[s], it * kBM);
        tma_load_1d(st + 2 * kBM * 4, &tm_y, &full[s], it * kBM);
      }
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gr = lane / 4, gc = lane % 4;
    // this thread's accumulator rows: vocab columns va and va + 8
    const int vl = 64 * wg + 16 * warp + gr;
    const int va = v0 + vl, vb = va + 8;
    float acc[2][64];  // dW^T[vl.., slice columns 0..127 and 128..255]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    float S[32];
    uint32_t P[4][4];
    const uint32_t wa = smem_u32(Ws) + wg * kWBytes;
    const uint32_t xa = smem_u32(Xs);
    // this warpgroup's partial slots: its send slot, and a receive slot an
    // other block (the sender of rank q in slot q - (q > r)); thread t's 8
    // float4 sit 128 apart, and a slot offset holds the same (v, n)
    // entries in every block of the cluster
    float4* tx = send + wg * 8 * 128 + t;
    const float4* rx = recv + wg * (kMaxCluster - 1) * 8 * 128 + t;
    const uint32_t rx_base =
        smem_u32(recv) + wg * (kMaxCluster - 1) * kPartBytes;
    mbar_wait(res, 0);
    for (int it = 0; it < nt; ++it) {
      const int s = it % kDwStages;
      mbar_wait(&full[s], (it / kDwStages) & 1);
      const uint32_t xs = xa + s * kXBytes;
      // S^T = w^T . x^T over the block's slice (16 k-steps of 16 d)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk)
        wgmma_ss_n64_ta(S, desc_mn(wa + kk * 2048, kSlice * 128),
                        desc_k(xs + (kk >> 2) * (kBM * 128) + (kk & 3) * 32),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
      if (c > 1) {
        // the other blocks have added this block's last partial (and so
        // have finished copying it out of the send slot)
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
        // every thread of the warpgroup has read its slots: the senders may
        // copy the next tile's
        named_bar_sync(1 + wg, 128);
        if (t == 0)
          for (int q = 0; q < c; ++q)
            if (q != r) mbar_arrive_remote(mapa(smem_u32(&freed[wg]), q));
      }
      // ds = (exp(s - lse) - onehot) * g: S[4 k + e] is vocab row (e & 2 ?
      // vb : va), x row 8 k + 2 gc + (e & 1) of the tile
      const float* lse_s = reinterpret_cast<const float*>(St + s * kStatBytes);
      const float* g_s = lse_s + kBM;
      const int* y_s = reinterpret_cast<const int*>(g_s + kBM);
#pragma unroll
      for (int k = 0; k < kBM / 8; ++k) {
        const int n = 8 * k + 2 * gc;
        const float2 L = *reinterpret_cast<const float2*>(lse_s + n);
        const float2 G = *reinterpret_cast<const float2*>(g_s + n);
        const int2 Y = *reinterpret_cast<const int2*>(y_s + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * k + e;
          const int v = (e & 2) ? vb : va;
          const float l = (e & 1) ? L.y : L.x;
          const float g = (e & 1) ? G.y : G.x;
          const int y = (e & 1) ? Y.y : Y.x;
          S[i] = (expf(S[i] - l) - (v == y ? 1.f : 0.f)) * g;
        }
      }
      to_frags(S, P);  // rounds ds to bf16, as the TPU kernel does
      // dW^T[v, slice] += ds^T . x: boxes 0, 1 and boxes 2, 3 of the tile;
      // waited here: an accumulator in flight across other code serialises
      // every wgmma
      wgmma_fence();
      gemm_rs<128, kBM>(acc[0], P, xs);
      gemm_rs<128, kBM>(acc[1], P, xs + 2 * kBM * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[s]);
    }
    // both warpgroups' products are done: stage dW over the operand tiles
    named_bar_sync(3, kConsumers * 128);
    __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(Ws);  // [kSlice][kOutPitch]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 16; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dl = 128 * h + 8 * k + 2 * gc + (e & 1);
          const int vc = vl + ((e & 2) ? 8 : 0);
          Os[dl * kOutPitch + vc] = __float2bfloat16(acc[h][4 * k + e]);
        }
    named_bar_sync(3, kConsumers * 128);
    for (int i = threadIdx.x; i < kSlice * (kBV / 8); i += kConsumers * 128) {
      const int row = i / (kBV / 8), ch = i % (kBV / 8);
      const int d = d0 + row, v = v0 + 8 * ch;
      if (d < D && v < V)
        *reinterpret_cast<uint4*>(dw + (long long)d * V + v) =
            *reinterpret_cast<const uint4*>(Os + row * kOutPitch + 8 * ch);
    }
  }
  // no block leaves while another may still copy into its receive slots
  // or arrive on its barriers
  cluster_sync();
}

}  // namespace

// Launches on `stream`, allocates nothing and returns the cudaError_t of the
// launch (0 on success).  x [N, D] and w [D, V] bf16 row-major, y [N] int32,
// lse and g [N] float32, dw [D, V] bf16 written whole; dtype 1 (bfloat16)
// only, D <= 768, D and V multiples of 8, every pointer 16-byte aligned.
// The wrapper (paddle_tpu_torch/kernels/fused_ce.py) checks shapes, dtypes
// and contiguity, applies the dispatch rule and allocates dw.
extern "C" int fused_ce_dw_sm90(const void* x, const void* w, const void* y,
                                const void* lse, const void* g, void* dw,
                                int N, int D, int V, int dtype,
                                void* stream) {
  if (dtype != 1 || N < 1 || D < 1 || D > kMaxCluster * kSlice || V < 1 ||
      D % 8 != 0 || V % 8 != 0 || (V + kBV - 1) / kBV > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {x, w, y, lse, g, dw};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = bind_device_of(x);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mx, mw, ml, mg, my;
  const cuuint64_t xd[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t xs[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xb[2] = {64, kBM};
  const cuuint64_t wd[2] = {(cuuint64_t)V, (cuuint64_t)D};
  const cuuint64_t ws[1] = {(cuuint64_t)V * 2};
  const cuuint32_t wb[2] = {64, kSlice};
  const cuuint64_t nd[1] = {(cuuint64_t)N};
  const cuuint64_t ns[1] = {0};  // rank 1: no strides, read or not
  const cuuint32_t nb[1] = {kBM};
  if ((e = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, xd, xs,
                      xb, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (e = encode_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, wd, ws,
                      wb, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (e = encode_map(&ml, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, 1, nd, ns,
                      nb, CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (e = encode_map(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, g, 1, nd, ns,
                      nb, CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (e = encode_map(&my, CU_TENSOR_MAP_DATA_TYPE_INT32, y, 1, nd, ns,
                      nb, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)e;
  const size_t smem = dw_smem_bytes();
  e = cudaFuncSetAttribute(ce_dw_sm90_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned c = (unsigned)((D + kSlice - 1) / kSlice);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, (unsigned)((V + kBV - 1) / kBV), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dw);
  void* args[] = {&mx, &mw, &ml, &mg, &my, &out, &N, &D, &V};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(ce_dw_sm90_kernel),
                          args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* fused_ce_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
