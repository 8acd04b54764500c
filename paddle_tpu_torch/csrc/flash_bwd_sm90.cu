// The split flash-attention backward for Hopper (sm_90a): a delta pre-pass,
// a q-major dq kernel and a k-major dk/dv kernel, hand-written CUDA C++ bound
// to PyTorch through a plain C interface (ctypes), as the other sources here.
//
// Replaces paddle_tpu/ops/pallas_attention.py: _flash_bwd's split pair,
// _bwd_dq_kernel (called at :900) and _bwd_dkv_kernel (:921), and the
// delta = rowsum(do * o) - dlse that both compute inside (:418, :543).  The
// wrapper (paddle_tpu_torch/kernels/flash_attention.py) takes these kernels
// for bf16 inputs with d <= 128 whose strides and base pointers are 16-byte
// aligned (what TMA can address), and the simple kernels of
// flash_attention.cu for everything else; the rule is static and counted.
//
//   delta   one half-warp a query row (b, t, h): 16-byte vector loads of o
//           and do, f32 sum, minus dlse; written [b*h, t_q] f32 once, read
//           by row in both kernels (neither reads o).  Bound by bytes.
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
//
// Common: a tile wholly above the causal diagonal is never visited, and only
// tiles that cross it (or a ragged edge) are masked.  Ragged t: TMA fills
// rows past the end with zeros, masked entries give p = 0, and rows past the
// end are never stored.  The causal rule is q_pos >= k_pos with positions
// from 0 on both sides (t_q > t_k works).  Numerics are the TPU kernels':
// scores and softmax state in f32, p rounded to bf16 before p^T.do, ds
// rounded before ds^T.q and ds.k.  Tensor maps address [b, t, h, d] with the
// (batch, time, head) strides, so the packed [b, t, h*d] projections are
// read in place; they are encoded on the host per launch, with
// cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (no -lcuda).
// The head dim is padded to 64 or 128 by the box and TMA's zero fill.
// Shared-memory tiles are [rows, 64] column halves in the 128-byte swizzle
// that both TMA and wgmma read; no CUTLASS header is used.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations for dq (three
// causal products, 4.95 TFLOP at b=8, t=16384, h=6, d=128) and dk/dv (four,
// 6.60 TFLOP); bytes for delta (0.40 GB read).  What the design does about
// it: the products run on wgmma with register accumulators, and the next
// tile's TMA load is in flight while the current one is multiplied.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;                     // rows of a consumer warpgroup
constexpr int kConsumers = 2;                 // consumer warpgroups a block
constexpr int kBlockRows = kRows * kConsumers;  // resident rows a block
constexpr int kTile = 64;                     // rows of a streamed tile
constexpr int kStages = 3;                    // depth of the TMA ring
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup

struct Geom {
  int B, H, TQ, TK, D;           // D: the real head dim (<= DP)
  long long q_sb, q_st, q_sh;    // element strides of q, o, do, dq
  long long k_sb, k_st, k_sh;    // element strides of k, v, dk, dv
  float scale;
  int causal;
};

// -- shared memory, mbarriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map ({d, h, t, b}, innermost first) into shared
// memory; completion adds its bytes to the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c_d, int c_h,
                                         int c_t, int c_b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c_d),
      "r"(c_h), "r"(c_t), "r"(c_b)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait
// that makes it valid (the wgmma's outputs look ready at issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptors of a 128-byte-swizzled tile: rows of 64 bf16 (128 B),
// 8-row groups 1024 B apart (the stride byte offset).  K-major: the
// reduction runs along the row.  MN-major: it runs down the rows, and `lbo`
// is the distance between 64-column halves of the tile.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory; acc == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the accumulator
// layout's fragment), B MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (the accumulator
// layout's fragment), B MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Tiles in shared memory are [rows, DP] bf16 stored as DP / 64 column halves
// of [rows, 64] (rows * 128 bytes each), 128-byte swizzled, as TMA writes
// them.  `a` and `b` are shared addresses of a tile's first row in its first
// half; `a_rows` / `b_rows` the rows each half holds.

// d[64 x 64] = A[64 x DP] . B[64 x DP]^T (both K-major)
template <int DP>
__device__ __forceinline__ void gemm_abt(float (&d)[32], uint32_t a,
                                         int a_rows, uint32_t b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
    const uint32_t half = kk >> 2;
    wgmma_ss_n64(d, desc_k(a + half * a_rows * 128 + off),
                 desc_k(b + half * b_rows * 128 + off), kk > 0);
  }
}

// d[64 x DP] += A[64 x 64] . B[64 x DP]: A as four k16 register fragments,
// B a streamed tile of kTile rows read MN-major (16 rows = 2048 bytes a step)
template <int DP>
__device__ __forceinline__ void gemm_rs(float (&d)[DP / 2],
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mn(b + kk * 2048, kTile * 128);
    if constexpr (DP == 128)
      wgmma_rs_n128(d, a[kk], db);
    else
      wgmma_rs_n64(d, a[kk], db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of a 64 x 64 product, rounded to bf16, as the A
// operand of the next one: thread (warp w, lane l) holds d[4 j + e] at row
// 16 w + l / 4 + 8 (e >> 1), column 8 j + 2 (l % 4) + (e & 1), which is the
// k16 A-fragment layout for columns 16 kk .. 16 kk + 15 (j = 2 kk, 2 kk + 1).
__device__ __forceinline__ void to_frags(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Aligns the dynamic shared memory to 1024 bytes (the swizzle's period).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return raw + pad;
}

template <int DP>
constexpr size_t sm90_smem_bytes() {
  constexpr size_t res = (size_t)(DP / 64) * kBlockRows * 128;
  constexpr size_t stg = (size_t)(DP / 64) * kTile * 128;
  return 1024 + 2 * res + kStages * 2 * stg +
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

// -- dk/dv: k-major ----------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Geom g) {
  constexpr int NH = DP / 64;
  constexpr int RES = NH * kBlockRows * 128;
  constexpr int STG = NH * kTile * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = aligned_smem(smem_raw);   // [NH][kBlockRows][64]
  unsigned char* Vs = Ks + RES;
  unsigned char* ring = Vs + RES;               // kStages x {Q, dO}
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * STG);
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
      if (live && !(g.causal && q0 + kTile - 1 < kw0)) {
        const uint32_t qs = smem_u32(ring + s * 2 * STG), dos = qs + STG;
        const float* ls = stats + s * 2 * kTile;
        wgmma_fence();
        gemm_abt<DP>(S, ksa, kBlockRows, qs, kTile);    // S^T = K.Q^T
        wgmma_commit();
        gemm_abt<DP>(dP, vsa, kBlockRows, dos, kTile);  // dP^T = V.dO^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(S);
        const bool mask =
            (g.causal && q0 < kw0 + kRows - 1) || q0 + kTile > g.TQ;
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
            if (mask && (qp >= g.TQ || (g.causal && qp < key))) p = 0.f;
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
        wgmma_fence();
        gemm_rs<DP>(dV, pa, dos);  // dV += P^T . dO
        gemm_rs<DP>(dK, sa, qs);   // dK += dS^T . Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dV);
        fence_regs(dK);
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

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [b, t, h, d] bf16 tensor as a 4-D map, innermost first, with boxes of
// 64 columns by `rows` rows of one (batch, head), 128-byte swizzled; reads
// past any edge fill zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, const Geom& g, int T,
                     long long sb, long long st, long long sh, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)g.D, (cuuint64_t)g.H, (cuuint64_t)T,
                              (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// What these kernels take (the wrapper decides the same before calling).
bool sm90_ok(const Geom& g, const void* const* ptrs, int n) {
  if (g.B < 1 || g.H < 1 || g.TQ < 1 || g.TK < 1 || g.D < 1 || g.D > 128 ||
      g.D % 8 != 0 || (long long)g.B * g.H > 65535)
    return false;
  const long long s[6] = {g.q_sb, g.q_st, g.q_sh, g.k_sb, g.k_st, g.k_sh};
  for (long long x : s)
    if (x % 8 != 0) return false;  // 16 bytes of bf16
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

// The four maps of a launch: the resident side boxes kBlockRows rows, the
// streamed side kTile.
cudaError_t make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
                      const void* k, const void* v, const Geom& g,
                      bool q_resident) {
  const int qr = q_resident ? kBlockRows : kTile;
  const int kr = q_resident ? kTile : kBlockRows;
  cudaError_t e;
  if ((e = make_map(&m[0], q, g, g.TQ, g.q_sb, g.q_st, g.q_sh, qr)) ||
      (e = make_map(&m[1], dout, g, g.TQ, g.q_sb, g.q_st, g.q_sh, qr)) ||
      (e = make_map(&m[2], k, g, g.TK, g.k_sb, g.k_st, g.k_sh, kr)) ||
      (e = make_map(&m[3], v, g, g.TK, g.k_sb, g.k_st, g.k_sh, kr)))
    return e;
  return cudaSuccess;
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

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               const Geom& g, cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, dout, k, v, g, false);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sm90_smem_bytes<DP>();
  auto kern = flash_bwd_sm90_dkv_kernel<DP>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((g.TK + kBlockRows - 1) / kBlockRows),
                  (unsigned)(g.B * g.H));
  kern<<<grid, kThreads, smem, st>>>(m[0], m[1], m[2], m[3], lse, delta,
                                     static_cast<__nv_bfloat16*>(dk),
                                     static_cast<__nv_bfloat16*>(dv), g);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, allocates nothing and returns the
// cudaError_t of the launch (0 on success).  dq and dk/dv take dtype 1
// (bfloat16) only.  Strides are in elements; the head-dim stride is 1.  The wrapper (paddle_tpu_torch/kernels/
// flash_attention.py) checks shapes, dtypes and contiguity, applies the
// dispatch rule and allocates delta, dq, dk and dv.

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
  if (D <= 64) return launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, g, st);
  return launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, g, st);
}

extern "C" const char* flash_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
