// Fused softmax-cross-entropy LM head: forward, dx and dW, hand-written
// kernels for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).
//
// Replaces paddle_tpu/ops/pallas_ce.py: _ce_fwd (the forward pallas_call,
// _ce_fwd_kernel) and the two pallas_calls of _ce_bwd (_ce_dx_kernel,
// _ce_dw_kernel) as the simple family: f32 (phase 6's parity), odd widths
// and misaligned pointers.  bf16 inputs that TMA can address run on the
// sm90 family instead (the wrapper's static rule, ce_family): the forward
// and dx on fused_ce_fwd_dx_sm90.cu, dW on fused_ce_sm90.cu.  The TPU
// kernels run a sequential grid whose innermost axis
// (vocab for the forward and dx, rows for dW) carries the online-softmax
// state or an accumulator in VMEM scratch.  Blocks of a CUDA grid run in
// parallel and in no order, so that axis becomes a loop INSIDE the block:
//
//   forward  grid over row blocks of x; the block keeps its x rows in shared
//            memory, walks every vocab tile of w, and carries the row max, the
//            row sum and the picked label logit in registers; it writes
//            loss = lse - pick and lse = m + log(l), both [N] f32, nothing else;
//   dx       grid over row blocks; for each vocab tile it recomputes
//            s = x_blk . w_tile, p = exp(s - lse), ds = (p - onehot) * g,
//            rounds ds to the input dtype (pallas_ce.py:101) and adds
//            ds . w_tile^T into a [rows, d] f32 accumulator that lives in
//            registers for the whole vocab loop; dx is written once;
//   dW       grid over vocab blocks; the block keeps its w columns in shared
//            memory, walks every row block of x, and adds x_blk^T . ds into a
//            [d, cols] f32 register accumulator; each block owns its dW slice
//            and writes it once, so no atomics.
//
// Numerics follow the TPU kernels: scores in f32 from input-dtype operands,
// online max/sum across vocab tiles, the label logit picked where col == y (an
// out-of-range label, -1 or >= V, picks nothing: loss = lse), ds cast to the
// input dtype before both backward products.  Ragged edges are masked, not
// padded by the caller: rows past N load as zeros and are never stored;
// columns past V score -inf in the forward and give ds = 0 in the backward.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.  At the
// training path's shape (N = 32768 rows, d = 768, V = 32768, bf16) each
// product is 2 N d V = 1.649 TFLOP over operands of 50 MB: the forward does
// one (bound 1.668 ms), dx and dW two each (3.335 ms each).
//
// Design against that bound, and what it leaves for later: every product is a
// GEMM over d with no rescaling part-way through, so the score tile's
// accumulator stays in tensor-core fragments (WMMA 16x16x16, f32 accumulate)
// for the whole d loop and goes through shared memory once, for the softmax
// epilogue; the dx and dW accumulators stay in fragments across the whole
// vocab (row) loop.  The operand that a block walks over (a w tile, or an x
// tile) is copied into shared memory with cp.async, 16 bytes a thread, in
// four groups split along d; the score product waits for one slice at a
// time, so the copy of later slices overlaps the product of earlier ones (in
// the forward, where the w tile is dead after the score product, the next
// tile's copy also runs under the softmax epilogue).  There is no second
// buffer (the resident operands fill shared memory), no TMA and no wgmma:
// making it fast is later work.
//
// Tiles, from the budget of 227 KB of shared memory and 255 registers a
// thread, 256 threads (8 warps) a block, one block an SM, d padded to DP
// (256 or 768; d <= 768):
//   bf16 forward  64 rows x 64 vocab: x rows 64 x 776 x 2 = 99,328 B, w tile
//                 768 x 72 x 2 = 110,592 B, f32 scores 64 x 68 x 4 = 17,408 B:
//                 227,328 B; two 16x16 score fragments a warp.
//   bf16 dx       32 rows x 64 vocab: x 49,664 + w tile 110,592 + scores 8,704
//                 + ds 4,608 + row stats = 173,952 B; the [32, 768] f32
//                 accumulator is 2 x 6 fragments a warp = 96 registers.
//   bf16 dW       64 rows x 32 vocab: w slice 768 x 40 x 2 = 61,440 + x tile
//                 99,328 + scores 9,216 + ds 5,120 + stats = 175,872 B; the
//                 [768, 32] f32 accumulator is 6 x 2 fragments a warp.
//   f32 (phase-6 parity, 2e-4): plain f32 FMAs, no TF32, with the same
//                 fragment shapes held per lane (2 x 4 elements of a 16x16
//                 tile); forward 32 x 32, dx 32 x 32, dW 32 rows x 16 vocab.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPadF = 4;  // f32 tile pitch pad (elements)

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int FWD_BM = 64, FWD_BV = 64;
  static constexpr int DX_BM = 32, DX_BV = 64;
  static constexpr int DW_BM = 64, DW_BV = 32;
};
template <>
struct Cfg<float> {
  static constexpr int FWD_BM = 32, FWD_BV = 32;
  static constexpr int DX_BM = 32, DX_BV = 32;
  static constexpr int DW_BM = 32, DW_BV = 16;
};

// operand tiles are padded by 16 bytes a row: rows stay 16-byte aligned for
// the vector copies and off one bank
template <typename T>
__host__ __device__ constexpr int pad_of() {
  return 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
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

// 16 bytes global -> shared without a register round trip; src_bytes 0
// fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A walked tile (the w tile of the forward and dx, the x tile of dW) is
// copied as kChunks cp.async groups, split along d, and the score product
// waits for one slice at a time: the copy of later slices overlaps the
// product of earlier ones.
constexpr int kChunks = 4;

// waits until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  static_assert(kChunks <= 4, "one case per possible count");
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Copies a [rows, cols] tile into shared memory (pitch lds) from a row-major
// source (row stride lsrc elements); rows >= rvalid or columns >= cvalid
// become zeros.  vec: 16-byte copies (cols, cvalid, lsrc and the source are
// multiples of 16 bytes, so a chunk is wholly valid or wholly not).  The
// caller's __syncthreads() publishes the tile.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* src,
                                          long long lsrc, int rows, int cols,
                                          int rvalid, int cvalid, int vec,
                                          int tid) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int cpr = cols / E;
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr;
      const int c = (i % cpr) * E;
      const bool ok = r < rvalid && c < cvalid;
      cp_async16(dst + r * lds + c, ok ? src + (long long)r * lsrc + c : src,
                 ok ? 16 : 0);
    }
    cp_async_wait_all();
  } else {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols;
      const int c = i % cols;
      dst[r * lds + c] = (r < rvalid && c < cvalid)
                             ? src[(long long)r * lsrc + c]
                             : from_f32<T>(0.f);
    }
  }
}

// Starts the copy of a walked tile: with vec, kChunks cp.async groups split
// along d (D_ROWS: a w tile [DP, cols] by rows; else an x tile [rows, DP] by
// columns), zero-filled past rvalid / cvalid as load_tile does; without vec
// the whole tile, synchronously.  The caller's score_tile waits and
// publishes.
template <typename T, int DP, bool D_ROWS>
__device__ __forceinline__ void fetch_tile(T* dst, int lds, const T* src,
                                           long long lsrc, int rows, int cols,
                                           int rvalid, int cvalid, int vec,
                                           int tid) {
  if (!vec) {
    load_tile<T>(dst, lds, src, lsrc, rows, cols, rvalid, cvalid, 0, tid);
    return;
  }
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CH = DP / kChunks;
  static_assert(CH % 16 == 0, "a slice is whole k-steps");
  const int nr = D_ROWS ? CH : rows;
  const int cpr = (D_ROWS ? cols : CH) / E;
  for (int ch = 0; ch < kChunks; ++ch) {
    const int rb = D_ROWS ? ch * CH : 0;
    const int cb = D_ROWS ? 0 : ch * CH;
    for (int i = tid; i < nr * cpr; i += kThreads) {
      const int r = rb + i / cpr;
      const int c = cb + (i % cpr) * E;
      const bool ok = r < rvalid && c < cvalid;
      cp_async16(dst + r * lds + c, ok ? src + (long long)r * lsrc + c : src,
                 ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// A 16x16 f32 accumulator tile: a tensor-core fragment for bf16 inputs; for
// f32 inputs (plain FMAs) lane l holds rows 2(l/4) + {0,1}, columns
// 4(l%4) + {0..3}.
template <typename T>
struct Acc;
template <>
struct Acc<__nv_bfloat16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
};
template <>
struct Acc<float> {
  float v[8];
};

template <typename T, int FM, int FN>
__device__ __forceinline__ void acc_zero(Acc<T> (&c)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if constexpr (is_bf16<T>()) {
        wmma::fill_fragment(c[i][j].f, 0.0f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) c[i][j].v[e] = 0.f;
      }
    }
}

// c[i][j] += A(m0 + 16 i .., 0:K) . B(0:K, n0 + 16 j ..), operands in shared
// memory, K a multiple of 16.  ACOL: A(m, k) = A[k * lda + m], else
// A[m * lda + k]; BCOL: B(k, n) = B[n * ldb + k], else B[k * ldb + n].  Each
// k-step loads the FM A fragments once and serves all FN columns with them.
template <typename T, int FM, int FN, bool ACOL, bool BCOL>
__device__ __forceinline__ void warp_mma(Acc<T> (&c)[FM][FN], const T* A,
                                         int lda, const T* B, int ldb, int m0,
                                         int n0, int K, int lane) {
  if constexpr (is_bf16<T>()) {
    using LayA = typename std::conditional<ACOL, wmma::col_major,
                                           wmma::row_major>::type;
    using LayB = typename std::conditional<BCOL, wmma::col_major,
                                           wmma::row_major>::type;
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayA> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = m0 + 16 * i;
        wmma::load_matrix_sync(
            a[i], ACOL ? A + k0 * lda + m : A + m * lda + k0, lda);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = n0 + 16 * j;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayB> b;
        wmma::load_matrix_sync(b, BCOL ? B + n * ldb + k0 : B + k0 * ldb + n,
                               ldb);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(c[i][j].f, a[i], b, c[i][j].f);
      }
    }
  } else {
    const int ri = (lane >> 2) * 2;
    const int ci = (lane & 3) * 4;
    for (int kk = 0; kk < K; ++kk) {
      float a[FM][2], b[FN][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + 16 * i + ri + r;
          a[i][r] = ACOL ? A[kk * lda + m] : A[m * lda + kk];
        }
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + 16 * j + ci + q;
          b[j][q] = BCOL ? B[n * ldb + kk] : B[kk * ldb + n];
        }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              c[i][j].v[r * 4 + q] += a[i][r] * b[j][q];
    }
  }
}

// C[m0 + 16 i .., n0 + 16 j ..] = c[i][j], C row-major f32 (pitch ldc)
template <typename T, int FM, int FN>
__device__ __forceinline__ void acc_store(float* C, int ldc,
                                          Acc<T> (&c)[FM][FN], int m0, int n0,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      float* dst = C + (m0 + 16 * i) * ldc + n0 + 16 * j;
      if constexpr (is_bf16<T>()) {
        wmma::store_matrix_sync(dst, c[i][j].f, ldc, wmma::mem_row_major);
      } else {
        const int ri = (lane >> 2) * 2;
        const int ci = (lane & 3) * 4;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[(ri + r) * ldc + ci + q] = c[i][j].v[r * 4 + q];
      }
    }
}

// Ss[BM, BV] = Xs[BM, DP] . Ws[DP, BV]: each active warp owns F score tiles
// side by side and keeps them in fragments over the whole d loop, which
// runs in kChunks slices as the walked tile's copy (fetch_tile) lands.
// Every thread takes part in the barriers.
template <typename T, int BM, int BV, int DP>
__device__ __forceinline__ void score_tile(float* Ss, const T* Xs,
                                           const T* Ws, int vec, int warp,
                                           int lane) {
  constexpr int LDX = DP + pad_of<T>(), LDW = BV + pad_of<T>();
  constexpr int LDS = BV + kPadF;
  constexpr int units = (BM / 16) * (BV / 16);
  constexpr int F = units > kWarps ? units / kWarps : 1;
  constexpr int CG = (BV / 16) / F;
  constexpr int CH = DP / kChunks;
  static_assert(units % F == 0 && (BV / 16) % F == 0, "score tiling");
  const bool active = warp < units / F;
  const int m0 = (warp / CG) * 16;
  const int n0 = (warp % CG) * 16 * F;
  Acc<T> c[1][F];
  acc_zero(c);
#pragma unroll 1
  for (int ch = 0; ch < kChunks; ++ch) {
    if (vec) cp_async_wait_pending(kChunks - 1 - ch);
    __syncthreads();  // slice ch of the walked tile is in for every thread
    if (active)
      warp_mma<T, 1, F, false, false>(c, Xs + ch * CH, LDX,
                                      Ws + ch * CH * LDW, LDW, m0, n0, CH,
                                      lane);
  }
  if (active) acc_store(Ss, LDS, c, m0, n0, lane);
}

// ds = (exp(s - lse) - onehot) * g, rounded to T; zero past N and past V
template <typename T, int BM, int BV>
__device__ __forceinline__ void ds_tile(T* dSs, const float* Ss,
                                        const float* lse_s, const float* g_s,
                                        const int* y_s, int r0, int v0, int N,
                                        int V, int tid) {
  constexpr int LDS = BV + kPadF, LDP = BV + pad_of<T>();
  for (int i = tid; i < BM * BV; i += kThreads) {
    const int r = i / BV, c = i % BV;
    const int col = v0 + c;
    float ds = 0.f;
    if (col < V && r0 + r < N) {
      const float p = expf(Ss[r * LDS + c] - lse_s[r]);
      ds = (p - (col == y_s[r] ? 1.f : 0.f)) * g_s[r];
    }
    dSs[r * LDP + c] = from_f32<T>(ds);
  }
}

// the per-row statistics of rows [r0, r0 + BM): lse, g, label (-1 past N)
template <int BM>
__device__ __forceinline__ void load_stats(float* lse_s, float* g_s, int* y_s,
                                           const float* lse, const float* g,
                                           const int* y, int r0, int N,
                                           int tid) {
  if (tid < BM) {
    const int row = r0 + tid;
    const bool ok = row < N;
    lse_s[tid] = ok ? lse[row] : 0.f;
    g_s[tid] = ok ? g[row] : 0.f;
    y_s[tid] = ok ? y[row] : -1;
  }
}

template <typename T, int DP>
constexpr size_t fwd_smem_bytes() {
  constexpr int BM = Cfg<T>::FWD_BM, BV = Cfg<T>::FWD_BV;
  return sizeof(T) * (size_t)(BM * (DP + pad_of<T>()) +
                              DP * (BV + pad_of<T>())) +
         sizeof(float) * (size_t)(BM * (BV + kPadF));
}

template <typename T, int DP, int BM, int BV>
constexpr size_t bwd_smem_bytes() {
  return sizeof(T) * (size_t)(BM * (DP + pad_of<T>()) +
                              DP * (BV + pad_of<T>()) +
                              BM * (BV + pad_of<T>())) +
         sizeof(float) * (size_t)(BM * (BV + kPadF) + 2 * BM) +
         sizeof(int) * (size_t)BM;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ y, float* __restrict__ loss,
                  float* __restrict__ lse, int N, int D, int V, int vec) {
  constexpr int BM = Cfg<T>::FWD_BM, BV = Cfg<T>::FWD_BV;
  constexpr int LDX = DP + pad_of<T>(), LDW = BV + pad_of<T>();
  constexpr int LDS = BV + kPadF;
  constexpr int RPW = BM / kWarps;  // epilogue rows a warp
  constexpr int CPL = BV / 32;      // epilogue columns a lane
  static_assert(RPW >= 1 && CPL >= 1, "forward tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);                 // [BM, LDX]
  T* Ws = Xs + BM * LDX;                                  // [DP, LDW]
  float* Ss = reinterpret_cast<float*>(Ws + DP * LDW);    // [BM, LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BM;
  load_tile<T>(Xs, LDX, x + (long long)r0 * D, D, BM, DP, N - r0, D, vec,
               tid);
  // running max, sum and this lane's share of the picked logit, per row;
  // every lane of the warp holds the same m and l
  float m[RPW], l[RPW], pick[RPW];
  int yr[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    pick[i] = 0.f;
    yr[i] = row < N ? y[row] : -1;
  }
  const int nvt = (V + BV - 1) / BV;
  if (vec) fetch_tile<T, DP, true>(Ws, LDW, w, V, DP, BV, D, V, vec, tid);
  for (int vt = 0; vt < nvt; ++vt) {
    const int v0 = vt * BV;
    // without vec the copy is synchronous: Ws is free (the barrier after
    // the last score product), and score_tile publishes it
    if (!vec) fetch_tile<T, DP, true>(Ws, LDW, w + v0, V, DP, BV, D, V - v0,
                                      vec, tid);
    score_tile<T, BM, BV, DP>(Ss, Xs, Ws, vec, warp, lane);
    __syncthreads();  // Ss is whole and nobody reads Ws any more
    // the next tile's copy runs under this tile's softmax epilogue
    if (vec && vt + 1 < nvt)
      fetch_tile<T, DP, true>(Ws, LDW, w + v0 + BV, V, DP, BV, D,
                              V - v0 - BV, vec, tid);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float s[CPL];
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = v0 + lane + 32 * c;
        s[c] = col < V ? Ss[r * LDS + lane + 32 * c] : -INFINITY;
        tmax = fmaxf(tmax, s[c]);
        if (col < V && col == yr[i]) pick[i] += s[c];
      }
      const float m2 = fmaxf(m[i], warp_max(tmax));
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) ps += expf(s[c] - m2);
      l[i] = l[i] * expf(m[i] - m2) + warp_sum(ps);
      m[i] = m2;
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    const float pk = warp_sum(pick[i]);
    if (lane == 0 && row < N) {
      const float L = m[i] + logf(l[i]);
      lse[row] = L;
      loss[row] = L - pk;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    ce_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ y, const float* __restrict__ lse,
                 const float* __restrict__ g, T* __restrict__ dx, int N, int D,
                 int V, int vec) {
  constexpr int BM = Cfg<T>::DX_BM, BV = Cfg<T>::DX_BV;
  constexpr int LDX = DP + pad_of<T>(), LDW = BV + pad_of<T>();
  constexpr int LDS = BV + kPadF, LDP = BV + pad_of<T>(), LDO = DP + kPadF;
  constexpr int FMX = BM / 16, FNX = DP / (16 * kWarps);
  static_assert(DP % (16 * kWarps) == 0, "dx tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);                 // [BM, LDX]
  T* Ws = Xs + BM * LDX;                                  // [DP, LDW]
  T* dSs = Ws + DP * LDW;                                 // [BM, LDP]
  float* Ss = reinterpret_cast<float*>(dSs + BM * LDP);   // [BM, LDS]
  float* lse_s = Ss + BM * LDS;
  float* g_s = lse_s + BM;
  int* y_s = reinterpret_cast<int*>(g_s + BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BM;
  load_tile<T>(Xs, LDX, x + (long long)r0 * D, D, BM, DP, N - r0, D, vec,
               tid);
  load_stats<BM>(lse_s, g_s, y_s, lse, g, y, r0, N, tid);
  // warp w owns dx columns [16 FNX w, 16 FNX (w + 1)) of all BM rows
  const int n0x = warp * 16 * FNX;
  Acc<T> cx[FMX][FNX];
  acc_zero(cx);
  const int nvt = (V + BV - 1) / BV;
  for (int vt = 0; vt < nvt; ++vt) {
    const int v0 = vt * BV;
    __syncthreads();  // the last tile's dx product has read Ws and dSs
    fetch_tile<T, DP, true>(Ws, LDW, w + v0, V, DP, BV, D, V - v0, vec, tid);
    score_tile<T, BM, BV, DP>(Ss, Xs, Ws, vec, warp, lane);
    __syncthreads();
    ds_tile<T, BM, BV>(dSs, Ss, lse_s, g_s, y_s, r0, v0, N, V, tid);
    __syncthreads();
    // dx += ds . w_tile^T: B(k = vocab, n = d) = Ws[d, vocab]
    warp_mma<T, FMX, FNX, false, true>(cx, dSs, LDP, Ws, LDW, 0, n0x, BV,
                                       lane);
  }
  __syncthreads();  // the operand tiles are dead: stage dx over them
  float* Os = reinterpret_cast<float*>(smem_raw);         // [BM, LDO]
  acc_store(Os, LDO, cx, 0, n0x, lane);
  __syncthreads();
  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (r0 + r < N) dx[(long long)(r0 + r) * D + c] = from_f32<T>(Os[r * LDO + c]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    ce_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ y, const float* __restrict__ lse,
                 const float* __restrict__ g, T* __restrict__ dw, int N, int D,
                 int V, int vec) {
  constexpr int BM = Cfg<T>::DW_BM, BV = Cfg<T>::DW_BV;
  constexpr int LDX = DP + pad_of<T>(), LDW = BV + pad_of<T>();
  constexpr int LDS = BV + kPadF, LDP = BV + pad_of<T>(), LDO = BV + kPadF;
  constexpr int FMW = DP / (16 * kWarps), FNW = BV / 16;
  static_assert(DP % (16 * kWarps) == 0, "dW tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Ws = reinterpret_cast<T*>(smem_raw);                 // [DP, LDW]
  T* Xs = Ws + DP * LDW;                                  // [BM, LDX]
  T* dSs = Xs + BM * LDX;                                 // [BM, LDP]
  float* Ss = reinterpret_cast<float*>(dSs + BM * LDP);   // [BM, LDS]
  float* lse_s = Ss + BM * LDS;
  float* g_s = lse_s + BM;
  int* y_s = reinterpret_cast<int*>(g_s + BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int v0 = blockIdx.x * BV;
  load_tile<T>(Ws, LDW, w + v0, V, DP, BV, D, V - v0, vec, tid);
  // warp w owns dW rows [16 FMW w, 16 FMW (w + 1)) of all BV columns
  const int m0w = warp * 16 * FMW;
  Acc<T> cw[FMW][FNW];
  acc_zero(cw);
  const int nrt = (N + BM - 1) / BM;
  for (int rt = 0; rt < nrt; ++rt) {
    const int r0 = rt * BM;
    __syncthreads();  // the last tile's dW product has read Xs and dSs
    fetch_tile<T, DP, false>(Xs, LDX, x + (long long)r0 * D, D, BM, DP,
                             N - r0, D, vec, tid);
    load_stats<BM>(lse_s, g_s, y_s, lse, g, y, r0, N, tid);
    score_tile<T, BM, BV, DP>(Ss, Xs, Ws, vec, warp, lane);
    __syncthreads();
    ds_tile<T, BM, BV>(dSs, Ss, lse_s, g_s, y_s, r0, v0, N, V, tid);
    __syncthreads();
    // dW += x_tile^T . ds: A(m = d, k = row) = Xs[row, d]
    warp_mma<T, FMW, FNW, true, false>(cw, Xs, LDX, dSs, LDP, m0w, 0, BM,
                                       lane);
  }
  __syncthreads();  // the operand tiles are dead: stage dW over them
  float* Os = reinterpret_cast<float*>(smem_raw);         // [DP, LDO]
  acc_store(Os, LDO, cw, m0w, 0, lane);
  __syncthreads();
  for (int i = tid; i < D * BV; i += kThreads) {
    const int r = i / BV, c = i % BV;
    if (v0 + c < V) dw[(long long)r * V + v0 + c] = from_f32<T>(Os[r * LDO + c]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int vec_ok(const void* x, const void* w, int D, int V) {
  const int E = 16 / (int)sizeof(T);
  return D % E == 0 && V % E == 0 && aligned16(x) && aligned16(w);
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DP>
int launch_fwd(const void* x, const void* w, const void* y, void* loss,
               void* lse, int N, int D, int V, cudaStream_t st) {
  constexpr size_t smem = fwd_smem_bytes<T, DP>();
  static_assert(smem <= 232448, "forward shared memory");
  auto kern = ce_fwd_kernel<T, DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((N + Cfg<T>::FWD_BM - 1) / Cfg<T>::FWD_BM);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(y), static_cast<float*>(loss),
      static_cast<float*>(lse), N, D, V, vec_ok<T>(x, w, D, V));
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dx(const void* x, const void* w, const void* y, const void* lse,
              const void* g, void* dx, int N, int D, int V, cudaStream_t st) {
  constexpr size_t smem =
      bwd_smem_bytes<T, DP, Cfg<T>::DX_BM, Cfg<T>::DX_BV>();
  static_assert(smem <= 232448, "dx shared memory");
  auto kern = ce_dx_kernel<T, DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((N + Cfg<T>::DX_BM - 1) / Cfg<T>::DX_BM);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(y), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<T*>(dx), N, D, V,
      vec_ok<T>(x, w, D, V));
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dw(const void* x, const void* w, const void* y, const void* lse,
              const void* g, void* dw, int N, int D, int V, cudaStream_t st) {
  constexpr size_t smem =
      bwd_smem_bytes<T, DP, Cfg<T>::DW_BM, Cfg<T>::DW_BV>();
  static_assert(smem <= 232448, "dW shared memory");
  auto kern = ce_dw_kernel<T, DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((V + Cfg<T>::DW_BV - 1) / Cfg<T>::DW_BV);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(y), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<T*>(dw), N, D, V,
      vec_ok<T>(x, w, D, V));
  return (int)cudaGetLastError();
}

bool geom_ok(int N, int D, int V) {
  return N >= 1 && D >= 1 && D <= 768 && V >= 1;
}

}  // namespace

// All entry points launch on `stream`, allocate nothing and return the
// cudaError_t of the launch (0 on success).  dtype: 0 = float32,
// 1 = bfloat16, for x and w alike.  x [N, D] and w [D, V] row-major, y [N]
// int32, lse and g [N] float32; loss, lse (forward) and dx [N, D] / dW [D, V]
// (input dtype) are written whole.  The wrapper
// (paddle_tpu_torch/kernels/fused_ce.py) checks shapes, dtypes and
// contiguity and allocates every output.

#define CE_DISPATCH(LAUNCH, ...)                                       \
  do {                                                                 \
    if (!geom_ok(N, D, V)) return (int)cudaErrorInvalidValue;          \
    cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    if (dtype == 0)                                                    \
      return D <= 256 ? LAUNCH<float, 256>(__VA_ARGS__, N, D, V, st)   \
                      : LAUNCH<float, 768>(__VA_ARGS__, N, D, V, st);  \
    if (dtype == 1)                                                    \
      return D <= 256                                                  \
                 ? LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__, N, D, V, st) \
                 : LAUNCH<__nv_bfloat16, 768>(__VA_ARGS__, N, D, V, st); \
    return (int)cudaErrorInvalidValue;                                 \
  } while (0)

extern "C" int fused_ce_fwd(const void* x, const void* w, const void* y,
                            void* loss, void* lse, int N, int D, int V,
                            int dtype, void* stream) {
  CE_DISPATCH(launch_fwd, x, w, y, loss, lse);
}

extern "C" int fused_ce_dx(const void* x, const void* w, const void* y,
                           const void* lse, const void* g, void* dx, int N,
                           int D, int V, int dtype, void* stream) {
  CE_DISPATCH(launch_dx, x, w, y, lse, g, dx);
}

extern "C" int fused_ce_dw(const void* x, const void* w, const void* y,
                           const void* lse, const void* g, void* dw, int N,
                           int D, int V, int dtype, void* stream) {
  CE_DISPATCH(launch_dw, x, w, y, lse, g, dw);
}

extern "C" const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
