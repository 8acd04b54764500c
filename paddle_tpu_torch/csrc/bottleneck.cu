// Fused ResNet bottleneck block, forward, inference form (batch norm folded
// into a per-channel f32 scale and shift): a hand-written kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces benchmarks/bottleneck_pallas.py: make_fused (the TPU kernel, a
// pallas_call over a (batch, row band) grid whose body keeps both mid
// activations in VMEM).  For each output pixel of x [N, H, W, Cin] (NHWC):
//
//   y1  = relu((x . w1) * s1 + b1)                 w1 [Cin, Cm]
//         accumulated in f32, then ROUNDED to the input type;
//   y2  = relu(conv3x3_SAME(y1, w2) * s2 + b2)     w2 [3, 3, Cm, Cm] (HWIO)
//         accumulated in f32, then ROUNDED to the input type; neighbours
//         outside the image (above, below, left, right) are zero;
//   out = relu((y2 . w3) * s3 + b3 + x)            w3 [Cm, Cout], Cout == Cin
//         in f32, then cast to the input type.
//
// The two rounding points are part of the function (the Pallas body and the
// composed reference both round there).  Element types: float and bf16, one
// type for x, the weights and out; the scales and shifts are f32.
//
// Design.  One thread block owns one band of `band` output rows of one image
// (blockIdx.x = band, blockIdx.y = image) and every column of it; the last
// band of an image may be shorter (H need not divide by the band height) and
// writes only its own rows, so no output is left unwritten.  Unlike the TPU
// kernel, which is handed x three times because a BlockSpec cannot express
// overlapping bands, a block reads its halo rows directly from x.
//   1. conv1 over the band's rows and the row above and below it: y1 for
//      (band + 2) x W pixels x Cm channels lives in shared memory in the
//      input type (at the script's shape, bf16, band 8: 10 x 56 x 64 x 2 =
//      71,680 B).  The band of x itself (10 x 56 x 256 x 2 = 286,720 B) does
//      not fit in the 227 KB a block may take, so conv1 streams x in chunks
//      of 32 input channels.  Halo rows outside the image are zeros of y1
//      (the SAME padding of conv2).
//   2. For each tile of 64 output pixels: conv2 as one product over the
//      nine shifted copies of y1 in shared memory (K = 9 Cm; a shifted
//      column outside the row reads zero), the rounded y2 tile [64, Cm] in
//      shared memory; then conv3 and
//      the epilogue (scale, shift, the residual x read from device memory,
//      relu) straight to out.  No mid activation reaches device memory.
// Each product is a tile GEMM: 256 threads compute a 64 x 64 output tile
// over operand chunks of 32 reduction steps staged in shared memory; the
// weights stream from L2 chunk by chunk.  Two spellings of the tile:
//   * bf16 with every channel count a multiple of 8 and 16-byte aligned
//     tensors (the ResNet shapes): tensor cores, through WMMA 16x16x16 bf16
//     fragments with f32 accumulators (each warp owns a 16 x 32 slice of
//     the tile); operands are staged in bf16 by 16-byte vector copies, and
//     the f32 tile goes through shared memory once for the epilogue;
//   * otherwise (f32, odd channel counts): f32 FMA on the CUDA cores, each
//     thread a 4 x 4 block, operands staged as f32 (A transposed, so a
//     thread reads its four rows as one float4).
// Both hand each thread the same 4 x 4 block of the f32 tile, so the
// epilogues (scale, shift, relu, rounding, residual) are one code.
// The band height is the largest <= 8 whose shared memory fits (8 for bf16
// at Cm = 64, W = 56: 107,008 B, two blocks an SM).
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes.  At the script's
// shape (N = 128, 56 x 56, 256 -> 64 -> 256, bf16) x is read and out written
// once, 2 x 205,520,896 B = 0.1227 ms, against 55.9 GFLOP = 0.0565 ms on the
// tensor cores.  The kernel recomputes conv1 for the two halo rows (band + 2
// rows for band rows), reads each halo row of x once more and stages every
// operand chunk through shared memory between two barriers, with no copy
// in flight under the products: that staging, not the tensor cores, bounds
// it.  wgmma with TMA-fed operand rings is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // a 16 x 16 grid of threads, 8 warps
constexpr int MT = 64;         // pixels of a GEMM tile
constexpr int NT = 64;         // channels of a GEMM tile
constexpr int KC = 32;         // reduction chunk staged in shared memory
constexpr int kMaxBand = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may take
// FMA staging: A transposed [KC][kPadA] f32, B [KC][NT] f32
constexpr int kPadA = MT + 4;
// tensor-core staging: A [MT][kLdA] bf16, B [KC][kLdB] bf16, C [MT][kLdC]
// f32 (row strides padded against bank conflicts, multiples of 8 elements
// as WMMA asks, every fragment 32-byte aligned)
constexpr int kLdA = KC + 8, kLdB = NT + 8, kLdC = NT + 4;

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

template <bool TC>
__host__ __device__ constexpr size_t staging_bytes() {
  return TC ? align128(sizeof(bf16) * MT * kLdA) +
                  align128(sizeof(bf16) * KC * kLdB) +
                  align128(sizeof(float) * MT * kLdC)
            : align128(sizeof(float) * KC * kPadA) +
                  align128(sizeof(float) * KC * NT);
}

// Shared memory of a block: y1 [(band + 2) * W][Cm] T | staging | y2 tile
// [MT][Cm] T.
template <bool TC>
size_t smem_bytes(int band, int W, int Cm, size_t elem) {
  return align128((size_t)(band + 2) * W * Cm * elem) + staging_bytes<TC>() +
         align128((size_t)MT * Cm * elem);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// One 64 x 64 tile of C = A . B over K, for the calling thread's 4 x 4 block
// acc[a][b] = C[ty*4 + a][tx*4 + b].  a_ptr(i, k) points at A's element
// (tile row i, reduction index k) or is null for a zero; B is the row-major
// [K, N] weight `w` at columns n0 ..; K and N are its true sizes (rows and
// columns past them are zeros).  TC: k, and so K and N, are multiples of 8
// and every pointer is 16-byte aligned at such k.
template <typename T, bool TC, typename APtr>
__device__ __forceinline__ void tile_gemm(unsigned char* stage, APtr a_ptr,
                                          const T* __restrict__ w, int K,
                                          int N, int n0, float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if constexpr (TC) {
    bf16* As = reinterpret_cast<bf16*>(stage);
    bf16* Bs = reinterpret_cast<bf16*>(stage +
                                       align128(sizeof(bf16) * MT * kLdA));
    float* Cs = reinterpret_cast<float*>(
        stage + align128(sizeof(bf16) * MT * kLdA) +
        align128(sizeof(bf16) * KC * kLdB));
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
    wmma::fill_fragment(c[0], 0.f);
    wmma::fill_fragment(c[1], 0.f);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int k0 = 0; k0 < K; k0 += KC) {
      {  // A: MT rows x KC/8 vectors of 8 bf16, one a thread
        const int i = tid >> 2, k = k0 + (tid & 3) * 8;
        const T* p = k < K ? a_ptr(i, k) : nullptr;
        *reinterpret_cast<uint4*>(As + i * kLdA + (tid & 3) * 8) =
            p ? *reinterpret_cast<const uint4*>(p) : zero;
      }
      {  // B: KC rows x NT/8 vectors, one a thread
        const int r = tid >> 3, j = n0 + (tid & 7) * 8, k = k0 + r;
        *reinterpret_cast<uint4*>(Bs + r * kLdB + (tid & 7) * 8) =
            (k < K && j < N)
                ? __ldg(reinterpret_cast<const uint4*>(w + (long long)k * N +
                                                       j))
                : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + wm * 16 * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, Bs + kk * kLdB + wn * 32 + j * 16, kLdB);
          wmma::mma_sync(c[j], fa, fb, c[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + wm * 16 * kLdC + wn * 32 + j * 16, c[j],
                              kLdC, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 v =
          *reinterpret_cast<const float4*>(Cs + (ty * 4 + a) * kLdC + tx * 4);
      acc[a][0] = v.x;
      acc[a][1] = v.y;
      acc[a][2] = v.z;
      acc[a][3] = v.w;
    }
  } else {
    float* At = reinterpret_cast<float*>(stage);
    float* Bt = reinterpret_cast<float*>(
        stage + align128(sizeof(float) * KC * kPadA));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      for (int e = tid; e < MT * KC; e += kThreads) {
        const int i = e / KC, k = k0 + e % KC;
        const T* p = k < K ? a_ptr(i, k) : nullptr;
        At[(e % KC) * kPadA + i] = p ? to_f(*p) : 0.f;
      }
      for (int e = tid; e < KC * NT; e += kThreads) {
        const int k = k0 + e / NT, j = n0 + e % NT;
        Bt[e] = (k < K && j < N) ? to_f(__ldg(w + (long long)k * N + j)) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(At + k * kPadA + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Bt + k * NT + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
}

template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads, 2)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w3,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const float* __restrict__ s2, const float* __restrict__ b2,
                  const float* __restrict__ s3, const float* __restrict__ b3,
                  T* __restrict__ out, int H, int W, int Cin, int Cm,
                  int Cout, int band) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.x * band;
  const int rows = min(band, H - r0);  // a ragged last band is shorter
  const int M1 = (rows + 2) * W;       // y1 pixels: rows r0-1 .. r0+rows
  const int M2 = rows * W;             // output pixels of the band
  const long long img = (long long)blockIdx.y * H * W;  // pixel (n, 0, 0)
  T* y1 = reinterpret_cast<T*>(smem);
  unsigned char* stage =
      smem + align128((size_t)(band + 2) * W * Cm * sizeof(T));
  T* y2 = reinterpret_cast<T*>(stage + staging_bytes<TC>());
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];

  // 1. conv1 over the band and its halo rows, into y1 (rounded to T)
  for (int m0 = 0; m0 < M1; m0 += MT) {
    auto a_x = [&](int i, int k) -> const T* {
      const int m = m0 + i;
      if (m >= M1) return nullptr;
      const int g = r0 - 1 + m / W;
      if (g < 0 || g >= H) return nullptr;
      return x + (img + (long long)g * W + m % W) * Cin + k;
    };
    for (int n0 = 0; n0 < Cm; n0 += NT) {
      tile_gemm<T, TC>(stage, a_x, w1, Cin, Cm, n0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int m = m0 + ty * 4 + a;
        if (m >= M1) continue;
        const int g = r0 - 1 + m / W;
        const bool inside = g >= 0 && g < H;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = n0 + tx * 4 + b;
          if (c >= Cm) continue;
          const float y =
              inside ? fmaxf(acc[a][b] * __ldg(s1 + c) + __ldg(b1 + c), 0.f)
                     : 0.f;
          y1[m * Cm + c] = from_f<T>(y);
        }
      }
    }
  }
  __syncthreads();

  // 2. per tile of output pixels: conv2 into the y2 tile, then conv3 + out
  for (int m0 = 0; m0 < M2; m0 += MT) {
    // conv2 is one product over K = 9 Cm: w2 (HWIO) is the row-major
    // [9 Cm, Cm] matrix whose row tap * Cm + c is tap (dy, dx), input
    // channel c; A's column k is channel k % Cm of the pixel shifted by
    // that tap (a vector of 8 never straddles two taps: Cm % 8 == 0 there)
    auto a_y1 = [&](int i, int k) -> const T* {
      const int m = m0 + i, tap = k / Cm;
      if (m >= M2) return nullptr;
      const int col = m % W + tap % 3 - 1;
      if (col < 0 || col >= W) return nullptr;
      return y1 + ((m / W + tap / 3) * W + col) * Cm + k % Cm;
    };
    for (int n0 = 0; n0 < Cm; n0 += NT) {
      tile_gemm<T, TC>(stage, a_y1, w2, 9 * Cm, Cm, n0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = n0 + tx * 4 + b;
          if (c < Cm)
            y2[(ty * 4 + a) * Cm + c] = from_f<T>(
                fmaxf(acc[a][b] * __ldg(s2 + c) + __ldg(b2 + c), 0.f));
        }
      }
    }
    __syncthreads();
    auto a_y2 = [&](int i, int k) -> const T* { return y2 + i * Cm + k; };
    for (int n0 = 0; n0 < Cout; n0 += NT) {
      tile_gemm<T, TC>(stage, a_y2, w3, Cm, Cout, n0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int m = m0 + ty * 4 + a;
        if (m >= M2) continue;
        const long long pix = img + (long long)(r0 + m / W) * W + m % W;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = n0 + tx * 4 + b;
          if (c >= Cout) continue;
          const float v = acc[a][b] * __ldg(s3 + c) + __ldg(b3 + c) +
                          to_f(x[pix * Cin + c]);
          out[pix * Cout + c] = from_f<T>(fmaxf(v, 0.f));
        }
      }
    }
    __syncthreads();
  }
}

// The band height for this geometry: the largest <= kMaxBand (and <= H)
// whose shared memory fits a block; 0 when not even one row fits.
template <bool TC>
int pick_band(int H, int W, int Cm, size_t elem) {
  for (int band = H < kMaxBand ? H : kMaxBand; band >= 1; --band)
    if (smem_bytes<TC>(band, W, Cm, elem) <= kMaxSmem) return band;
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tensor-core spelling takes bf16 with every channel count a multiple
// of 8 and 16-byte aligned tensors; anything else the FMA spelling.
bool use_tc(int dtype, int Cin, int Cm, const void* const* ptrs, int n) {
  if (dtype != 1 || Cin % 8 || Cm % 8) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

template <typename T, bool TC>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           const void* s1, const void* b1, const void* s2, const void* b2,
           const void* s3, const void* b3, void* out, int N, int H, int W,
           int Cin, int Cm, int Cout, cudaStream_t st) {
  const int band = pick_band<TC>(H, W, Cm, sizeof(T));
  if (band == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<TC>(band, W, Cm, sizeof(T));
  auto kern = bottleneck_kernel<T, TC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((H + band - 1) / band), (unsigned)N);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const float*>(s3), static_cast<const float*>(b3),
      static_cast<T*>(out), H, W, Cin, Cm, Cout, band);
  return (int)cudaGetLastError();
}

}  // namespace

// The band height the kernel takes for this geometry (0: it cannot run).
// dtype: 0 = float32, 1 = bfloat16; tc: 1 for the tensor-core spelling.
extern "C" int bottleneck_band_rows(int H, int W, int Cm, int dtype, int tc) {
  if (H < 1 || W < 1 || Cm < 1 || (dtype != 0 && dtype != 1)) return 0;
  const size_t elem = dtype == 0 ? 4 : 2;
  return tc ? pick_band<true>(H, W, Cm, elem) : pick_band<false>(H, W, Cm, elem);
}

// 1 when bottleneck_fwd takes the tensor-core spelling for these arguments.
extern "C" int bottleneck_uses_tensor_cores(const void* x, const void* w1,
                                            const void* w2, const void* w3,
                                            const void* out, int Cin, int Cm,
                                            int dtype) {
  const void* ptrs[] = {x, w1, w2, w3, out};
  return use_tc(dtype, Cin, Cm, ptrs, 5) ? 1 : 0;
}

// Launches on `stream`, allocates nothing, returns the cudaError_t of the
// launch (0 on success).  x and out [N, H, W, C] (C = Cin = Cout), w1
// [Cin, Cm], w2 [3, 3, Cm, Cm], w3 [Cm, Cout], all contiguous in one element
// type (dtype 0 = float32, 1 = bfloat16); s1, b1, s2, b2 [Cm] and s3, b3
// [Cout] float32.  out is written whole.  The wrapper
// (paddle_tpu_torch/kernels/bottleneck.py) checks shapes, dtypes, devices
// and contiguity and allocates out.
extern "C" int bottleneck_fwd(const void* x, const void* w1, const void* w2,
                              const void* w3, const void* s1, const void* b1,
                              const void* s2, const void* b2, const void* s3,
                              const void* b3, void* out, int N, int H, int W,
                              int Cin, int Cm, int Cout, int dtype,
                              void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cm < 1 || Cin != Cout ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, out,
                                N, H, W, Cin, Cm, Cout, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w1, w2, w3, out};
  if (use_tc(dtype, Cin, Cm, ptrs, 5))
    return launch<bf16, true>(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, out, N,
                              H, W, Cin, Cm, Cout, st);
  return launch<bf16, false>(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, out, N,
                             H, W, Cin, Cm, Cout, st);
}

extern "C" const char* bottleneck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
