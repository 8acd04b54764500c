// Paged attention over the serving block table: a hand-written kernel for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces paddle_tpu/kernels/paged_attention.py: paged_attention_pallas
// (the TPU kernel: a sequential (S, NB) grid whose scalar-prefetched block
// table feeds the K/V BlockSpec index maps, with the online-softmax state
// carried across grid steps in VMEM scratch).  Blocks of a CUDA grid run in
// parallel and in no order, so the chain walk moves INSIDE the block: one
// thread block owns one (slot s, query w, head) row, reads table[s, nb]
// itself (in place of scalar prefetch) and keeps (m, l, acc[dh]) in f32 in
// registers and shared memory for the whole walk.
//
//   q      [S, W, H, DH]          bf16 or f32, contiguous
//   pool_k [num_blocks, B, H, DH] same dtype (one layer's physical pool)
//   pool_v [num_blocks, B, H, DH]
//   table  [S, NB] int32          physical block of each chain entry
//   pos    [S, W] int32           key token j counts iff j <= pos[s, w]
//   out    [S, W, H, DH]          q's dtype
//
// Masking: the walk stops at the last chain entry holding a token <= pos,
// and inside that entry reads only the keys <= pos.  Entries beyond pos
// (the trash block 0, bucket padding, a CoW tail) are never read at all,
// where the JAX versions multiply them by p = 0: garbage there may be
// non-finite, and 0 * inf is NaN.  The l == 0 -> 1 guard and the cast to
// q's dtype close the row, as in the JAX kernel.
//
// Bound on the H100 (3.35 TB/s HBM): memory.  The work reads each live key
// and value once, sum_s (pos_s + 1) * H * DH * 2 * sizeof(dtype) bytes, and
// does 4 flops per element read; at the decode shape (S=32, H=6, DH=128,
// B=32, bf16, pos up to 511) that is ~25 MB, ~7.5 us a layer-step.  This
// first kernel is the simple correct design: 128 threads per row, one
// warp per key for the q.k dot product (shuffle reduction over DH), then
// one thread per output element for p.V.  It does not split the chain
// across blocks (flash-decoding), so at decode only S*H = 192 rows are in
// flight and each walks its chain serially; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, T* __restrict__ out,
                       int W, int H, int DH, int B, int NB, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;       // [DH] the query row in f32
  float* acc = qs + DH;   // [DH] unnormalised output, f32
  float* sc = acc + DH;   // [B] scores of the chain entry in flight
  float* pr = sc + B;     // [B] their probabilities

  const int head = blockIdx.x % H;
  const int sw = blockIdx.x / H;  // s * W + w
  const int s = sw / W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int64_t row = ((int64_t)sw * H + head) * DH;
  for (int d = tid; d < DH; d += kThreads) {
    qs[d] = to_f32(q[row + d]);
    acc[d] = 0.f;
  }
  const int p = pos[sw];
  const int nblk = p < 0 ? 0 : min(NB, p / B + 1);
  float m = kNegInf;
  float l = 0.f;
  __syncthreads();

  for (int nb = 0; nb < nblk; ++nb) {
    const int64_t base = (int64_t)table[(int64_t)s * NB + nb] * B;
    const int nvalid = min(B, p - nb * B + 1);
    // scores: one warp per key, lanes stride DH, shuffle reduction
    for (int b = warp; b < nvalid; b += kWarps) {
      const T* kr = pool_k + ((base + b) * H + head) * DH;
      float part = 0.f;
      for (int d = lane; d < DH; d += 32) part += qs[d] * to_f32(kr[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sc[b] = part * scale;
    }
    __syncthreads();
    // online softmax: every thread folds the same (m, l) redundantly
    float bmax = kNegInf;
    for (int b = 0; b < nvalid; ++b) bmax = fmaxf(bmax, sc[b]);
    const float m2 = fmaxf(m, bmax);
    const float alpha = expf(m - m2);
    for (int b = tid; b < nvalid; b += kThreads) pr[b] = expf(sc[b] - m2);
    __syncthreads();
    float psum = 0.f;
    for (int b = 0; b < nvalid; ++b) psum += pr[b];
    l = l * alpha + psum;
    m = m2;
    // p.V: one thread per output element, neighbours on neighbouring
    // addresses of each value row
    for (int d = tid; d < DH; d += kThreads) {
      float a = acc[d] * alpha;
      const T* vc = pool_v + (base * H + head) * DH + d;
      for (int b = 0; b < nvalid; ++b)
        a += pr[b] * to_f32(vc[(int64_t)b * H * DH]);
      acc[d] = a;
    }
    __syncthreads();  // sc and pr are rewritten by the next chain entry
  }

  const float l_safe = l == 0.f ? 1.f : l;
  for (int d = tid; d < DH; d += kThreads) store(out + row + d, acc[d] / l_safe);
}

}  // namespace

// Launches on `stream`, allocates nothing, returns the cudaError_t of the
// launch (0 on success).  dtype: 0 = float32, 1 = bfloat16.  The wrapper
// (paddle_tpu_torch/kernels/paged_attention.py) checks shapes, dtypes and
// contiguity; table entries must name blocks of the pool and B, DH must
// each be at most 1024 (shared memory is (2 * DH + 2 * B) floats).
extern "C" int paged_attention_fwd(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* pos, void* out, int S, int W,
                                   int H, int DH, int B, int NB, float scale,
                                   int dtype, void* stream) {
  const long long rows = (long long)S * W * H;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL || DH < 1 || DH > 1024 || B < 1 || B > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)DH + 2 * (size_t)B) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0) {
    paged_attention_kernel<float><<<(unsigned)rows, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool_k),
        static_cast<const float*>(pool_v), tbl, ps, static_cast<float*>(out),
        W, H, DH, B, NB, scale);
  } else if (dtype == 1) {
    paged_attention_kernel<__nv_bfloat16>
        <<<(unsigned)rows, kThreads, smem, st>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(pool_k),
            static_cast<const __nv_bfloat16*>(pool_v), tbl, ps,
            static_cast<__nv_bfloat16*>(out), W, H, DH, B, NB, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
