// Paged attention over the serving block table: hand-written kernels for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces paddle_tpu/kernels/paged_attention.py: paged_attention_pallas
// (:161, its pallas_call at :238; the TPU kernel: a sequential (S, NB) grid
// whose scalar-prefetched block table feeds the K/V BlockSpec index maps,
// with the online-softmax state carried across grid steps in VMEM
// scratch).  Blocks of a CUDA grid run in parallel and in no order, so a
// block reads table[s, nb] itself (in place of scalar prefetch) and walks
// chain entries in a loop.
//
//   q      [S, W, H, DH]          bf16 or f32, contiguous
//   pool_k [num_blocks, B, H, DH] same dtype (one layer's physical pool)
//   pool_v [num_blocks, B, H, DH]
//   table  [S, NB] int32          physical block of each chain entry
//   pos    [S, W] int32           key token j counts iff j <= pos[s, w]
//   out    [S, W, H, DH]          q's dtype
//
// Masking: a block stops at the last chain entry holding a token <= pos,
// and inside that entry reads only the keys <= pos.  Entries beyond pos
// (the trash block 0, bucket padding, a CoW tail) are never read at all,
// where the JAX versions multiply them by p = 0: garbage there may be
// non-finite, and 0 * inf is NaN.  The l == 0 -> 1 guard and the cast to
// q's dtype close the row, as in the JAX kernel; a row with no live key
// (pos < 0) is zeros.
//
// Bound on the H100 (3.35 TB/s HBM): memory.  The work reads each live key
// and value once a slot, sum_s (max_w pos + 1) * H * DH * 2 * sizeof(dtype)
// bytes, and does 4 W flops per element read; at the decode shape (S=32,
// H=6, DH=128, B=32, bf16, pos up to 511) that is ~25 MB, ~7.5 us a
// layer-step.  Two families, chosen by the wrapper's static rule
// (paddle_tpu_torch/kernels/paged_attention.py: paged_family):
//
//   split   (flash-decoding; W <= 8, 16-byte rows of DH * sizeof(dtype) =
//           16 << k bytes up to 512, B <= 64, aligned pointers: every call
//           of the serving paths) paged_split_kernel: one block of 128
//           threads a (chain split, head, slot), owning ALL W queries of the
//           slot, so a K/V entry is read once a slot, not once a query.  A
//           split covers a fixed number of chain entries, a pure function of
//           the shapes chosen so the grid fills the card (paged_splits); a
//           split wholly past every row's pos exits at once.  Its entries
//           stream through a cp.async ring up to kRing entries deep (16
//           bytes a thread, keys past the slot's last pos zero-filled and
//           not read), the first table entries read beside the positions;
//           scores by lanes that each hold one 16-byte chunk of a key row
//           and of q, reduced over the row's lanes by shuffles; the online
//           softmax a warp a query row, lanes across the keys; p.V with
//           each thread owning one 16-byte column chunk, over a strided
//           subset of keys, its partial sums added in order at the end.
//           The split writes (acc, m, l) of each row to an f32 workspace
//           [S, W, H, splits, DH + 2] (a split past every pos only (-inf,
//           0)); paged_merge_kernel (a warp a row) merges the splits in
//           split order, its loads issued before the scales they are
//           weighed by: the result is the same bits from run to run.  Four
//           block barriers a chain entry; the work a block does in order
//           grows with W (measured on the H100: 19 us at W=1, 38 us at W=6
//           for the verify window's f32 dh=32 heads), which is what holds
//           the verify window back.
//   simple  (anything else) paged_attention_kernel: one block of 128
//           threads a (slot, query, head) row walking the whole chain
//           serially, one warp a key for q.k, one thread an output element
//           for p.V.

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

// -- the split family ---------------------------------------------------------

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kRing = 3;  // chain entries in flight a block

// 16 bytes global -> shared without a register round trip; src_bytes 0
// fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most `pending` (< kRing) of this thread's groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  static_assert(kRing == 3, "one case per possible count");
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes of T as floats
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / (int)sizeof(T);
};
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);           // the low bf16
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // the high bf16
  }
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

// The chain entries live for slot s: those holding a token <= max_w pos.
__device__ __forceinline__ int live_entries(const int* pos, int s, int W,
                                            int B, int NB, int& pmax) {
  pmax = -1;
  for (int w = 0; w < W; ++w) pmax = max(pmax, pos[(long long)s * W + w]);
  return pmax < 0 ? 0 : min(NB, pmax / B + 1);
}

// Bytes of the ring (depth entries of K and V), which the p.V partial sums
// ([ng][W][DH] f32) reuse
__host__ __device__ __forceinline__ int split_region(int depth, int tile,
                                                     int vec, int W) {
  const int ring = depth * 2 * tile;
  const int red = kSplitThreads * vec * W * (int)sizeof(float);
  return ring > red ? ring : red;
}

template <typename T, int WMAX>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v, const int* __restrict__ table,
                   const int* __restrict__ pos, float* __restrict__ part,
                   int W, int H, int DH, int B, int NB, int E, int splits,
                   float scale) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int c = blockIdx.x, head = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the split's first physical blocks, read beside the positions rather
  // than after them
  int first[kRing];
#pragma unroll
  for (int j = 0; j < kRing; ++j)
    first[j] = j < E && c * E + j < NB ? table[(long long)s * NB + c * E + j]
                                       : 0;
  int pmax;
  const int nlive = live_entries(pos, s, W, B, NB, pmax);
  const int e0 = c * E, n = min(e0 + E, nlive) - e0;
  if (n <= 0) {
    // wholly past every row's pos: (m, l) = (-inf, 0), which the merge
    // weighs by zero without reading this split's acc
    if (tid < W) {
      float* st = part + ((((long long)s * W + tid) * H + head) * splits + c) *
                             (DH + 2) + DH;
      st[0] = -INFINITY;
      st[1] = 0.f;
    }
    return;
  }

  const int row = DH * (int)sizeof(T);  // bytes of a key row (16 << k)
  const int lpk = row / 16;             // lanes a key row, <= 32
  const int ci = lane % lpk;            // this lane's 16-byte chunk
  const int tile = B * row;             // bytes of one entry's K (or V)
  const int depth = min(E, kRing);      // entries in flight
  unsigned char* ring = split_smem;  // depth x {K, V}, then p.V partials
  float* qs = reinterpret_cast<float*>(
      ring + split_region(depth, tile, VEC, W));  // [WMAX][DH] q in f32
  float* sc = qs + WMAX * DH;  // [WMAX][B] scores, then p
  float* ms = sc + WMAX * B;   // running max of each row
  float* ls = ms + WMAX;       // running sum
  float* al = ls + WMAX;       // this entry's rescale
  int* ps = reinterpret_cast<int*>(al + WMAX);  // [WMAX] positions

  int pw[WMAX];
#pragma unroll
  for (int w = 0; w < WMAX; ++w) pw[w] = w < W ? pos[(long long)s * W + w] : -1;
  for (int i = tid; i < W * lpk; i += kSplitThreads) {
    const int w = i / lpk, ch = i % lpk;
    float f[VEC];
    unpack16(*reinterpret_cast<const uint4*>(
                 q + (((long long)s * W + w) * H + head) * DH + ch * VEC),
             f);
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(qs + w * DH + ch * VEC + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
  if (tid < W) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
    ps[tid] = pw[tid];
  }
  // scores: sl lanes a (row, key) dot product, as many as the W * B
  // products leave room for (one lane each once they fill the block), so
  // a lane reduces over few others or none
  int sl = 1;
  while (sl < lpk && W * B * sl * 2 <= kSplitThreads) sl *= 2;

  // entry j of the split (physical block blk) into ring slot j % depth,
  // one commit group
  const int cpr = row / 16;
  auto issue = [&](int j, long long blk) {
    const int nb = e0 + j;
    const int kvalid = min(B, pmax - nb * B + 1);  // keys <= the slot's pos
    unsigned char* kd = ring + (j % depth) * 2 * tile;
    for (int i = tid; i < B * cpr; i += kSplitThreads) {
      const int b = i / cpr, ch = i % cpr;
      const long long off = ((blk * B + b) * H + head) * DH + ch * VEC;
      const bool ok = b < kvalid;
      cp_async16(kd + b * row + ch * 16, ok ? pool_k + off : pool_k,
                 ok ? 16 : 0);
      cp_async16(kd + tile + b * row + ch * 16, ok ? pool_v + off : pool_v,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kRing; ++j)
    if (j < min(n, depth)) issue(j, first[j]);

  // p.V: thread tid owns column chunk ci of keys kg, kg + ng, ...
  const int ng = kSplitThreads / lpk, kg = tid / lpk;
  float acc[WMAX][VEC];
#pragma unroll
  for (int w = 0; w < WMAX; ++w)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_async_wait(min(n, j + depth) - j - 1);
    __syncthreads();  // entry j is in for every thread
    const unsigned char* kt = ring + (j % depth) * 2 * tile;
    const unsigned char* vt = kt + tile;
    const int k0 = (e0 + j) * B;  // token position of the entry's first key
    for (int base = 0; base < W * B; base += kSplitThreads / sl) {
      const int pr = base + tid / sl, sub = tid % sl;
      const bool ok = pr < W * B;
      const int w = ok ? pr / B : 0, b = ok ? pr % B : 0;
      float d = 0.f;
      if (ok)
        for (int ch = sub; ch < lpk; ch += sl) {
          float kf[VEC];
          unpack16(*reinterpret_cast<const uint4*>(kt + b * row + ch * 16), kf);
          const float* qr = qs + w * DH + ch * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            d += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                 qv.w * kf[e + 3];
          }
        }
      for (int o = sl / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (ok && sub == 0)
        sc[w * B + b] = k0 + b <= ps[w] ? d * scale : -INFINITY;
    }
    __syncthreads();
    // the online softmax: a warp a query row, lanes across the keys
    for (int w = warp; w < W; w += kSplitWarps) {
      float mx = -INFINITY;
      for (int b = lane; b < B; b += 32) mx = fmaxf(mx, sc[w * B + b]);
      mx = warp_max(mx);
      const float m_old = ms[w], m_new = fmaxf(m_old, mx);
      // a row with no live key yet keeps exp away from -inf - -inf
      const float m_s = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int b = lane; b < B; b += 32) {
        const float p = expf(sc[w * B + b] - m_s);
        sc[w * B + b] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_s);
        al[w] = a;
        ls[w] = ls[w] * a + sum;
        ms[w] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      const float a = w < W ? al[w] : 1.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[w][e] *= a;
    }
    for (int b = kg; b < B; b += ng) {
      float vf[VEC];
      unpack16(*reinterpret_cast<const uint4*>(vt + b * row + ci * 16), vf);
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        // a key past this row's pos is skipped, not weighted by p = 0
        if (w < W && k0 + b <= pw[w]) {
          const float p = sc[w * B + b];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[w][e] = fmaf(p, vf[e], acc[w][e]);
        }
      }
    }
    __syncthreads();  // the slot and the scores are rewritten next
    if (j + depth < n)
      issue(j + depth, table[(long long)s * NB + e0 + j + depth]);
  }

  // the key groups' partial sums, added in group order
  float* red = reinterpret_cast<float*>(ring);  // [ng][W][DH]
#pragma unroll
  for (int w = 0; w < WMAX; ++w)
    if (w < W)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(red + (kg * W + w) * DH + ci * VEC + e) =
            make_float4(acc[w][e], acc[w][e + 1], acc[w][e + 2], acc[w][e + 3]);
  __syncthreads();
  for (int i = tid; i < W * DH; i += kSplitThreads) {
    const int w = i / DH, d = i % DH;
    float a = 0.f;
    for (int g = 0; g < ng; ++g) a += red[(g * W + w) * DH + d];
    part[((((long long)s * W + w) * H + head) * splits + c) * (DH + 2) + d] = a;
  }
  if (tid < W) {
    float* st = part +
                ((((long long)s * W + tid) * H + head) * splits + c) * (DH + 2);
    st[DH] = ms[tid];
    st[DH + 1] = ls[tid];
  }
}

// One warp a (s, w, head) row: the splits' (acc, m, l) merged in split
// order, the l == 0 -> 1 guard, the cast to T.  A lane reads the (m, l) of
// splits lane, lane + 32, ..., and their scales reach every lane by
// shuffles; a split of scale 0 (past every pos, or no live key of the row)
// adds nothing, and its acc, which it may not have written, is not used.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
paged_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                   long long rows, int DH, int splits) {
  constexpr int kCols = 8;  // DH <= 256: columns lane + 32 k a lane
  const long long rw = (long long)blockIdx.x * kSplitWarps + threadIdx.x / 32;
  if (rw >= rows) return;
  const int lane = threadIdx.x & 31;
  const int ld = DH + 2;
  const float* pr = part + rw * splits * ld;
  float M = -INFINITY;
  for (int c = lane; c < splits; c += 32) M = fmaxf(M, pr[c * ld + DH]);
  M = warp_max(M);
  const float Ms = M == -INFINITY ? 0.f : M;
  float l = 0.f, a[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) a[k] = 0.f;
  for (int c0 = 0; c0 < splits; c0 += 32) {
    const int c = c0 + lane;
    const float sc = c < splits ? expf(pr[c * ld + DH] - Ms) : 0.f;
    const float lc = sc != 0.f ? pr[c * ld + DH + 1] : 0.f;
    const int cn = min(32, splits - c0);
    for (int j0 = 0; j0 < cn; j0 += 4) {
      // four splits' columns in flight at once, read whether or not the
      // split wrote them (a split of scale 0 is selected away)
      float v[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          v[jj][k] = j0 + jj < cn && lane + 32 * k < DH
                         ? pr[(long long)(c0 + j0 + jj) * ld + lane + 32 * k]
                         : 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float scj = __shfl_sync(0xffffffffu, sc, (j0 + jj) & 31);
        const float lcj = __shfl_sync(0xffffffffu, lc, (j0 + jj) & 31);
        if (j0 + jj < cn && scj != 0.f) {
          l += lcj * scj;
#pragma unroll
          for (int k = 0; k < kCols; ++k) a[k] += v[jj][k] * scj;
        }
      }
    }
  }
  const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (lane + 32 * k < DH) store(out + rw * DH + lane + 32 * k, a[k] / l_safe);
}

template <typename T, int WMAX>
int launch_split(const void* q, const void* pool_k, const void* pool_v,
                 const int* table, const int* pos, float* part, void* out,
                 int S, int W, int H, int DH, int B, int NB, int E, int splits,
                 float scale, cudaStream_t st) {
  constexpr int VEC = Vec16<T>::N;
  const size_t smem =
      (size_t)split_region(E < kRing ? E : kRing, B * DH * (int)sizeof(T),
                           VEC, W) +
      (size_t)(WMAX * B + 3 * WMAX + WMAX * DH + WMAX) * sizeof(float);
  auto kern = paged_split_kernel<T, WMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((unsigned)splits, (unsigned)H, (unsigned)S), kSplitThreads,
         smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(pool_k),
                     static_cast<const T*>(pool_v), table, pos, part, W, H,
                     DH, B, NB, E, splits, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long rows = (long long)S * W * H;
  paged_merge_kernel<T>
      <<<(unsigned)((rows + kSplitWarps - 1) / kSplitWarps), kSplitThreads, 0,
         st>>>(part, static_cast<T*>(out), rows, DH, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_split(const void* q, const void* pool_k, const void* pool_v,
                   const int* table, const int* pos, float* part, void* out,
                   int S, int W, int H, int DH, int B, int NB, int E,
                   int splits, float scale, cudaStream_t st) {
#define PAGED_SPLIT(WM)                                                      \
  return launch_split<T, WM>(q, pool_k, pool_v, table, pos, part, out, S, W, \
                             H, DH, B, NB, E, splits, scale, st)
  if (W == 1) PAGED_SPLIT(1);
  if (W == 2) PAGED_SPLIT(2);
  if (W <= 4) PAGED_SPLIT(4);
  PAGED_SPLIT(8);
#undef PAGED_SPLIT
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

// The split family: launches paged_split_kernel then paged_merge_kernel on
// `stream`, allocates nothing, returns the cudaError_t of the launches (0 on
// success).  part is the [S, W, H, splits, DH + 2] f32 workspace; E chain
// entries a split, splits = ceil(NB / E).  The wrapper applies the family
// rule (1 <= W <= 8, DH * sizeof(dtype) = 16 << k <= 512, B <= 64, q and the
// pools 16-byte aligned), which is checked again here.
extern "C" int paged_attention_split(const void* q, const void* pool_k,
                                     const void* pool_v, const void* table,
                                     const void* pos, void* part, void* out,
                                     int S, int W, int H, int DH, int B,
                                     int NB, int E, int splits, float scale,
                                     int dtype, void* stream) {
  if ((long long)S * W * H == 0) return 0;
  const int es = dtype == 0 ? 4 : 2;
  const int row = DH * es;
  const bool pow2 = row >= 16 && row <= 512 && (row & (row - 1)) == 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(pool_k) |
                      reinterpret_cast<uintptr_t>(pool_v);
  if ((dtype != 0 && dtype != 1) || W < 1 || W > 8 || !pow2 || B < 1 ||
      B > 64 || NB < 1 || E < 1 || splits != (NB + E - 1) / E || S > 65535 ||
      H > 65535 || (a & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_split<float>(q, pool_k, pool_v, tbl, ps, pt, out, S, W, H,
                                 DH, B, NB, E, splits, scale, st);
  return dispatch_split<__nv_bfloat16>(q, pool_k, pool_v, tbl, ps, pt, out, S,
                                       W, H, DH, B, NB, E, splits, scale, st);
}
