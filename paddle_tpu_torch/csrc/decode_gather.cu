// Paged decode gather over the serving block table: a hand-written kernel
// for Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces paddle_tpu/kernels/pallas_gather.py: decode_gather (the TPU
// kernel: a PrefetchScalarGridSpec over (S, NB) whose scalar-prefetched
// table feeds the input BlockSpec's index map, so each grid cell DMAs the
// physical block its table entry names; the body is one copy).  It builds
// each slot's logical KV view,
//
//   out[s, nb*B:(nb+1)*B] = pool[table[s, nb]]
//
//   pool  [num_blocks, B, H, DH]  any element type (bf16 and f32 on the path)
//   table [S, NB] int32           physical block of each chain entry
//   out   [S, NB*B, H, DH]        pool's element type
//
// A physical block is B*H*DH contiguous elements and so is its slot of the
// output, so the gather is S*NB copies of block_bytes contiguous bytes.  One
// thread block owns one (s, nb) pair: blockIdx.x = s*NB + nb, which is also
// the index of its output block.  One thread reads the table entry (the
// counterpart of scalar prefetch) into shared memory; then the block copies
// BYTES, not elements, so bf16 and f32 share one body and the result is
// bit-exact by construction.  The copy runs in 16-byte vectors when source
// and destination share their address modulo 16 (after a scalar head up to
// the first 16-byte boundary); otherwise in the widest unit both addresses
// share (8, 4, 2 or 1 bytes).  A byte count that is not a multiple of the
// unit ends in a scalar tail.  These are paths of the kernel; nothing falls
// back to the plain version.
//
// Bound on the H100 (3.35 TB/s HBM): memory.  Every output byte is read once
// and written once and there is no arithmetic: at the decode shape (S=32,
// NB=16, B=32, H=6, DH=128, bf16) that is 2 * 25,165,824 bytes, 0.0150 ms.
// 512 blocks of 256 threads, 12 16-byte loads a thread, keep enough bytes in
// flight to approach it.  Table entries are data and are not range-checked:
// an entry outside [0, num_blocks) reads outside the pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Copy n bytes in units of V (both pointers aligned to sizeof(V)), then the
// tail of n % sizeof(V) bytes one at a time.
template <typename V>
__device__ __forceinline__ void copy_units(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long n) {
  const long long nv = n / (long long)sizeof(V);
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (long long i = threadIdx.x; i < nv; i += kThreads) d[i] = __ldg(s + i);
  for (long long i = nv * (long long)sizeof(V) + threadIdx.x; i < n;
       i += kThreads)
    dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
decode_gather_kernel(const char* __restrict__ pool,
                     const int* __restrict__ table, char* __restrict__ out,
                     long long block_bytes) {
  __shared__ int phys;
  if (threadIdx.x == 0) phys = __ldg(table + blockIdx.x);
  __syncthreads();
  const char* src = pool + (long long)phys * block_bytes;
  char* dst = out + (long long)blockIdx.x * block_bytes;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  // the widest unit both addresses can reach together
  int g = 16;
  while (g > 1 && ((a ^ b) & (uintptr_t)(g - 1))) g >>= 1;
  long long head = (long long)((g - (a & (uintptr_t)(g - 1))) &
                               (uintptr_t)(g - 1));
  if (head > block_bytes) head = block_bytes;
  for (long long i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  src += head;
  dst += head;
  const long long n = block_bytes - head;
  switch (g) {
    case 16: copy_units<int4>(src, dst, n); break;
    case 8: copy_units<int2>(src, dst, n); break;
    case 4: copy_units<int>(src, dst, n); break;
    case 2: copy_units<short>(src, dst, n); break;
    default: copy_units<char>(src, dst, n); break;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, returns the cudaError_t of the
// launch (0 on success).  rows = S * NB output blocks of block_bytes each.
// The wrapper (paddle_tpu_torch/kernels/decode_gather.py) checks shapes,
// dtypes, contiguity and the device.
extern "C" int decode_gather_launch(const void* pool, const void* table,
                                    void* out, long long rows,
                                    long long block_bytes, void* stream) {
  if (rows == 0 || block_bytes == 0) return 0;
  if (rows < 0 || rows > 0x7fffffffLL || block_bytes < 0)
    return (int)cudaErrorInvalidValue;
  decode_gather_kernel<<<(unsigned)rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(pool), static_cast<const int*>(table),
      static_cast<char*>(out), block_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* decode_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
