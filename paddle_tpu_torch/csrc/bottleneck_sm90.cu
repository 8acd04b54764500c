// The fused ResNet bottleneck, forward, inference form, for Hopper
// (sm_90a): the sm90 family.  Hand-written CUDA C++ bound to PyTorch through
// a plain C interface (ctypes), as the other sources here; the primitives
// (TMA, mbarriers, wgmma, descriptors, tensor maps) are sm90.cuh's.
//
// Replaces benchmarks/bottleneck_pallas.py: make_fused (:30-139), at the
// shapes this family takes: bf16, Cm = 64, Cin = Cout a multiple of 64 up to
// 256 (the weights stay resident), W <= 64 (one image row is one 64-row
// wgmma tile), 16-byte aligned tensors.  Everything else keeps
// bottleneck.cu (the simple family); the wrapper's static rule
// (kernels/bottleneck.py: bottleneck_family) picks before any launch.
//
//   y1  = bf16(relu(x . w1 * s1 + b1))
//   y2  = bf16(relu(conv3x3_SAME(y1, w2) * s2 + b2))
//   out = bf16(relu(y2 . w3 * s3 + b3 + x))
//
// all sums in f32, rounded where bottleneck_ref and the script's
// xla_reference round.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes.  At the script's
// shape (N = 128, 56 x 56, 256 -> 64 -> 256) x is read and out written
// once, 411 MB = 0.1227 ms, against 55.9 GFLOP = 0.0565 ms.  What the
// design does about it: the weights and the mid activations never leave
// shared memory and registers; x is read twice (the second time mostly from
// L2) and out written once.
//
//   weights   w1 [C, 64], w2 [9 x 64, 64] and w3 [64, C] are loaded once a
//             block by TMA (136 KB at C = 256) and stay resident: no weight
//             re-reads from L2 per tile.
//   strips    a block owns a strip of R rows of one image (R from the
//             wrapper: one whole image a block once N fills the card) and
//             walks down it two output rows a step.  y1 lives in a ring of
//             kY1Rows rows in shared memory, each row W + 2 pixel slots of
//             128 bytes with a zero slot at each end; rows outside the image
//             are zero rows.  A 3x3 tap is then a pure address offset.  conv1
//             runs once per row; a strip computes its two halo rows besides
//             its own (none recomputed inside a strip).
//   threads   one producer warp streams x rows through a kXStages-deep TMA
//             ring (4-D map over [N, H, W, C], 128-byte swizzle, boxes of 64
//             channels x 64 pixels x one row; the zero fill covers pixels
//             W .. 63).  Two consumer warpgroups (setmaxnreg 240) take one
//             output row of the pair each: role 0 the even row r, role 1 the
//             odd row r + 1.  Role 1 computes y1 row r + 1 and role 0 y1 row
//             r + 2 in the step, then one named barrier, then each its
//             output row.  With six ring rows a step's writes touch only
//             rows last read a step earlier, so one barrier a step suffices.
//             Both warpgroups wait for every x stage and release it (the
//             empty barriers count both): a stage the two took in turns
//             would let one pass a parity wait a lap early.
//   conv1     wgmma m64n64k16: A the x stage (a descriptor), B w1 read
//             MN-major.  The epilogue (s1, b1, relu, round) writes the y1
//             ring row, its 16-byte chunks XOR-swizzled by the pixel slot so
//             that conv2's ldmatrix reads are free of bank conflicts.
//   conv2     nine taps x four k16 steps, A from registers (ldmatrix of the
//             shifted y1 rows: a one-pixel shift breaks the 8-row swizzle
//             atom a descriptor needs), B w2.  The epilogue (s2, b2, relu,
//             round) stays in registers.
//   conv3     A is y2 straight from conv2's accumulator (the m64 accumulator
//             layout is the register A layout), B w3, one 64-channel chunk
//             at a time (32 registers of sums).  The epilogue adds s3, b3
//             and the residual x row, relu, transposes the bf16 pairs across
//             each quad of lanes and stores 16 bytes a lane (64 contiguous
//             bytes a quad; scattered 4-byte stores cost 0.14 ms at the
//             script's shape), streaming (evict-first).  The residual x row
//             comes through the ring a second time (TMA, mostly an L2 hit:
//             the row was read a step or two before), one 64-channel tile
//             for each conv3 chunk; loaded from L2 into registers instead
//             (16 bytes a lane, under conv2) it cost 0.13 ms more
//             (kResFromRing, a design reading).
//
// Every wgmma is waited for before other code touches its registers
// (a product left in flight across other code serialises them all: ptxas
// C7514).
//
// Shared memory at C = 256, W = 56: weights 139,264 + y1 ring 6 x 58 x 128
// = 44,544 (aligned up to 45,056) + x ring 4 x 8,192 = 32,768 + scales
// 3,072 + barriers, and 1,024 of alignment: 221,256 of the 232,448 bytes a
// block may take (227,400 at W = 64).

#include "sm90.cuh"

namespace {

constexpr int kBnConsumers = 2;  // consumer warpgroups
constexpr int kBnThreads = 128 * (kBnConsumers + 1);
constexpr int kRolesPerWg = 2 / kBnConsumers;  // output rows a step each
constexpr int kXStages = 4;      // depth of the x ring
constexpr int kY1Rows = 6;       // rows of the y1 ring
// Where conv3's epilogue takes the residual x row from: the x ring (TMA
// streams the row a second time, mostly from L2), or L2 straight into
// registers before conv2 (a design reading: 0.43 ms against 0.30 at the
// script's shape on the H100).
constexpr bool kResFromRing = true;
constexpr int kTapsPerWait = 3;  // conv2 taps a wgmma group (1 or 3)
constexpr int kCm = 64;
constexpr int kTileB = 64 * 128;  // a [64, 64] bf16 tile

__host__ __device__ constexpr size_t align1024(size_t b) {
  return (b + 1023) & ~size_t(1023);
}

// Offsets (from the 1024-aligned base) of: w1, w2, w3, the y1 ring, the x
// ring, the scales and shifts, the barriers.  The x ring follows the y1
// ring: conv2's discarded pixel rows (past W) may read up to 1 KB past it.
struct Layout {
  size_t w1, w2, w3, y1, xr, sb, bars, total;
  __host__ __device__ Layout(int nch, int W) {
    w1 = 0;
    w2 = w1 + (size_t)nch * kTileB;
    w3 = w2 + 9 * (size_t)kTileB;
    y1 = w3 + (size_t)nch * kTileB;
    xr = align1024(y1 + (size_t)kY1Rows * (W + 2) * 128);
    sb = xr + (size_t)kXStages * kTileB;
    bars = sb + (4 * kCm + 2 * 64 * nch) * sizeof(float);
    total = 1024 + bars + (2 * kXStages + 1) * sizeof(uint64_t);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// A 4 x 4 transpose across the four lanes of a quad (lane q of the quad is
// q): lane q's v[i] becomes lane i's v[q].  Two rounds of swapping 2 x 2
// blocks, then elements, with the lane two and one apart.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  uint32_t s0 = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  uint32_t s1 = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) {
    v[0] = s0;
    v[1] = s1;
  } else {
    v[2] = s0;
    v[3] = s1;
  }
  s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  s1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) {
    v[0] = s0;
    v[2] = s1;
  } else {
    v[1] = s0;
    v[3] = s1;
  }
}

// Byte offset, in a y1 ring row, of 16-byte chunk `c` of pixel slot `slot`.
__device__ __forceinline__ uint32_t y1_off(int slot, int c) {
  return slot * 128 + ((c ^ (slot & 7)) << 4);
}

struct Params {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const float* sb[6];  // s1, b1, s2, b2 [64]; s3, b3 [C]
  int H, W, R, strips;
};

// A strip's rows: output rows [a, e); the y1 rows it needs are a - 1 .. e.
// Step s (from -1) computes y1 row a + 2s + 2 (role 0) and a + 2s + 1
// (role 1) and, from step 0, output row a + 2s + role.
__device__ __forceinline__ int y1_row(int role, int s, int a) {
  return a + 2 * s + 2 - role;
}

// The role whose conv1 sums acc1[ri] of warpgroup wg holds: its own with
// two warpgroups; with one (a design reading) acc1[0] is role 1's, the
// ring's first x row of a step.
__device__ __forceinline__ int conv1_role(int wg, int ri) {
  return (wg + ri * kBnConsumers) ^ (kRolesPerWg - 1);
}

template <int NCH>
__global__ void __launch_bounds__(kBnThreads, 1)
bottleneck_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w2,
                       const __grid_constant__ CUtensorMap tm_w3, Params P) {
  constexpr int C = 64 * NCH;
  const Layout L(NCH, P.W);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  float* sbs = reinterpret_cast<float*>(base + L.sb);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + kXStages;
  uint64_t* wbar = empty + kXStages;
  const int H = P.H, W = P.W;
  const int img = blockIdx.x / P.strips;
  const int a = (blockIdx.x % P.strips) * P.R;
  const int e = min(a + P.R, H);           // output rows [a, e)
  const int steps = (e - a + 1) / 2;       // steps 0 .. steps - 1
  const uint32_t pitch = (uint32_t)(W + 2) * 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(&full[s], 1);
      // every consumer warpgroup releases every stage (module comment)
      mbar_init(&empty[s], 128 * kBnConsumers);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the scales and shifts, and the y1 ring's zero slots
  for (int i = threadIdx.x; i < 4 * kCm + 2 * C; i += kBnThreads) {
    const int which = i < 4 * kCm ? i / kCm : 4 + (i - 4 * kCm) / C;
    const int c = i < 4 * kCm ? i % kCm : (i - 4 * kCm) % C;
    sbs[i] = P.sb[which][c];
  }
  for (int i = threadIdx.x; i < kY1Rows * 2 * 8; i += kBnThreads) {
    const int row = i / 16, slot = (i / 8) & 1 ? W + 1 : 0, c = i & 7;
    *reinterpret_cast<uint4*>(base + L.y1 + row * pitch + slot * 128 +
                              c * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // a y1 row is loaded from x when the strip needs it and it lies inside
  auto needed = [&](int g) { return g <= e; };
  auto loaded = [&](int g) { return g <= e && g >= 0 && g < H; };

  const int wg = threadIdx.x / 128;
  if (wg == kBnConsumers) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != kBnConsumers * 128) return;
    mbar_expect_tx(wbar, (2 * NCH + 9) * kTileB);
    for (int i = 0; i < NCH; ++i) {
      tma_load_2d(base + L.w1 + i * kTileB, &tm_w1, wbar, 0, 64 * i);
      tma_load_2d(base + L.w3 + i * kTileB, &tm_w3, wbar, 64 * i, 0);
    }
    for (int t = 0; t < 9; ++t)
      tma_load_2d(base + L.w2 + t * kTileB, &tm_w2, wbar, 0, 64 * t);
    int item = 0;
    const CUtensorMap* mx = &tm_x;
    unsigned char* xr = base + L.xr;
    auto load_x = [&item, mx, xr, full, empty, img](int row, int c) {
      const int st = item % kXStages;
      mbar_wait(&empty[st], ((item / kXStages) & 1) ^ 1);
      mbar_expect_tx(&full[st], kTileB);
      tma_load(xr + st * kTileB, mx, &full[st], 64 * c, 0, row, img);
      ++item;
    };
    for (int s = -1; s < steps; ++s) {
      const int g1 = y1_row(1, s, a), g0 = y1_row(0, s, a);
      for (int c = 0; c < NCH; ++c) {
        if (loaded(g1)) load_x(g1, c);
        if (loaded(g0)) load_x(g0, c);
      }
      if constexpr (kResFromRing)
        if (s >= 0)
          for (int role = 0; role < 2; ++role)
            if (a + 2 * s + role < e)
              for (int c = 0; c < NCH; ++c) load_x(a + 2 * s + role, c);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int q = lane % 4, r8 = lane / 4;
  const uint32_t sbase = smem_u32(base);
  const uint32_t w1a = sbase + L.w1, w2a = sbase + L.w2, w3a = sbase + L.w3;
  const uint32_t y1a = sbase + L.y1, xra = sbase + L.xr;
  const float* s1 = sbs;
  const float* b1 = sbs + kCm;
  const float* s2 = sbs + 2 * kCm;
  const float* b2 = sbs + 3 * kCm;
  const float* s3 = sbs + 4 * kCm;
  const float* b3 = s3 + C;
  // this thread's ldmatrix row: pixel and 16-byte chunk half of a k16 step
  const int lm_pix = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_half = lane >> 4;
  const long long img_px = (long long)img * H * W;
  mbar_wait(wbar, 0);

  int item = 0;  // the ring's sequence number at the start of the step
  for (int s = -1; s < steps; ++s) {
    const int g1 = y1_row(1, s, a), g0 = y1_row(0, s, a);
    const int l1 = loaded(g1), l0 = loaded(g0), nl = l0 + l1;
    // conv1, chunk by chunk in the ring's order (role 1's x row first).
    // Every warpgroup waits for every stage and releases it, its own or
    // not: a stage the two warpgroups took in turns would otherwise let one
    // of them pass a parity wait a whole lap early.
    float acc1[kRolesPerWg][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int role = 1; role >= 0; --role) {
        if (!(role ? l1 : l0)) continue;
        const int it = item + c * nl + (role ? 0 : l1);
        const int st = it % kXStages;
        mbar_wait(&full[st], (it / kXStages) & 1);
        if (kBnConsumers == 2 && role != wg) {
          mbar_arrive(&empty[st]);
          continue;
        }
        const int ri = kBnConsumers == 2 ? 0 : 1 - role;  // conv1_role^-1
        const uint32_t xs = xra + st * kTileB;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64_tb(acc1[ri], desc_k(xs + kk * 32),
                          desc_mn(w1a + (4 * c + kk) * 2048, kTileB),
                          c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc1[ri]);
        mbar_arrive(&empty[st]);
      }
    }
    item += NCH * nl;
    // the conv1 epilogue: y1 rows into the ring (zero rows outside)
#pragma unroll
    for (int ri = 0; ri < kRolesPerWg; ++ri) {
      const int role = conv1_role(wg, ri);
      const int g = role ? g1 : g0;
      if (!needed(g)) continue;
      const bool in = role ? l1 : l0;
      const uint32_t row = y1a + (uint32_t)((g - a + 1) % kY1Rows) * pitch;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * warp + r8 + 8 * h;
        if (p >= W) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * q;
          uint32_t v = 0u;
          if (in)
            v = pack_bf16(
                fmaxf(acc1[ri][4 * j + 2 * h] * s1[c] + b1[c], 0.f),
                fmaxf(acc1[ri][4 * j + 2 * h + 1] * s1[c + 1] + b1[c + 1],
                      0.f));
          st_shared_u32(row + y1_off(p + 1, j) + 4 * q, v);
        }
      }
    }
    named_bar_sync(1, 128 * kBnConsumers);
    if (s < 0) continue;

    const int res_item = item;
    const int has0 = a + 2 * s < e, has1 = a + 2 * s + 1 < e;
    if constexpr (kResFromRing) item += NCH * (has0 + has1);
#pragma unroll 1
    for (int role = 0; role < 2; ++role) {  // the ring's order
      if (!(role ? has1 : has0)) continue;
      if (kBnConsumers == 2 && role != wg) {
        // the other warpgroup's residual stages: waited for and released
        if constexpr (kResFromRing)
          for (int n = 0; n < NCH; ++n) {
            const int it = res_item + (role ? has0 * NCH : 0) + n;
            mbar_wait(&full[it % kXStages], (it / kXStages) & 1);
            mbar_arrive(&empty[it % kXStages]);
          }
        continue;
      }
      const int o = a + 2 * s + role;
      const long long px0 = img_px + (long long)o * W;
      // the residual row: from the ring in the epilogue (the accumulator
      // layout), or loaded from L2 here, 16 bytes a lane to fly under
      // conv2, and transposed into that layout in the epilogue
      uint32_t res[NCH][16];
      if constexpr (!kResFromRing) {
#pragma unroll
        for (int n = 0; n < NCH; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 16 * warp + r8 + 8 * h;
            const uint4* src = reinterpret_cast<const uint4*>(
                P.x + (px0 + min(p, W - 1)) * C + 64 * n + 8 * q);
            const uint4 lo = __ldg(src), hi = __ldg(src + 4);
            uint32_t* r = &res[n][8 * h];
            r[0] = lo.x, r[1] = lo.y, r[2] = lo.z, r[3] = lo.w;
            r[4] = hi.x, r[5] = hi.y, r[6] = hi.z, r[7] = hi.w;
          }
      }
      // conv2: nine taps, A by ldmatrix from the shifted ring rows
      float acc2[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t row =
            y1a + (uint32_t)((o + dy - a) % kY1Rows) * pitch;
#pragma unroll
        for (int d0 = 0; d0 < 3; d0 += kTapsPerWait) {
          uint32_t af[kTapsPerWait][4][4];
#pragma unroll
          for (int dx = 0; dx < kTapsPerWait; ++dx)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              ldmatrix_x4(af[dx][kk],
                          row + y1_off(lm_pix + d0 + dx, 2 * kk + lm_half));
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < kTapsPerWait; ++dx)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_n64(acc2, af[dx][kk],
                           desc_mn(w2a + (3 * dy + d0 + dx) * kTileB +
                                       kk * 2048,
                                   kTileB));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc2);
        }
      }
      // conv2's epilogue in registers, then y2 as conv3's A fragments
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = c + (i & 1);
          acc2[4 * j + i] = fmaxf(acc2[4 * j + i] * s2[ch] + b2[ch], 0.f);
        }
      }
      uint32_t a3[4][4];
      to_frags(acc2, a3);
      // conv3, one 64-channel chunk at a time, and the output epilogue
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        float acc3[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc3[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64(acc3, a3[kk],
                       desc_mn(w3a + n * kTileB + kk * 2048, kTileB));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc3);
        if constexpr (kResFromRing) {
          const int it = res_item + (role ? has0 * NCH : 0) + n;
          const int st = it % kXStages;
          mbar_wait(&full[st], (it / kXStages) & 1);
          const uint32_t xs = xra + st * kTileB;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 16 * warp + r8 + 8 * h;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              res[n][2 * j + h] =
                  ld_shared_u32(xs + p * 128 + ((j ^ (p & 7)) << 4) + 4 * q);
          }
          mbar_arrive(&empty[st]);
        }
        uint32_t raw[16];  // the L2 residual as loaded (not the ring's)
#pragma unroll
        for (int i = 0; i < 16; ++i) raw[i] = res[n][i];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 16 * warp + r8 + 8 * h;
          uint32_t v[2][4];
          if constexpr (!kResFromRing) {
            // lane q loaded channels 8q .. 8q + 7 of each half: back to
            // the accumulator layout's pairs, res[n][2 j + h]
            uint32_t t[2][4];
#pragma unroll
            for (int i = 0; i < 8; ++i) t[i >> 2][i & 3] = raw[8 * h + i];
            quad_transpose(t[0], q);
            quad_transpose(t[1], q);
#pragma unroll
            for (int j = 0; j < 8; ++j) res[n][2 * j + h] = t[j >> 2][j & 3];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = 64 * n + 8 * j + 2 * q;
            // the bf16 pair (low half the lower channel) widened exactly
            const uint32_t r = res[n][2 * j + h];
            const float v0 = acc3[4 * j + 2 * h] * s3[ch] + b3[ch] +
                             __uint_as_float(r << 16);
            const float v1 = acc3[4 * j + 2 * h + 1] * s3[ch + 1] +
                             b3[ch + 1] + __uint_as_float(r & 0xffff0000u);
            v[j >> 2][j & 3] = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
          // a quad's four lanes hold the pixel's 64 channels in pairs;
          // transposed, lane q holds channels 8q .. 8q + 7 of each half, and
          // the quad stores 2 x 64 contiguous bytes
          quad_transpose(v[0], q);
          quad_transpose(v[1], q);
          if (p < W) {
            // streaming stores: out is not read again, and leaving L2 to
            // the x rows the ring reads a second time for the residual
            uint4* dst = reinterpret_cast<uint4*>(P.out + (px0 + p) * C +
                                                  64 * n + 8 * q);
            __stcs(dst, make_uint4(v[0][0], v[0][1], v[0][2], v[0][3]));
            __stcs(dst + 4, make_uint4(v[1][0], v[1][1], v[1][2], v[1][3]));
          }
        }
      }
    }
  }
}

// [rows, cols] bf16 row-major as a 2-D map with [64, 64] boxes, 128-byte
// swizzled (cols innermost).
cudaError_t map2d(CUtensorMap* m, const void* p, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NCH>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           const float* const* sb, void* out, int N, int H, int W, int R,
           cudaStream_t st) {
  constexpr int C = 64 * NCH;
  CUtensorMap mx, m1, m2, m3;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                            (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {64, 64, 1, 1};
  cudaError_t e;
  if ((e = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 4, xd, xs, xb,
                      CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (e = map2d(&m1, w1, C, kCm)) || (e = map2d(&m2, w2, 9 * kCm, kCm)) ||
      (e = map2d(&m3, w3, kCm, C)))
    return (int)e;
  const Layout L(NCH, W);
  auto kern = bottleneck_sm90_kernel<NCH>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.total);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 6; ++i) p.sb[i] = sb[i];
  p.H = H;
  p.W = W;
  p.R = R;
  p.strips = (H + R - 1) / R;
  kern<<<(unsigned)(N * p.strips), kBnThreads, L.total, st>>>(mx, m1, m2, m3,
                                                              p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing and returns the cudaError_t of the
// launch (0 on success).  x and out [N, H, W, C] bf16 (C = Cin = Cout), w1
// [C, Cm], w2 [3, 3, Cm, Cm] (HWIO), w3 [Cm, C], contiguous bf16; s1, b1,
// s2, b2 [Cm] and s3, b3 [C] float32; R the strip height (1 <= R <= H).
// Takes Cm = 64, C in {64, 128, 192, 256}, 1 <= W <= 64, 16-byte aligned
// x, w1, w2, w3 and out, and dtype 1 (bfloat16) only: anything else returns
// cudaErrorInvalidValue and launches nothing.  The wrapper
// (paddle_tpu_torch/kernels/bottleneck.py) checks shapes, dtypes and
// contiguity, applies the family rule, picks R and allocates out.
extern "C" int bottleneck_sm90_fwd(const void* x, const void* w1,
                                   const void* w2, const void* w3,
                                   const void* s1, const void* b1,
                                   const void* s2, const void* b2,
                                   const void* s3, const void* b3, void* out,
                                   int N, int H, int W, int Cin, int Cm,
                                   int Cout, int R, int dtype, void* stream) {
  if (dtype != 1 || N < 1 || H < 1 || W < 1 || W > 64 || Cm != kCm ||
      Cin != Cout || Cin % 64 != 0 || Cin < 64 || Cin > 256 || R < 1 ||
      R > H || (long long)N * ((H + R - 1) / R) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[5] = {x, w1, w2, w3, out};
  for (int i = 0; i < 5; ++i)
    if (!aligned16(ptrs[i])) return (int)cudaErrorInvalidValue;
  cudaError_t e = bind_device_of(x);
  if (e != cudaSuccess) return (int)e;
  const float* sb[6] = {static_cast<const float*>(s1),
                        static_cast<const float*>(b1),
                        static_cast<const float*>(s2),
                        static_cast<const float*>(b2),
                        static_cast<const float*>(s3),
                        static_cast<const float*>(b3)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Cin / 64) {
    case 1: return launch<1>(x, w1, w2, w3, sb, out, N, H, W, R, st);
    case 2: return launch<2>(x, w1, w2, w3, sb, out, N, H, W, R, st);
    case 3: return launch<3>(x, w1, w2, w3, sb, out, N, H, W, R, st);
    default: return launch<4>(x, w1, w2, w3, sb, out, N, H, W, R, st);
  }
}

extern "C" const char* bottleneck_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
