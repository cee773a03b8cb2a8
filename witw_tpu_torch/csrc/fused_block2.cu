// VGG block 2 of the static-int8 towers in one pass, on Hopper's warpgroup
// tensor cores (s8 wgmma), for sm_90a: conv2_1 -> requant -> conv2_2 ->
// requant -> 2x2 max pool, with conv2_1's output kept in shared memory.
//
// Replaces the Pallas TPU kernels exp/fused_block2.py:fused_block2 and
// exp/fused_block2_v2.py:fused_block2_v2 (the same function in another TPU
// layout). For the pool-1 output x int8 [B, H, W, 64]:
//
//   y1  = clip(rint(float(conv(x,  w1) + b1) * m1), 0, 127)    [B, H, W, 128]
//   y2  = clip(rint(float(conv(y1, w2) + b2) * m2), 0, 127)    [B, H, W, 128]
//   out = maxpool2x2(y2)                                   [B, H/2, W/2, 128]
//
// (3x3 convs, zero height padding; zero width padding, or circular width:
// the JAX tower's block halo of 2 wrapped columns followed by two
// width-VALID convs). Weights are kernel A's tables
// (ops/int8_conv.py:pack_weights_wgmma, N 128): w1 2 and w2 4 steps of 32
// input channels.
//
// The trap (exp/fused_block2.py:68-76): conv2_2's padding is zeros of y1,
// not conv2_1 evaluated outside the image. So y1's halo rows -1 and H are
// zero, and with zero width padding so are its columns -1 and W. With
// `circular`, y1 at column -1 is conv2_1 at column W-1 (and W at 0): the
// input halo is read with its columns taken mod W, which makes conv2_1
// circular, and its halo columns come out right without masking.
//
// Bound: the int8 tensor-core rate (2 x 9 x (64 + 128) x 128 operations per
// pixel against 64 bytes in and 32 out). y1 never reaches device memory; the
// price is conv2_1 recomputed on each tile's 1-pixel halo, and stage 1's
// flat M (below) computes 384 rows for 256 outputs: 1.5x conv2_1's useful
// work, 1.17x the block's.
//
// Design: kernel A's (int8_conv.cu, sharing int8_wgmma.cuh). A tile is 16 x
// 16 conv2_2 outputs (8 x 8 pool outputs) of one image x all 128 channels;
// persistent blocks of 384 threads walk tiles blockIdx.x + i x gridDim.x
// (column tile fastest, then row tile, then image).
// - Producers (one warpgroup). Warp 0's first thread streams the weights
//   through a ring of kStages stages, a step (9 taps x 32 channels x 128 =
//   36,864 bytes, in the B descriptor's order) per cp.async.bulk counted on
//   the stage's full mbarrier: per tile w1's 2 steps, then w2's 4. Warps 1-3
//   copy the tile's 20 x 20-pixel input halo (input rows r0 - 2 .., columns
//   c0 - 2 ..; zero outside the image, columns mod W with `circular`) by
//   16-byte cp.async as 4 planes of 16 channels x pixel x 16 bytes, wait for
//   them, fence the async proxy and arrive on the halo's full barrier. The
//   consumers release the halo after stage 1, so the next tile's halo
//   arrives during this tile's stage 2.
// - Stage 1 (conv2_1) is a flat implicit GEMM over the halo's pitch of 20:
//   M row i is y1 pixel (i / 20, i % 20) of the 18 x 18 y1 tile (origin r0 -
//   1, c0 - 1), and tap (dy, dx) reads halo pixel i + 20 dy + dx, so a tap
//   shifts the A descriptor's start and 8 consecutive rows are one
//   no-swizzle core matrix (SBO 128 bytes, LBO one plane). Columns 18 and 19
//   and rows past 17 are junk, computed and dropped: 360 rows rounded to 6
//   m64 blocks, 3 per consumer warpgroup, each over both w1 steps (the ring
//   holds them until the third). A block's epilogue requantizes into y1,
//   resident in shared memory as 8 planes of 16 channels x 18 x 18 pixels x
//   16 bytes, writing 0 for the pixels outside the image, while the next
//   block's wgmma runs (two accumulators: the epilogue, with the tensor
//   cores idle, took as long as the wgmma). A named barrier over the
//   consumers orders the first write after both warpgroups' last reads of
//   the previous tile's y1, and one after the last write (with a proxy
//   fence) orders stage 2.
// - Stage 2 (conv2_2) is kernel A's consumer loop on A read from y1 (SBO one
//   y1 row, 288 bytes; a tap shifts the start by (18 dy + dx) x 16 bytes):
//   warpgroup g computes the tile's rows 8 g .. 8 g + 7 as two 8 x 8 blocks.
// - Stage 2's epilogue pools in registers. A thread holds, per block,
//   output rows 2 (warp % 4) and + 1 at column lane / 4: it requantizes each
//   value (the plain version's order; the requant is not assumed monotone),
//   takes the height pair's max with __vmaxu4 and the width pair's with one
//   __shfl_xor_sync(.., 4) per two 8-channel groups, and passes the warp's 8
//   pooled pixels x 128 channels through 1 KB of staging (16-byte chunks
//   swizzled by pixel) to 16-byte stores.
// - Both epilogues requantize without an int-to-float conversion
//   (requant_fast) where every channel of both tables allows it, which the
//   block checks once; other tables take int8_wgmma.cuh's requant. A loop of
//   each is compiled.
// Budget: shared memory (bytes) 4 ring stages 147,456 + halo 4 x 6,912 (the
// junk rows read up to pixel 425) + y1 41,472 + staging 8,192 + the four
// tables 2,048 + barriers 80 = 226,896 of 232,448; registers 168 a thread at
// launch, moved by setmaxnreg to 64 for the producers and 216 for the
// consumers (two 64 x 128 s32 accumulators, 128; at 168 they spilled).
// Where the time goes (profile_int8.py [4]: clock64 per tile, and copies of
// this kernel without its loads or without its wgmma): PERF.md.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "int8_wgmma.cuh"

namespace {

using namespace witw;

constexpr int kConsumers = 256;  // two warpgroups of wgmma
constexpr int kThreads = kConsumers + 128;
constexpr int kC1 = 64;          // input channels
constexpr int kC = 128;          // output channels of both convs (N)
constexpr int kTile = 16;        // conv2_2 outputs per tile side
constexpr int kPoolTile = kTile / 2;
constexpr int kY1 = kTile + 2;   // y1 tile side
constexpr int kX = kTile + 4;    // input halo side, and stage 1's row pitch
constexpr int kHaloPix = kX * kX;
constexpr int kM1 = 384;         // stage 1's flat M: 18 rows of pitch 20, in m64 blocks
static_assert(kM1 % 64 == 0 && kM1 >= (kY1 - 1) * kX + kY1, "stage 1 must cover the y1 tile");
constexpr int kStep = 32;        // input channels per ring step (one k32 of s8 wgmma)
constexpr int kSteps1 = kC1 / kStep;
constexpr int kSteps2 = kC / kStep;
constexpr int kWBytes = 9 * kStep * kC;
constexpr int kStages = 4;
// A halo plane holds every pixel a junk row reads: up to kM1 - 1 + 2 kX + 2.
constexpr int kXPlane = ((kM1 + 2 * kX + 2 + 7) / 8 * 8) * 16;
constexpr int kY1Plane = kY1 * kY1 * 16;
constexpr int kHaloThreads = 96;  // producer warps 1-3
constexpr int kHaloRow = kHaloThreads / 4;  // pixels per round of the halo copy (4 planes)
constexpr int kHaloSlots = (kHaloPix + kHaloRow - 1) / kHaloRow;
constexpr int kOutWarpBytes = kPoolTile * kC;  // staging: one pooled row of the tile
// Registers per thread after setmaxnreg: the producers give some of theirs to
// the consumers, whose two 64 x 128 s32 accumulators take 128. A block is
// launched with 168 a thread (__launch_bounds__(kThreads, 1)), and setmaxnreg
// only moves registers within it: an increase past what the decreases
// released never completes.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 216;
static_assert(kProducerRegs * (kThreads - kConsumers) + kConsumerRegs * kConsumers <=
                  kLaunchRegs * kThreads,
              "setmaxnreg may only redistribute the block's registers");

constexpr int kXOff = kStages * kWBytes;
constexpr int kY1Off = kXOff + (kC1 / 16) * kXPlane;
constexpr int kOutOff = kY1Off + (kC / 16) * kY1Plane;
constexpr int kTablesOff = kOutOff + (kConsumers / 32) * kOutWarpBytes;
constexpr int kBarsOff = kTablesOff + 4 * kC * 4;
constexpr int kSmemBytes = kBarsOff + 8 * (2 * kStages + 2);
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

// The same value, opaque to the compiler: descriptors derived from a base
// address made opaque where a pass starts are computed where its wgmma
// needs them, not hoisted out of the tile loop (the halo and y1 never move,
// so every A descriptor would be loop-invariant) or shared between stage
// 1's three blocks (which read the same weights), and kept in registers.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

constexpr int kMagic = 0x4B400000;  // 1.5 x 2^23 as a float's bits
constexpr int kFastMax = (1 << 22) - 1;

// Whether one channel's requant may take requant_fast: RN((2^22 - 1) m) >=
// 127.5, so every accumulator from 2^22 - 1 up requantizes to 127; m <= 0.5,
// so |RN(v m)| < 2^21 for |v| < 2^22; and |bias_q| < 2^24, so acc + bias_q +
// 1.5 x 2^23 stays in int32 (|acc| < 9 x 128 x 128 x 128 < 2^25).
__device__ __forceinline__ bool fast_requant_ok(int bias_q, float m) {
  return __fmul_rn(static_cast<float>(kFastMax), m) >= 127.5f && m <= 0.5f &&
         bias_q > -(1 << 24) && bias_q < (1 << 24);
}

// requant (int8_wgmma.cuh) with ReLU (lo 0) and no conversion, for tables
// that pass fast_requant_ok; the result is the low byte (the others are not
// zeroed). v = acc + bias_q is clamped at 2^22 - 1 (its requant is 127 either
// way) and read as the float 1.5 x 2^23 + v, exact for |v| < 2^22 (a v below
// -2^22 reads as a float under 2^23, so f stays negative and clips to 0, as
// the reference's does). The product is rounded half to even by the add of
// 1.5 x 2^23, whose bits are then 1.5 x 2^23's plus rint(f m), and clipped to
// [0, 127] as integers. An add-and-min replaces the conversion (I2F, 16 per
// clock per SM), and integer clips the float ones and the mask.
__device__ __forceinline__ uint32_t requant_fast(int acc, int bias_q, float m) {
  const int v = min(acc + bias_q + kMagic, kMagic + kFastMax);
  const float f = __fsub_rn(__int_as_float(v), 12582912.f);
  const int r = __float_as_int(__fadd_rn(__fmul_rn(f, m), 12582912.f));
  return static_cast<uint32_t>(min(max(r, kMagic), kMagic + 127));
}

// The requantized byte of one channel in the low byte.
template <bool kFast>
__device__ __forceinline__ uint32_t requant_relu(int acc, int bias_q, float m) {
  return kFast ? requant_fast(acc, bias_q, m) : requant(acc, bias_q, m, 0.f);
}

// Bytes 0 of a and b as bytes 0 and 1.
__device__ __forceinline__ uint32_t pack2(uint32_t a, uint32_t b) { return __byte_perm(a, b, 0x0040); }

// A 2-byte shared-memory store that, unlike int8_wgmma.cuh's sts16, lets the
// compiler move the epilogue tables' loads ahead of it: after the prologue
// nothing the consumers load with plain loads is ever stored to, and the
// stores stay ordered with the volatile fences, barriers and lds128.
__device__ __forceinline__ void sts16_free(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(static_cast<uint16_t>(v)));
}

// Stage 1's epilogue for one m64 block (flat rows row0 .. row0 + 63):
// requantize into the y1 tile, 0 outside the image, junk rows dropped.
template <bool kFast>
__device__ __forceinline__ void store_y1(const int (&a)[kC / 2], int row0, uint32_t y1s,
                                         const int* b1_s, const float* m1_s, int r0, int c0, int H,
                                         int W, int circular) {
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  bool keep[2], in[2];
  uint32_t at[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4 + 8 * h;
    const int yr = i / kX;
    const int yc = i % kX;
    const int gr = r0 - 1 + yr;
    const int gc = c0 - 1 + yc;
    keep[h] = yr < kY1 && yc < kY1;
    in[h] = gr >= 0 && gr < H && (circular || (gc >= 0 && gc < W));
    at[h] = y1s + (yr * kY1 + yc) * 16 + 2 * t4;
  }
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    const int co = 8 * j + 2 * t4;
    const int2 bq = *reinterpret_cast<const int2*>(b1_s + co);
    const float2 mq = *reinterpret_cast<const float2*>(m1_s + co);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = pack2(requant_relu<kFast>(a[4 * j + 2 * h], bq.x, mq.x),
                               requant_relu<kFast>(a[4 * j + 2 * h + 1], bq.y, mq.y));
      if (keep[h]) sts16_free(at[h] + (j / 2) * kY1Plane + 8 * (j % 2), in[h] ? v : 0u);
    }
  }
}

// Stage 2's epilogue for one 8 x 8 block: requantize, pool the thread's
// height pair and the width pair of lanes 4 apart, and write the pooled
// row's pixels q0 .. q0 + 3 into the warp's staging (pixel q at q x 128
// bytes, its 16-byte chunk c at c ^ 2 (q % 4)).
template <bool kFast>
__device__ __forceinline__ void pool_block(const int (&a)[kC / 2], int q0, uint32_t stage,
                                           const int* b2_s, const float* m2_s) {
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int q = q0 + lane / 8;
  const uint32_t row = stage + q * kC + 2 * t4;
#pragma unroll
  for (int jp = 0; jp < kC / 16; ++jp) {  // 8-channel groups 2 jp and 2 jp + 1
    uint32_t rows[2][2];  // [height pair][group]: two channels in bytes 0 and 1
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * jp + jj;
      const int co = 8 * j + 2 * t4;
      const int2 bq = *reinterpret_cast<const int2*>(b2_s + co);
      const float2 mq = *reinterpret_cast<const float2*>(m2_s + co);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h][jj] = pack2(requant_relu<kFast>(a[4 * j + 2 * h], bq.x, mq.x),
                            requant_relu<kFast>(a[4 * j + 2 * h + 1], bq.y, mq.y));
      }
    }
    uint32_t v = __vmaxu4(__byte_perm(rows[0][0], rows[0][1], 0x5410),
                          __byte_perm(rows[1][0], rows[1][1], 0x5410));
    v = __vmaxu4(v, __shfl_xor_sync(0xffffffffu, v, 4));
    if ((lane & 4) == 0) {
      const uint32_t chunk = row + ((jp ^ (2 * (q % 4))) << 4);
      sts16_free(chunk, v);
      sts16_free(chunk + 8, v >> 16);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_block2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
                    const int* __restrict__ b1, const float* __restrict__ m1,
                    const int8_t* __restrict__ w2, const int* __restrict__ b2,
                    const float* __restrict__ m2, int8_t* __restrict__ out, int H, int W, int Hp,
                    int Wp, int tiles_x, int tiles_y, int tiles, int circular) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [ring: kStages x a step's weights] [halo: 4 planes] [y1: 8 planes]
  // [staging: 1 KB per consumer warp] [b1, m1, b2, m2] [barriers]
  const uint32_t ws0 = smem_addr(smem);
  const uint32_t xs0 = ws0 + kXOff;
  const uint32_t y1s0 = ws0 + kY1Off;
  int* b1_s = reinterpret_cast<int*>(smem + kTablesOff);
  float* m1_s = reinterpret_cast<float*>(b1_s + kC);
  int* b2_s = reinterpret_cast<int*>(m1_s + kC);
  float* m2_s = reinterpret_cast<float*>(b2_s + kC);
  const uint32_t full0 = ws0 + kBarsOff;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t halo_full = empty0 + 8 * kStages;
  const uint32_t halo_empty = halo_full + 8;

  const int tid = threadIdx.x;
  bool fast = true;
  for (int i = tid; i < kC; i += kThreads) {
    b1_s[i] = b1[i];
    m1_s[i] = m1[i];
    b2_s[i] = b2[i];
    m2_s[i] = m2[i];
    fast = fast && fast_requant_ok(b1_s[i], m1_s[i]) && fast_requant_ok(b2_s[i], m2_s[i]);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the weights' expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init(halo_full, kHaloThreads);
    mbar_init(halo_empty, kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fast = __syncthreads_and(fast);  // every channel of both tables takes requant_fast

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kConsumers;
    if (p == 0) {
      // Weights: ring step k into stage k % kStages once the consumers have
      // released step k - kStages.
      int k = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int s = 0; s < kSteps1 + kSteps2; ++s, ++k) {
          const int st = k % kStages;
          const uint32_t full = full0 + 8 * st;
          if (k >= kStages) mbar_wait(empty0 + 8 * st, (k / kStages - 1) & 1);
          const int8_t* src = s < kSteps1 ? w1 + s * kWBytes : w2 + (s - kSteps1) * kWBytes;
          mbar_arrive_expect_tx(full, kWBytes);
          bulk_copy(ws0 + st * kWBytes, src, kWBytes, full);
        }
      }
    } else if (p >= 32) {
      // Halo: this thread's channel plane hp and pixels hq + kHaloRow i.
      const int hp = (p - 32) % 4;
      const int hq = (p - 32) / 4;
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        const int r0 = ((t / tiles_x) % tiles_y) * kTile;
        const int c0 = (t % tiles_x) * kTile;
        const int b = t / tiles_x / tiles_y;
        if (n > 0) mbar_wait(halo_empty, (n - 1) & 1);
#pragma unroll
        for (int i = 0; i < kHaloSlots; ++i) {
          const int pix = hq + kHaloRow * i;
          if (pix >= kHaloPix) break;
          const int gr = r0 - 2 + pix / kX;
          int gc = c0 - 2 + pix % kX;
          if (circular) {
            gc %= W;
            if (gc < 0) gc += W;
          }
          const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
          const int8_t* src = ok ? x + ((static_cast<size_t>(b) * H + gr) * W + gc) * kC1 + 16 * hp : x;
          cp_async16(xs0 + hp * kXPlane + pix * 16, src, ok ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        mbar_arrive(halo_full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // The consumers' tile loop, with requant_fast (kFast) or requant in the
    // epilogues: one loop of each is compiled, and the tables choose.
    auto consume = [&](auto fast_tag) {
      constexpr bool kFast = decltype(fast_tag)::value;
      const int lane = tid % 32;
      const int warp = tid / 32;
      const int wg = warp / 4;
      const uint32_t stage = ws0 + kOutOff + warp * kOutWarpBytes;
      int k = 0;
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        const int ty = (t / tiles_x) % tiles_y;
        const int tx = t % tiles_x;
        const int b = t / tiles_x / tiles_y;
        const int r0 = ty * kTile;
        const int c0 = tx * kTile;
        int acc[2][kC / 2];

        // Stage 1: m64 blocks wg, 2 + wg and 4 + wg of the flat M, each over
        // both w1 steps, pipelined: a block's wgmma runs while the previous
        // block's epilogue writes y1.
        auto stage1_block = [&](int (&a)[kC / 2], int blk) {
#pragma unroll
          for (int i = 0; i < kC / 2; ++i) a[i] = 0;
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < kSteps1; ++s) {
            const uint32_t xa = opaque(xs0 + 2 * s * kXPlane + 64 * blk * 16);
            const uint32_t wb = opaque(ws0 + ((k + s) % kStages) * kWBytes);
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              wgmma_s8<kC>(a, desc(xa + ((tap / 3) * kX + tap % 3) * 16, kXPlane, 128),
                           desc(wb + tap * kC * kStep, 128, 256));
            }
          }
          wgmma_commit();
        };
        auto stage1_store = [&](int (&a)[kC / 2], int blk) {
#pragma unroll
          for (int i = 0; i < kC / 2; ++i) fence_operand(a[i]);
          store_y1<kFast>(a, 64 * blk, y1s0, b1_s, m1_s, r0, c0, H, W, circular);
        };
        mbar_wait(halo_full, n & 1);
#pragma unroll
        for (int s = 0; s < kSteps1; ++s) mbar_wait(full0 + 8 * ((k + s) % kStages), ((k + s) / kStages) & 1);
        stage1_block(acc[0], wg);
        stage1_block(acc[1], 2 + wg);
        wgmma_wait<1>();
        consumers_sync();  // both warpgroups have done reading the previous tile's y1
        stage1_store(acc[0], wg);
        stage1_block(acc[0], 4 + wg);
        wgmma_wait<1>();
        stage1_store(acc[1], 2 + wg);
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) {  // release the halo and w1
          mbar_arrive(halo_empty);
#pragma unroll
          for (int s = 0; s < kSteps1; ++s) mbar_arrive(empty0 + 8 * ((k + s) % kStages));
        }
        k += kSteps1;
        stage1_store(acc[0], 4 + wg);
        fence_proxy_async();  // y1's generic-proxy writes before wgmma's reads
        consumers_sync();

        // Stage 2: tile rows 8 wg .. 8 wg + 7, 8 x 8 block mb at column 8 mb.
#pragma unroll
        for (int i = 0; i < kC / 2; ++i) acc[0][i] = acc[1][i] = 0;
        for (int c = 0; c < kSteps2; ++c, ++k) {
          const int st = k % kStages;
          mbar_wait(full0 + 8 * st, (k / kStages) & 1);
          const uint32_t ya = opaque(y1s0 + 2 * c * kY1Plane + 8 * wg * kY1 * 16);
          const uint32_t wb = opaque(ws0 + st * kWBytes);
          wgmma_fence();
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const uint64_t bd = desc(wb + tap * kC * kStep, 128, 256);
            const uint32_t a0 = ya + ((tap / 3) * kY1 + tap % 3) * 16;
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              wgmma_s8<kC>(acc[mb], desc(a0 + 8 * mb * 16, kY1Plane, kY1 * 16), bd);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous step is done: release its stage
          if (c > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % kStages));
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kC / 2; ++i) {
          fence_operand(acc[0][i]);
          fence_operand(acc[1][i]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % kStages));  // the tile's last step

        // Epilogue: the warp's pooled row (tile pool row 4 wg + warp % 4),
        // pixels 0-3 from block 0 and 4-7 from block 1, then 16-byte stores.
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) pool_block<kFast>(acc[mb], 4 * mb, stage, b2_s, m2_s);
        __syncwarp();
        const int pr = ty * kPoolTile + 4 * wg + warp % 4;
#pragma unroll
        for (int it = 0; it < 2; ++it) {
          const int q = 4 * it + lane / 8;
          const int ch = lane % 8;
          const uint4 v = lds128(stage + q * kC + ((ch ^ (2 * (q % 4))) << 4));
          const int pc = tx * kPoolTile + q;
          if (pr < Hp && pc < Wp) {
            *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * Hp + pr) * Wp + pc) * kC + 16 * ch) = v;
          }
        }
        __syncwarp();
      }
    };
    if (fast) {
      consume(std::true_type{});
    } else {
      consume(std::false_type{});
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (checked by the wrapper).
size_t witw_fused_block2_smem_bytes() { return kSmemBytes; }

// x int8 [B, H, W, 64]; w1, w2 int8 from pack_weights_wgmma for Cin 64 and
// 128 (Co 128: [1, 9 x 64 x 128] and [1, 9 x 128 x 128]); b1, b2 int32
// [128]; m1, m2 f32 [128]; out int8 [B, H/2, W/2, 128]. All contiguous and
// 16-byte aligned, fewer than 2^31 tiles, circular only with W >= 2 (checked
// by ops/fused_block2.py). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int witw_fused_block2(const void* x, const void* w1, const void* b1, const void* m1,
                      const void* w2, const void* b2, const void* m2, void* out, int B, int H,
                      int W, int circular, void* stream) {
  const int Hp = H / 2;
  const int Wp = W / 2;
  if (B <= 0 || Hp <= 0 || Wp <= 0) return 0;
  const int tiles_x = (Wp + kPoolTile - 1) / kPoolTile;
  const int tiles_y = (Hp + kPoolTile - 1) / kPoolTile;
  const long long tiles = 1LL * B * tiles_x * tiles_y;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(fused_block2_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_block2_kernel, kThreads, kSmemBytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // Persistent: one block per resident slot, each walking tiles blockIdx.x + i * gridDim.x.
  const int grid = static_cast<int>(tiles < 1LL * sms * per_sm ? tiles : 1LL * sms * per_sm);
  fused_block2_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1), static_cast<const int*>(b1),
      static_cast<const float*>(m1), static_cast<const int8_t*>(w2), static_cast<const int*>(b2),
      static_cast<const float*>(m2), static_cast<int8_t*>(out), H, W, Hp, Wp, tiles_x, tiles_y,
      static_cast<int>(tiles), circular);
  return static_cast<int>(cudaGetLastError());
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
