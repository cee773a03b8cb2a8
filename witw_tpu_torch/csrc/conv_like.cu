// Kernel A of the static-int8 towers (int8_conv.cu) with its stages
// removable, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel exp/int8_isolate.py:conv_like, which ran
// the TPU's int8 conv kernel with its DMA or its patch build removed to see
// where its time went. The TPU's stages do not exist on Hopper, so this is
// the same decomposition of the port's own kernel A: its s8 wgmma design,
// specialised to the probe's input. For a pre-padded xp int8 [B, H + 2, WP,
// C] (row pitch WP >= W + 2; columns >= W + 2 unused), weights packed by
// exp/int8_isolate.py:pack_wmat_wgmma (ops/int8_conv.pack_weights_wgmma's
// table of wmat [9C, N]) and m f32 [N]:
//
//   full: y[b, h, w, n] = clip(rint(float(sum_{dy, dx, c} xp[b, h + dy, w + dx, c]
//                                      * wmat[(3 dy + dx) C + c, n]) * m[n]), 0, 127)   (int8)
//
//   nodma:   the producers issue no halo copies from device memory: every
//            stage's halo planes are zero-filled once, and the weights still
//            arrive by bulk copy. full - nodma = the input's copies.
//   nopatch: the halo is copied as in full, but every tap's A descriptor
//            points at one resident 64-pixel x 32-channel zero tile in
//            place of the tap-shifted halo. full - nopatch = what the shifted
//            implicit-GEMM operand costs over a resident one.
//   What neither mode removes (the weights' copies, the wgmma issue, the
//   ring's barriers, the epilogue) is the rest of full's time.
//
// Both stripped modes compute zeros (zero A operands, no bias). The TPU's
// left their scratch uninitialized; here they are defined. Every mode issues
// the same wgmma (one code path; only the A descriptors differ), and
// chip_smoke.py counts IGMMA in each instantiation's SASS.
//
// Bound: the int8 tensor-core rate (9 C multiply-adds per output element;
// 2.3 k operations per byte of device memory at the probe's shape).
//
// Design: kernel A's (int8_conv.cu, its header note), with what the probe's
// input allows taken out: stride 1, no height or width padding (the input
// is pre-padded, so VALID in both; a halo pixel past the array's rows or
// its row pitch reads zeros), C a multiple of 32 (16-byte copies only), no
// bias, ReLU's clip, N a multiple of 32 (16-byte output stores only). A
// persistent block of 384 threads walks tiles of 16 x 16 output pixels x N
// channels (N = 128 or 64, ops/int8_conv.tile_n; channel tile fastest):
// - one producer warpgroup fills a ring of as many stages as fit (4 at N
//   128): a 32-channel step's weights, 9 x 32 x N bytes, by one
//   cp.async.bulk in pack_weights_wgmma's order; the 18 x 18-pixel halo by
//   16-byte cp.async as two planes of 16 channels x pixel x 16 bytes,
//   marked full one step later (cp.async.wait_group, a proxy fence);
// - two consumer warpgroups each own two 8 x 8 blocks of the tile and issue
//   wgmma m64nNk32 (s8 in, s32 accumulate) with A and B both from shared
//   memory: tap (dy, dx) of a block is a no-swizzle K-major descriptor
//   (LBO one plane, SBO one halo row) whose start moves by (18 dy + dx) x
//   16 bytes. One commit group per step, waited one step behind;
// - the requant epilogue passes each warp's 16 pixels x 64 channels through
//   1 KB of row-swizzled staging to 16-byte stores.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_wgmma.cuh"

namespace {

using namespace witw;

constexpr int kConsumers = 256;                          // two warpgroups of wgmma
constexpr int kProducers = 128;                          // one warpgroup of copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kTile = 16;                                // output rows and columns of a tile
constexpr int kHalo = kTile + 2;                         // halo rows and columns
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kPlaneBytes = kHaloPix * 16;               // one plane: 16 channels of every halo pixel
constexpr int kStep = 32;                                // input channels per ring step (one k32)
constexpr int kSlots = (kHaloPix + kProducers / 2 - 1) / (kProducers / 2);  // pixels per producer
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;                       // the shared memory a block may use
constexpr int kZeroBytes = 2 * 64 * 16;                  // nopatch's zero A tile: 64 pixels x 32 channels
constexpr int kOutWarpBytes = 16 * 64;                   // epilogue staging of one consumer warp
constexpr int kOutBytes = (kConsumers / 32) * kOutWarpBytes;

enum Mode { kFull = 0, kNoPatch = 1, kNoDma = 2 };

// A tile: channel tile (fastest), then 16 x 16-pixel tile, then image.
struct TileIndex {
  int ct, r0, c0, b;
};

__device__ __forceinline__ TileIndex tile_index(int t, int co_tiles, int sp_tiles, int tiles_x) {
  const int sp = (t / co_tiles) % sp_tiles;
  return {t % co_tiles, (sp / tiles_x) * kTile, (sp % tiles_x) * kTile, t / co_tiles / sp_tiles};
}

template <int N, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
conv_like_kernel(const int8_t* __restrict__ xp, const int8_t* __restrict__ w, const float* __restrict__ m,
                 int8_t* __restrict__ out, int Hp, int WP, int C, int Co, int H, int W, int tiles_x,
                 int sp_tiles, int tiles, int stages) {
  constexpr int kWBytes = 9 * kStep * N;  // one step's weights
  constexpr int kHaloBytes = 2 * kPlaneBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  // [stages][a step's weights] [stages][halo: 2 planes] [zero tile] [full barriers]
  // [empty barriers] [epilogue staging, 1 KB per consumer warp] [m: Co]
  const uint32_t ws0 = smem_addr(smem);
  const uint32_t xs0 = ws0 + stages * kWBytes;
  const uint32_t zero0 = xs0 + stages * kHaloBytes;
  const uint32_t full0 = zero0 + kZeroBytes;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t out0 = empty0 + 8 * stages;
  float* m_s = reinterpret_cast<float*>(smem + (out0 - ws0) + kOutBytes);

  const int tid = threadIdx.x;
  const int co_tiles = (Co + N - 1) / N;
  const int steps = C / kStep;  // per tile

  for (int i = tid; i < Co; i += kThreads) m_s[i] = m[i];
  // The zero tile and, in nodma, every stage's halo: written once, here.
  const uint32_t zero_from = kMode == kNoDma ? xs0 : zero0;
  for (uint32_t a = zero_from + 16 * tid; a < zero0 + kZeroBytes; a += 16 * kThreads) sts128(a, 0, 0, 0, 0);
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, kProducers + 1);    // each producer + the weights' expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producers: ring step k (tile by tile, 32 channels at a time) into
    // stage k % stages once the consumers have released step k - stages.
    // A thread marks its part of step k full once its copies have landed,
    // after it has issued step k + 1.
    const int p = tid - kConsumers;
    int k = 0;
    auto mark_full = [&](int step) {
      fence_proxy_async();
      mbar_arrive(full0 + 8 * (step % stages));
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_index(t, co_tiles, sp_tiles, tiles_x);
      // This thread's halo pixels p / 2 + 64 i (channel plane p % 2) -> pixel
      // index in xp, or -1 past its rows or its row pitch (zeros).
      int src_pix[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int pix = p / 2 + (kProducers / 2) * i;
        const int gr = ti.r0 + pix / kHalo;
        const int gc = ti.c0 + pix % kHalo;
        src_pix[i] = pix < kHaloPix && gr < Hp && gc < WP ? (ti.b * Hp + gr) * WP + gc : -1;
      }
      const int8_t* wt = w + static_cast<size_t>(ti.ct) * 9 * C * N;
      for (int c = 0; c < steps; ++c, ++k) {
        const int st = k % stages;
        const uint32_t full = full0 + 8 * st;
        if (k >= stages) mbar_wait(empty0 + 8 * st, (k / stages - 1) & 1);
        if (p == 0) {  // weights: 9 x N x 32 int8, contiguous in the packed tensor
          mbar_arrive_expect_tx(full, kWBytes);
          bulk_copy(ws0 + st * kWBytes, wt + static_cast<size_t>(c) * kWBytes, kWBytes, full);
        }
        if (kMode != kNoDma) {
          const uint32_t xs = xs0 + st * kHaloBytes + (p % 2) * kPlaneBytes + (p / 2) * 16;
          const int ch = c * kStep + 16 * (p % 2);
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            if (p / 2 + (kProducers / 2) * i >= kHaloPix) break;
            const bool ok = src_pix[i] >= 0;  // else 16 zeros
            cp_async16(xs + (kProducers / 2) * i * 16, ok ? xp + static_cast<size_t>(src_pix[i]) * C + ch : xp,
                       ok ? 16 : 0);
          }
        }
        cp_async_commit();
        if (k > 0) {
          cp_async_wait<1>();  // this thread's copies of step k - 1 have landed
          mark_full(k - 1);
        }
      }
    }
    if (k > 0) {
      cp_async_wait<0>();
      mark_full(k - 1);
    }
  } else {
    // Consumers: warpgroup wg computes 8 x 8-pixel blocks 2 wg and 2 wg + 1
    // of the tile (block i at rows 8 (i / 2), columns 8 (i % 2)), 64 pixels
    // x N channels each. Thread (warp, lane) accumulates, per block, rows
    // 2 (warp % 4) and + 1 of the block at column lane / 4, and per
    // 8-channel group j channels 8 j + 2 (lane % 4) and + 1.
    const int lane = tid % 32;
    const int warp = tid / 32;
    uint32_t a_off[2];  // halo offset of each block's top-left pixel, tap (0, 0)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int blk = 2 * (warp / 4) + mb;
      a_off[mb] = ((blk / 2) * 8 * kHalo + (blk % 2) * 8) * 16;
    }
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_index(t, co_tiles, sp_tiles, tiles_x);
      int acc[2][N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[0][i] = acc[1][i] = 0;

      for (int c = 0; c < steps; ++c, ++k) {
        const int st = k % stages;
        mbar_wait(full0 + 8 * st, (k / stages) & 1);
        const uint32_t w_base = ws0 + st * kWBytes;
        const uint32_t x_base = xs0 + st * kHaloBytes;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          // B: N rows of 32 channels, core matrices 128 B apart along K, 256 B per 8 rows.
          const uint64_t b = desc(w_base + tap * N * 32, 128, 256);
          const uint32_t shift = ((tap / 3) * kHalo + tap % 3) * 16;
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            // A: 8 x 8 pixels, one plane apart along K, one halo row per 8 rows;
            // nopatch: the zero tile, 1 KB per 16 channels, 128 B per 8 pixels.
            const uint64_t a = kMode == kNoPatch ? desc(zero0, 1024, 128)
                                                 : desc(x_base + a_off[mb] + shift, kPlaneBytes, kHalo * 16);
            wgmma_s8<N>(acc[mb], a, b);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step is done: release its stage
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % stages));
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        fence_operand(acc[0][i]);
        fence_operand(acc[1][i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % stages));  // the tile's last step

      // Epilogue: per pass of 64 channels, the warp's 16 pixels go through
      // its staging and leave as 16-byte stores, 4 lanes per pixel. Staging
      // row q (pixel (2 (warp % 4) + q / 8, q % 8) of the block) holds 4
      // chunks of 16 bytes, chunk c at c ^ key with key = (q / 2) % 4 =
      // (lane / 8) % 4 for both rows a lane writes or reads.
      const int t4 = lane % 4;
      const int key = (lane >> 3) & 3;
      const uint32_t stage = out0 + warp * kOutWarpBytes;
      const int co_base = ti.ct * N;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int blk = 2 * (warp / 4) + mb;
        const int pr = ti.r0 + (blk / 2) * 8 + 2 * (warp % 4);  // output row of staging rows 0-7
        const int pc = ti.c0 + (blk % 2) * 8;
#pragma unroll
        for (int pass = 0; pass < N / 64; ++pass) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = pass * 8 + jj;  // 8-channel group of the fragment
            const int co = co_base + 8 * j + 2 * t4;
            const bool in = co < Co;  // Co % 32 == 0: both channels in or both out
            const float2 f = in ? *reinterpret_cast<const float2*>(m_s + co) : make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t row = stage + (lane / 4 + 8 * h) * 64;
              const uint32_t v = requant(acc[mb][4 * j + 2 * h], 0, f.x, 0.f) |
                                 (requant(acc[mb][4 * j + 2 * h + 1], 0, f.y, 0.f) << 8);
              sts16(row + (((jj / 2) ^ key) << 4) + 8 * (jj % 2) + 2 * t4, v);
            }
          }
          __syncwarp();
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            const int q = lane / 4 + 8 * it;
            const uint4 o = lds128(stage + q * 64 + ((t4 ^ key) << 4));
            const int co = co_base + pass * 64 + 16 * t4;
            const int r = pr + q / 8;
            const int col = pc + q % 8;
            if (co < Co && r < H && col < W) {  // Co % 16 == 0: a chunk is all in or all out
              *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(ti.b) * H + r) * W + col) * Co + co) = o;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int N, int kMode>
int launch(const void* xp, const void* w, const void* m, void* out, int B, int H, int WP, int C, int Co, int W,
           cudaStream_t stream) {
  const auto kernel = conv_like_kernel<N, kMode>;
  // The ring: as many stages as fit beside the zero tile, the staging and m.
  const int stage_bytes = 9 * kStep * N + 2 * kPlaneBytes + 2 * 8;
  const int fixed = kZeroBytes + kOutBytes + 4 * Co;
  const int fit = (kSmemLimit - fixed) / stage_bytes;
  const int stages = fit < kMaxStages ? fit : kMaxStages;
  if (fixed > kSmemLimit || stages < 3) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = stages * stage_bytes + fixed;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (W + kTile - 1) / kTile;
  const int sp_tiles = ((H + kTile - 1) / kTile) * tiles_x;
  const long long tiles = static_cast<long long>((Co + N - 1) / N) * sp_tiles * B;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // Persistent: one block per resident slot, each walking tiles blockIdx.x + i * gridDim.x.
  const int grid = static_cast<int>(tiles < 1LL * sms * per_sm ? tiles : 1LL * sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const int8_t*>(xp), static_cast<const int8_t*>(w),
                                           static_cast<const float*>(m), static_cast<int8_t*>(out), H + 2, WP,
                                           C, Co, H, W, tiles_x, sp_tiles, static_cast<int>(tiles), stages);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int dispatch(const void* xp, const void* w, const void* m, void* out, int B, int H, int WP, int C, int Co, int W,
             int mode, cudaStream_t stream) {
  switch (mode) {
    case kFull: return launch<N, kFull>(xp, w, m, out, B, H, WP, C, Co, W, stream);
    case kNoPatch: return launch<N, kNoPatch>(xp, w, m, out, B, H, WP, C, Co, W, stream);
    case kNoDma: return launch<N, kNoDma>(xp, w, m, out, B, H, WP, C, Co, W, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// xp int8 [B, H + 2, WP, C], w int8 from pack_weights_wgmma for a channel
// tile of tile_n (128 or 64), m f32 [Co] -> out int8 [B, H, W, Co]; mode 0
// full, 1 nopatch, 2 nodma. C and Co multiples of 32, Co <= 4096, W + 2 <=
// WP, B (H + 2) WP < 2^31, all contiguous and 16-byte aligned (checked by
// exp/int8_isolate.py). Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int witw_conv_like(const void* xp, const void* w, const void* m, void* out, int B, int H, int WP, int C,
                   int Co, int W, int tile_n, int mode, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  if (C % kStep != 0 || C <= 0 || Co % 32 != 0 || W + 2 > WP) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_n) {
    case 128: return dispatch<128>(xp, w, m, out, B, H, WP, C, Co, W, mode, s);
    case 64: return dispatch<64>(xp, w, m, out, B, H, WP, C, Co, W, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
