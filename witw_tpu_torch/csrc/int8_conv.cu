// Int8 3x3 convolution with a fused requant (or dequant) epilogue on
// Hopper's warpgroup tensor cores (s8 wgmma), for sm_90a.
//
// Replaces the Pallas TPU kernels exp/int8_conv_pallas.py:conv3x3_int8,
// exp/int8_conv_v2.py:conv3x3_int8_v2 (the same function, a whole image per
// grid step) and exp/r4_conv_taps.py:conv3x3_int8_taps (its circular-width
// form). For x int8 [B, H, W, Cin] (NHWC) and weights packed by
// ops/int8_conv.py:pack_weights_wgmma:
//
//   acc[b, r, c, o] = sum_{dy, dx, ci} x[b, r*sh + dy - 1, c + dx - pad_w, ci]
//                                      * w[dy, dx, ci, o]     (int32, exact)
//
// with zero height padding 1, stride sh in {1, 2} along the height, stride 1
// along the width, and width padding pad_w = 1 (zero) or 0 (width-VALID: the
// circular tower passes an input already wrap-haloed by its block). Then
// either the int8 epilogue of models/quantize._requant,
//
//   y = clip(rint(float(acc + bias_q[o]) * m[o]), lo, 127)   (lo = 0 folds ReLU)
//
// or the float epilogue of the tower's last conv,
//
//   y = float(acc) * dequant[o] + bias_f[o]                 (f32 out).
//
// Row 7's TPU function is the bias_q = 0, zero-pad case of this kernel; row
// 10's circular semantics are the block halo followed by pad_w = 0.
//
// Bound: the int8 tensor-core rate at every layer but conv1_1 and the head's
// last conv (9 Cin multiply-adds per output element; int8 needs 590
// operations per byte of device memory, and the convs from conv1_2 on carry
// thousands). The second limit is shared memory: it moves 128 bytes per clock
// per SM against 8192 int8 operations, so a design must carry more than 64
// operations per byte of shared-memory traffic.
//
// Design: the structure of conv3x3_bf16.cu with int8 operands. An implicit
// GEMM, persistent and warp specialised. A tile is 256 output pixels of one
// image (TR x TC in {16 x 16, 32 x 8, 8 x 32}, chosen by the wrapper for the
// least padding) x N output channels (128, 64 or 16 by Co); K = 9 taps x
// Cin_p (Cin rounded up to 32), taken 32 channels per ring step. Each block
// walks tiles blockIdx.x + i x gridDim.x (channel tile fastest) with 384
// threads:
// - one producer warpgroup fills a ring of as many stages as fit (3 to 8; 4
//   at N 128, stride 1). A step's weights, 9 x 32 x N bytes, arrive by one
//   cp.async.bulk counted on the stage's full mbarrier: pack_weights_wgmma
//   stores them in the order the B descriptor reads (no swizzle, K-major:
//   8 rows x 16 bytes core matrices of 128 contiguous bytes, LBO 128, SBO
//   256). The halo, ((TR - 1) sh + 3) x (TC + 2) pixels x 32 channels from
//   input row r0 sh - 1 and column c0 - pad_w, arrives by 16-byte cp.async
//   copies, zero-filled outside the image and past Cin (Cin % 16 != 0, i.e.
//   conv1_1, is copied byte by byte). A producer marks its share of a step
//   full one step later, after cp.async.wait_group and a proxy fence, so that
//   the async proxy of wgmma sees the copies (so the ring needs 3 stages).
// - two consumer warpgroups each own two 8 x 8 blocks of the tile (64 rows of
//   M each) and issue wgmma.mma_async m64nNk32 (s8 in, s32 accumulate) with
//   A and B both read from shared memory: the halo is stored as two planes of
//   16 channels x pixel x 16 bytes, so an 8 x 8 block at tap (dy, dx) is a
//   no-swizzle K-major descriptor (LBO one plane, SBO sh halo rows) whose
//   start moves by (dy (TC + 2) + dx) x 16 bytes. One commit group per step,
//   waited one step behind; the stage is then released on its empty mbarrier.
// - the epilogue reads bias_q and m (or dequant and bias_f) from shared
//   memory, requantizes with __int2float_rn, __fmul_rn and a rounding add
//   (no FMA contraction, ties to even: see requant), and passes each warp's
//   16 pixels x 64 bytes (64 int8 or 16 f32 channels) through 1 KB of
//   staging, 16-byte chunks swizzled by row so that neither the 2- or 8-byte
//   writes nor the 16-byte reads conflict, to 16-byte stores (4-byte stores
//   when Co % 16 != 0).
// Budget at N 128, stride 1: shared memory 4 x (36,864 B of weights + up to
// 10,880 of halo) + 64 of barriers + 8,192 of epilogue staging + 8 Co of
// tables; ptxas: 163 / 117 / 72 registers for N 128 / 64 / 16 (two 64 x N s32
// accumulators per consumer thread), no spills. Shared-memory traffic per
// step at N 128: wgmma reads 2 x 9 x 2 x (2 KB of A + 4 KB of B) = 216 KB
// and the ring takes 47.7 KB, against 18.9 M operations: 72 operations per
// byte.
// Where the time goes (profile_int8.py [3]: clock64 per tile, and copies of
// this kernel without its copies or without its wgmma): PERF.md.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_wgmma.cuh"

namespace {

using namespace witw;

constexpr int kConsumers = 256;      // two warpgroups of wgmma
constexpr int kProducers = 128;      // one warpgroup of copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kTilePix = 256;        // output pixels per tile: four 8 x 8 blocks
constexpr int kStep = 32;            // input channels per ring step (one k32 of s8 wgmma)
constexpr int kHaloMaxPix = 65 * 10; // the largest halo, of a 32 x 8 tile at stride 2
constexpr int kSlots = (kHaloMaxPix + kProducers / 2 - 1) / (kProducers / 2);  // pixels per producer
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;   // the shared memory a block may use
// Epilogue staging of one consumer warp: 16 pixels x 64 bytes.
constexpr int kOutWarpBytes = 16 * 64;
constexpr int kOutBytes = (kConsumers / 32) * kOutWarpBytes;

// A tile: channel tile (fastest), then 256-pixel tile, then image.
struct TileIndex {
  int ct, r0, c0, b;
};

__device__ __forceinline__ TileIndex tile_index(int t, int co_tiles, int sp_tiles, int tiles_x, int tr,
                                                int tc) {
  const int sp = (t / co_tiles) % sp_tiles;
  return {t % co_tiles, (sp / tiles_x) * tr, (sp % tiles_x) * tc, t / co_tiles / sp_tiles};
}

template <int N, bool kDequant>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const uint32_t* __restrict__ t1, const float* __restrict__ t2, void* __restrict__ out,
                    int H, int W, int Cin, int cin_p, int Co, int Ho, int Wo, int sh, int pad_w,
                    int tc_log2, int tiles_x, int sp_tiles, int tiles, int stages, int plane_bytes,
                    float lo) {
  constexpr int kWBytes = 9 * kStep * N;  // one step's weights
  extern __shared__ __align__(128) unsigned char smem[];
  // [stages][a step's weights, pack_weights_wgmma's order]
  // [stages][halo: 2 planes of 16 channels x pixel x 16 B] [full barriers][empty barriers]
  // [epilogue staging, 1 KB per consumer warp] [t1 (bias_q or dequant), t2 (m or bias_f): Co each]
  const uint32_t ws0 = smem_addr(smem);
  const int halo_bytes = 2 * plane_bytes;
  const uint32_t xs0 = ws0 + stages * kWBytes;
  const uint32_t full0 = xs0 + stages * halo_bytes;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t out0 = empty0 + 8 * stages;
  uint32_t* t1_s = reinterpret_cast<uint32_t*>(smem + (out0 - ws0) + kOutBytes);
  float* t2_s = reinterpret_cast<float*>(t1_s + Co);

  const int tid = threadIdx.x;
  const int tc = 1 << tc_log2;
  const int tr = kTilePix >> tc_log2;
  const int hc = tc + 2;  // halo columns
  const int halo_pix = ((tr - 1) * sh + 3) * hc;
  const int co_tiles = (Co + N - 1) / N;
  const int steps = cin_p / kStep;  // per tile

  for (int i = tid; i < Co; i += kThreads) {
    t1_s[i] = t1[i];
    t2_s[i] = t2[i];
  }
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
    const bool vec_x = (Cin % 16) == 0;
    int k = 0;
    auto mark_full = [&](int step) {
      fence_proxy_async();
      mbar_arrive(full0 + 8 * (step % stages));
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_index(t, co_tiles, sp_tiles, tiles_x, tr, tc);
      // This thread's halo pixels p / 2 + 64 i (channel plane p % 2) -> pixel
      // index in x, or -1 outside the image (zeros).
      int src_pix[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int pix = p / 2 + (kProducers / 2) * i;
        const int gr = ti.r0 * sh - 1 + pix / hc;
        const int gc = ti.c0 - pad_w + pix % hc;
        const bool ok = pix < halo_pix && gr >= 0 && gr < H && gc >= 0 && gc < W;
        src_pix[i] = ok ? (ti.b * H + gr) * W + gc : -1;
      }
      const int8_t* wt = w + static_cast<size_t>(ti.ct) * 9 * cin_p * N;
      for (int c = 0; c < steps; ++c, ++k) {
        const int st = k % stages;
        const int k0 = c * kStep;
        const uint32_t full = full0 + 8 * st;
        if (k >= stages) mbar_wait(empty0 + 8 * st, (k / stages - 1) & 1);
        if (p == 0) {  // weights: 9 x N x 32 int8, contiguous in the packed tensor
          mbar_arrive_expect_tx(full, kWBytes);
          bulk_copy(ws0 + st * kWBytes, wt + static_cast<size_t>(c) * kWBytes, kWBytes, full);
        }
        const uint32_t xs = xs0 + st * halo_bytes + (p % 2) * plane_bytes + (p / 2) * 16;
        const int ch = k0 + 16 * (p % 2);
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (p / 2 + (kProducers / 2) * i >= halo_pix) break;
          const uint32_t dst = xs + (kProducers / 2) * i * 16;
          if (vec_x) {
            const bool ok = src_pix[i] >= 0 && ch < Cin;  // else 16 zeros
            cp_async16(dst, ok ? x + static_cast<size_t>(src_pix[i]) * Cin + ch : x, ok ? 16 : 0);
          } else {  // Cin % 16 != 0 (conv1_1): byte by byte, zero past Cin
            const int8_t* src = x + static_cast<size_t>(src_pix[i] < 0 ? 0 : src_pix[i]) * Cin;
            uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              if (src_pix[i] >= 0 && ch + j < Cin) {
                v[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[ch + j])) << (8 * (j % 4));
              }
            }
            sts128(dst, v[0], v[1], v[2], v[3]);
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
    // of the tile, 64 pixels x N channels each (M rows: 8 tile rows of 8
    // pixels). Thread (warp, lane) accumulates, per block, rows 2 (warp % 4)
    // and + 1 of the block at column g = lane / 4, and per 8-channel group j
    // channels 8 j + 2 (lane % 4) and + 1.
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int blocks_x = tc / 8;
    const uint32_t sbo = sh * hc * 16;  // the next block row reads sh halo rows further
    uint32_t a_off[2];  // halo offset of each block's top-left pixel, tap (0, 0)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int blk = 2 * (warp / 4) + mb;
      a_off[mb] = ((blk / blocks_x) * 8 * sh * hc + (blk % blocks_x) * 8) * 16;
    }
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_index(t, co_tiles, sp_tiles, tiles_x, tr, tc);
      int acc[2][N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[0][i] = acc[1][i] = 0;

      for (int c = 0; c < steps; ++c, ++k) {
        const int st = k % stages;
        mbar_wait(full0 + 8 * st, (k / stages) & 1);
        const uint32_t w_base = ws0 + st * kWBytes;
        const uint32_t x_base = xs0 + st * halo_bytes;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          // B: N rows of 32 channels, core matrices 128 B apart along K, 256 B per 8 rows.
          const uint64_t b = desc(w_base + tap * N * 32, 128, 256);
          const uint32_t shift = ((tap / 3) * hc + tap % 3) * 16;
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            // A: 8 x 8 pixels, one plane apart along K, sh halo rows per 8 rows.
            wgmma_s8<N>(acc[mb], desc(x_base + a_off[mb] + shift, plane_bytes, sbo), b);
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

      // Epilogue: per pass of 64 bytes per pixel (64 int8 or 16 f32
      // channels), the warp's 16 pixels go through its staging and leave as
      // 16-byte stores, 4 lanes per pixel. Staging row q (pixel (2 (warp % 4)
      // + q / 8, q % 8) of the block) holds 4 chunks of 16 bytes, chunk c at
      // c ^ key with key = (q / 2) % 4 = (lane / 8) % 4 for both rows a lane
      // writes or reads.
      const int t4 = lane % 4;
      const int key = (lane >> 3) & 3;
      const uint32_t stage = out0 + warp * kOutWarpBytes;
      const int co_base = ti.ct * N;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int blk = 2 * (warp / 4) + mb;
        const int pr = ti.r0 + (blk / blocks_x) * 8 + 2 * (warp % 4);  // output row of staging rows 0-7
        const int pc = ti.c0 + (blk % blocks_x) * 8;
        constexpr int kPassCh = kDequant ? 16 : 64;  // channels per pass
#pragma unroll
        for (int pass = 0; pass < (N + kPassCh - 1) / kPassCh; ++pass) {
#pragma unroll
          for (int jj = 0; jj < kPassCh / 8; ++jj) {
            const int j = pass * (kPassCh / 8) + jj;  // 8-channel group of the fragment
            if (j < N / 8) {
              const int co = co_base + 8 * j + 2 * t4;
              const bool in = co < Co;  // Co % 4 == 0: both channels in or both out
              const uint2 a = in ? *reinterpret_cast<const uint2*>(t1_s + co) : make_uint2(0u, 0u);
              const float2 f = in ? *reinterpret_cast<const float2*>(t2_s + co) : make_float2(0.f, 0.f);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t row = stage + (lane / 4 + 8 * h) * 64;
                const int a0 = acc[mb][4 * j + 2 * h], a1 = acc[mb][4 * j + 2 * h + 1];
                if constexpr (kDequant) {
                  const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), __uint_as_float(a.x)), f.x);
                  const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(a1), __uint_as_float(a.y)), f.y);
                  sts64(row + (((2 * jj + t4 / 2) ^ key) << 4) + 8 * (t4 % 2), y0, y1);
                } else {
                  const uint32_t v = requant(a0, static_cast<int>(a.x), f.x, lo) |
                                     (requant(a1, static_cast<int>(a.y), f.y, lo) << 8);
                  sts16(row + (((jj / 2) ^ key) << 4) + 8 * (jj % 2) + 2 * t4, v);
                }
              }
            }
          }
          __syncwarp();
          constexpr int kChunkCh = kDequant ? 4 : 16;                     // channels per 16 bytes
          const int chunks = min(4, (N - pass * kPassCh) / kChunkCh);   // chunks this pass fills
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            const int q = lane / 4 + 8 * it;
            const uint4 o = lds128(stage + q * 64 + ((t4 ^ key) << 4));
            const int co = co_base + pass * kPassCh + kChunkCh * t4;
            const int r = pr + q / 8;
            const int col = pc + q % 8;
            if (t4 < chunks && co < Co && r < Ho && col < Wo) {
              const size_t at = (static_cast<size_t>(ti.b) * Ho + r) * Wo + col;
              if constexpr (kDequant) {  // Co % 4 == 0: 4 channels, 16-byte aligned
                *reinterpret_cast<uint4*>(static_cast<float*>(out) + at * Co + co) = o;
              } else if (Co % 16 == 0) {
                *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + at * Co + co) = o;
              } else {  // 4-byte aligned only: one word per 4 channels
                uint32_t* dst = reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + at * Co + co);
                dst[0] = o.x;
                if (co + 4 < Co) dst[1] = o.y;
                if (co + 8 < Co) dst[2] = o.z;
                if (co + 12 < Co) dst[3] = o.w;
              }
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int N, bool kDequant>
int launch(const void* x, const void* w, const void* t1, const void* t2, void* out, int B, int H, int W,
           int Cin, int cin_p, int Co, int sh, int pad_w, int tc_log2, float lo, cudaStream_t stream) {
  const auto kernel = conv3x3_int8_kernel<N, kDequant>;
  const int Ho = (H - 1) / sh + 1;
  const int Wo = W + 2 * pad_w - 2;
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Co <= 0) return 0;
  const int tc = 1 << tc_log2;
  const int tr = kTilePix / tc;
  // The ring: as many stages as fit beside the epilogue's staging and tables.
  const int plane_bytes = ((tr - 1) * sh + 3) * (tc + 2) * 16;
  const int stage_bytes = 9 * kStep * N + 2 * plane_bytes + 2 * 8;
  const int fixed = kOutBytes + 8 * Co;
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
  const int tiles_x = (Wo + tc - 1) / tc;
  const int sp_tiles = ((Ho + tr - 1) / tr) * tiles_x;
  const long long tiles = static_cast<long long>((Co + N - 1) / N) * sp_tiles * B;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // Persistent: one block per resident slot, each walking tiles blockIdx.x + i * gridDim.x.
  const int grid = static_cast<int>(tiles < 1LL * sms * per_sm ? tiles : 1LL * sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const uint32_t*>(t1),
      static_cast<const float*>(t2), out, H, W, Cin, cin_p, Co, Ho, Wo, sh, pad_w, tc_log2, tiles_x,
      sp_tiles, static_cast<int>(tiles), stages, plane_bytes, lo);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDequant>
int dispatch(const void* x, const void* w, const void* t1, const void* t2, void* out, int B, int H, int W,
             int Cin, int cin_p, int Co, int sh, int pad_w, int tile_n, int tc_log2, float lo, void* stream) {
  if (tc_log2 < 3 || tc_log2 > 5 || cin_p % kStep != 0 || cin_p < Cin || Co % 4 != 0 ||
      (sh != 1 && sh != 2) || (pad_w != 0 && pad_w != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_n) {
    case 128: return launch<128, kDequant>(x, w, t1, t2, out, B, H, W, Cin, cin_p, Co, sh, pad_w, tc_log2, lo, s);
    case 64: return launch<64, kDequant>(x, w, t1, t2, out, B, H, W, Cin, cin_p, Co, sh, pad_w, tc_log2, lo, s);
    case 16: return launch<16, kDequant>(x, w, t1, t2, out, B, H, W, Cin, cin_p, Co, sh, pad_w, tc_log2, lo, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x int8 [B, H, W, Cin]; w int8 from pack_weights_wgmma for a channel tile
// of tile_n (128, 64 or 16) and cin_p = Cin rounded up to a multiple of 32;
// bias_q int32 [Co], m f32 [Co]; out int8 [B, Ho, Wo, Co] with Ho = (H - 1)
// / sh + 1 and Wo = W + 2 pad_w - 2; lo is 0 (ReLU folded) or -127. Co % 4
// == 0, Co <= 4096; the output tile is (256 >> tc_log2) x (1 << tc_log2)
// pixels, tc_log2 in 3..5; all contiguous and 16-byte aligned, B H W < 2^31
// (checked by ops/int8_conv.py). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int witw_conv3x3_int8(const void* x, const void* w, const void* bias_q, const void* m, void* out,
                      int B, int H, int W, int Cin, int cin_p, int Co, int sh, int pad_w, int tile_n,
                      int tc_log2, int relu, void* stream) {
  return dispatch<false>(x, w, bias_q, m, out, B, H, W, Cin, cin_p, Co, sh, pad_w, tile_n, tc_log2,
                         relu ? 0.f : -127.f, stream);
}

// f32 out [B, Ho, Wo, Co] = float(acc) * dequant + bias_f (no bias_q).
int witw_conv3x3_int8_dequant(const void* x, const void* w, const void* dequant, const void* bias_f,
                              void* out, int B, int H, int W, int Cin, int cin_p, int Co, int sh,
                              int pad_w, int tile_n, int tc_log2, void* stream) {
  return dispatch<true>(x, w, dequant, bias_f, out, B, H, W, Cin, cin_p, Co, sh, pad_w, tile_n, tc_log2,
                        0.f, stream);
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
