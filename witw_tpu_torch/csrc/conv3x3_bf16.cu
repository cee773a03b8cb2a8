// bf16 3x3 stride-1 convolution + bias (+ReLU) on Hopper's warpgroup tensor
// cores (wgmma), for sm_90a.
//
// Replaces the Pallas TPU kernels exp/pallas_conv3x3.py:conv3x3_bias_relu
// (NHWC, zero or circular width padding) and
// exp/pallas_conv3x3.py:conv3x3_bias_relu_cw (the same function in the
// TPU-lane layout [B, H, C, W]). For x bf16 [B, H, W, Cin] (NHWC), weights
// packed by ops/conv3x3.py:pack_weights and bias f32 [Co]:
//
//   acc[b, r, c, o] = sum_{dy, dx, ci} x[b, r + dy - 1, c + dx - 1, ci] * w[o, ci, dy, dx]
//   y = bf16_rn(max(acc + bias[o], 0))          (f32 accumulation, one rounding)
//
// with the height zero-padded by 1, and the width zero-padded by 1 or, with
// `circular`, read modulo W (the overhead tower's wrapping panorama).
//
// Bound: the tensor-core rate at every layer but conv1_x (9 Cin multiply-adds
// per output element; bf16 needs 295 FLOP per byte of device memory, and the
// convs from conv2_2 on carry thousands). The second limit is shared memory:
// it moves 128 bytes per clock per SM against 4096 bf16 FLOP, so a design must
// carry more than 32 FLOP per byte of shared-memory traffic.
//
// Design: an implicit GEMM (the patch matrix never exists), persistent, warp
// specialised. A tile is 256 output pixels of one image (TR x TC in {16 x 16,
// 32 x 8, 8 x 32}, chosen by the wrapper for the least padding) x N output
// channels (128, 64 or 16 by Co); K = 9 taps x Cin_p (Cin rounded up to 16),
// taken 16 channels per ring step. Each block walks tiles blockIdx.x + i x
// gridDim.x (channel tile fastest) with 384 threads:
// - one producer warpgroup fills a ring of 4 (N 128), 6 (N 64) or 8 (N 16)
//   stages. A step's weights arrive by one cp.async.bulk counted on the
//   stage's full mbarrier: pack_weights stores them in the order the B
//   descriptor reads (no swizzle, K-major: 8 x 8 core matrices of 128
//   contiguous bytes, LBO 128, SBO 256). The halo, (TR + 2) x (TC + 2) pixels
//   x 16 channels, arrives by 16-byte cp.async copies, zero-filled outside the
//   image and past Cin, columns taken mod W when circular (Cin % 8 != 0, i.e.
//   conv1_1, is copied element by element). A producer marks its share of a
//   step full one step later, after cp.async.wait_group and a proxy fence, so
//   that the async proxy of wgmma sees the copies.
// - two consumer warpgroups each own two 8 x 8 blocks of the tile (64 rows of
//   M each) and issue wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) with
//   A and B both read from shared memory: the halo is stored as two planes of
//   8 channels x pixel x 16 bytes, so an 8 x 8 block at tap (dy, dx) is a
//   no-swizzle K-major descriptor (LBO one plane, SBO one halo row) whose
//   start moves by (dy (TC + 2) + dx) x 16 bytes. One commit group per step,
//   waited one step behind; the stage is then released on its empty mbarrier.
// - the epilogue adds the bias (staged in shared memory) in f32, applies ReLU,
//   rounds once to bf16, and per 32 channels passes each warp's 16 x 32 block
//   through 1,280 bytes of staging (stmatrix in, 16-byte loads out) to
//   16-byte stores, 4 lanes per pixel.
// Budget (N 128 / 64 / 16): shared memory 190,976 / 175,872 / 123,904 bytes of
// ring + 64 to 128 of barriers + 10,240 of epilogue staging + 4 Co of bias;
// ptxas: 168 / 119 / 55 registers, no spills. Shared-memory traffic per step at N 128: wgmma reads
// 2 x 9 x 2 x (2 KB of A + 4 KB of B) = 216 KB and the ring takes 47.7 KB,
// against 9.4 MFLOP: 36 FLOP per byte (27 at N 64, where conv1_x is bound by
// device memory anyway).
// Where the time goes (profile_conv.py: clock64 per tile, and copies of this
// kernel without its copies or without its wgmma): PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kConsumers = 256;      // two warpgroups of wgmma
constexpr int kProducers = 128;      // one warpgroup of copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kTilePix = 256;        // output pixels per tile: four 8 x 8 blocks
constexpr int kStep = 16;            // input channels per ring step (one k16 of wgmma)
constexpr int kHaloMaxPix = 34 * 10; // the largest halo, of a 32 x 8 or 8 x 32 tile
constexpr int kPlaneBytes = kHaloMaxPix * 16;  // one 8-channel group of the halo
constexpr int kHaloBytes = 2 * kPlaneBytes;
constexpr int kSlots = (kHaloMaxPix + kProducers / 2 - 1) / (kProducers / 2);  // pixels per producer
// Epilogue staging of one consumer warp: 16 pixels x 32 channels, rows 80
// bytes apart so that the 8 rows of a stmatrix land in distinct banks.
constexpr int kOutPitch = 80;
constexpr int kOutWarpBytes = 16 * kOutPitch;

template <int N>
struct Ring {
  static constexpr int kWBytes = 9 * kStep * N * 2;                 // one step's weights
  static constexpr int kStages = N == 128 ? 4 : N == 64 ? 6 : 8;    // as many as fit
  static constexpr int kBarOffset = kStages * (kWBytes + kHaloBytes);
  static constexpr int kOutOffset = kBarOffset + 2 * kStages * sizeof(uint64_t);
  static constexpr size_t kSmemBytes = kOutOffset + (kConsumers / 32) * kOutWarpBytes;
  static_assert(kSmemBytes <= 232448, "fits the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16) into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// 16 bytes from global memory, or 16 zeros when `src_bytes` is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
// Four 8 x 8 bf16 matrices from the mma fragment layout into shared memory.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0),
               "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}
// Orders this thread's generic-proxy shared-memory writes (cp.async, st.shared)
// before the async-proxy reads of wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// No-swizzle K-major matrix descriptor: start address, LBO (bytes to the next
// core matrix along K) and SBO (bytes to the next 8 rows of M or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keeps the compiler from moving register uses across a wgmma wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[64 x N] += a[64 x 16] * b[16 x N], both read from shared memory through descriptors.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// A tile: channel tile (fastest), then 256-pixel tile, then image.
struct TileIndex {
  int co0, r0, c0, b;
};

template <int N>
__device__ __forceinline__ TileIndex tile_index(int t, int co_tiles, int sp_tiles, int tiles_x,
                                                int tr, int tc) {
  const int sp = (t / co_tiles) % sp_tiles;
  return {(t % co_tiles) * N, (sp / tiles_x) * tr, (sp % tiles_x) * tc, t / co_tiles / sp_tiles};
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
                    int Cin, int cin_p, int Co, int tc_log2, int tiles_x, int sp_tiles, int tiles,
                    int circular, int relu) {
  using R = Ring<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  // [kStages][a step's weights, pack_weights' order]
  // [kStages][halo: 2 planes of 8 channels x pixel x 16 B] [full barriers][empty barriers]
  // [bias, f32]
  const uint32_t ws0 = smem_addr(smem);
  const uint32_t xs0 = ws0 + R::kStages * R::kWBytes;
  const uint32_t full0 = ws0 + R::kBarOffset;
  const uint32_t empty0 = full0 + R::kStages * sizeof(uint64_t);

  const int tid = threadIdx.x;
  const int tc = 1 << tc_log2;
  const int tr = kTilePix >> tc_log2;
  const int hc = tc + 2;  // halo columns
  const int halo_pix = (tr + 2) * hc;
  const int co_tiles = (Co + N - 1) / N;
  const int steps = cin_p / kStep;  // per tile

  float* bias_s = reinterpret_cast<float*>(smem + R::kSmemBytes);  // bias[0 .. Co)
  for (int i = tid; i < Co; i += kThreads) bias_s[i] = bias[i];
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full0 + 8 * s, kProducers + 1);    // each producer + the weights' expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producers: ring step k (tile by tile, 16 channels at a time) into
    // stage k % kStages once the consumers have released step k - kStages.
    // A thread marks its part of step k full once its copies have landed,
    // after it has issued step k + 1.
    const int p = tid - kConsumers;
    const bool vec_x = (Cin % 8) == 0;
    int k = 0;
    auto mark_full = [&](int step) {
      fence_proxy_async();
      mbar_arrive(full0 + 8 * (step % R::kStages));
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_index<N>(t, co_tiles, sp_tiles, tiles_x, tr, tc);
      // This thread's halo pixels p / 2 + 64 i (channel group p % 2) -> pixel
      // index in x, or -1 outside the image (zeros).
      int src_pix[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int pix = p / 2 + (kProducers / 2) * i;
        const int gr = ti.r0 - 1 + pix / hc;
        int gc = ti.c0 - 1 + pix % hc;
        bool ok = pix < halo_pix && gr >= 0 && gr < H;
        if (circular) {
          gc = ((gc % W) + W) % W;
        } else {
          ok = ok && gc >= 0 && gc < W;
        }
        src_pix[i] = ok ? (ti.b * H + gr) * W + gc : -1;
      }
      const __nv_bfloat16* wt = w + static_cast<size_t>(ti.co0) * 9 * cin_p;
      for (int c = 0; c < steps; ++c, ++k) {
        const int st = k % R::kStages;
        const int k0 = c * kStep;
        const uint32_t full = full0 + 8 * st;
        if (k >= R::kStages) mbar_wait(empty0 + 8 * st, (k / R::kStages - 1) & 1);
        if (p == 0) {  // weights: 9 x N x 16 bf16, contiguous in the packed tensor
          mbar_arrive_expect_tx(full, R::kWBytes);
          bulk_copy(ws0 + st * R::kWBytes, wt + static_cast<size_t>(9) * k0 * N, R::kWBytes, full);
        }
        const uint32_t xs = xs0 + st * kHaloBytes + (p % 2) * kPlaneBytes + (p / 2) * 16;
        const int ch = k0 + 8 * (p % 2);
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (p / 2 + (kProducers / 2) * i >= halo_pix) break;
          const uint32_t dst = xs + (kProducers / 2) * i * 16;
          if (vec_x) {
            const bool ok = src_pix[i] >= 0 && ch < Cin;  // else 16 zeros
            cp_async16(dst, ok ? x + static_cast<size_t>(src_pix[i]) * Cin + ch : x, ok ? 16 : 0);
          } else {  // Cin % 8 != 0 (conv1_1): element by element, zero past Cin
            const __nv_bfloat16* src = x + static_cast<size_t>(src_pix[i] < 0 ? 0 : src_pix[i]) * Cin;
            __align__(16) __nv_bfloat16 e[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              e[j] = (src_pix[i] >= 0 && ch + j < Cin) ? src[ch + j] : __float2bfloat16_rn(0.f);
            }
            *reinterpret_cast<uint4*>(smem + (dst - ws0)) = *reinterpret_cast<const uint4*>(e);
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
    uint32_t a_off[2];  // halo offset of each block's top-left pixel, tap (0, 0)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int blk = 2 * (warp / 4) + mb;
      a_off[mb] = ((blk / blocks_x) * 8 * hc + (blk % blocks_x) * 8) * 16;
    }
    int k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileIndex ti = tile_index<N>(t, co_tiles, sp_tiles, tiles_x, tr, tc);
      float acc[2][N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[0][i] = acc[1][i] = 0.f;

      for (int c = 0; c < steps; ++c, ++k) {
        const int st = k % R::kStages;
        mbar_wait(full0 + 8 * st, (k / R::kStages) & 1);
        const uint32_t w_base = ws0 + st * R::kWBytes;
        const uint32_t x_base = xs0 + st * kHaloBytes;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          // B: N rows of 16 channels, core matrices 128 B apart along K, 256 B per 8 rows.
          const uint64_t b = desc(w_base + tap * N * 32, 128, 256);
          const uint32_t shift = ((tap / 3) * hc + tap % 3) * 16;
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            // A: 8 x 8 pixels, one plane apart along K, one halo row per 8 rows.
            wgmma_ss<N>(acc[mb], desc(x_base + a_off[mb] + shift, kPlaneBytes, hc * 16), b);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step is done: release its stage
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % R::kStages));
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        fence_operand(acc[0][i]);
        fence_operand(acc[1][i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % R::kStages));  // the tile's last step

      // Epilogue: bias in f32, ReLU, one rounding to bf16; per 32 channels,
      // the warp's 16 x 32 block goes through its staging by stmatrix and
      // leaves as 16-byte stores, 4 lanes per pixel.
      const int t4 = lane % 4;
      const uint32_t stage = ws0 + R::kOutOffset + warp * kOutWarpBytes;
      // stmatrix row address of this lane: matrix lane / 8 is (group (lane / 16), half (lane / 8) % 2)
      const uint32_t st_addr = stage + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kOutPitch + (lane >> 4) * 16;
#pragma unroll
      for (int jj = 0; jj < (N + 31) / 32; ++jj) {
        float2 bb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int co = ti.co0 + 8 * (4 * jj + u) + 2 * t4;
          bb[u] = (4 * jj + u < N / 8 && co < Co) ? *reinterpret_cast<const float2*>(bias_s + co)
                                                   : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          uint32_t v[4][2];  // [group u][row half h]: channels 8 (4 jj + u) + 2 t4, +1
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              v[u][h] = 0u;
              if (4 * jj + u < N / 8) {
                const int j = 4 * jj + u;
                float y0 = __fadd_rn(acc[mb][4 * j + 2 * h], bb[u].x);
                float y1 = __fadd_rn(acc[mb][4 * j + 2 * h + 1], bb[u].y);
                if (relu) {
                  y0 = fmaxf(y0, 0.f);
                  y1 = fmaxf(y1, 0.f);
                }
                const __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
                v[u][h] = *reinterpret_cast<const uint32_t*>(&pair);
              }
            }
          }
          stmatrix_x4(st_addr, v[0][0], v[0][1], v[1][0], v[1][1]);
          if (N > 16) stmatrix_x4(st_addr + 32, v[2][0], v[2][1], v[3][0], v[3][1]);
          __syncwarp();
          const int blk = 2 * (warp / 4) + mb;
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            const int row = lane / 4 + 8 * it;  // staging row: pixel (2 (warp % 4) + row / 8, row % 8) of the block
            const int co = ti.co0 + 32 * jj + 8 * t4;
            const int r = ti.r0 + (blk / blocks_x) * 8 + 2 * (warp % 4) + row / 8;
            const int col = ti.c0 + (blk % blocks_x) * 8 + row % 8;
            const uint4 o = lds128(stage + row * kOutPitch + 16 * t4);
            if (32 * jj + 8 * t4 < N && co < Co && r < H && col < W) {
              *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(ti.b) * H + r) * W + col) * Co + co) = o;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int N>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, int Cin,
           int cin_p, int Co, int tc_log2, int circular, int relu, cudaStream_t stream) {
  const auto kernel = conv3x3_bf16_kernel<N>;
  const int smem = static_cast<int>(Ring<N>::kSmemBytes) + Co * 4;  // the ring, the bias
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tc = 1 << tc_log2;
  const int tr = kTilePix / tc;
  const int tiles_x = (W + tc - 1) / tc;
  const int sp_tiles = ((H + tr - 1) / tr) * tiles_x;
  const long long tiles = static_cast<long long>((Co + N - 1) / N) * sp_tiles * B;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // Persistent: one block per resident slot, each walking tiles blockIdx.x + i * gridDim.x.
  const int grid = static_cast<int>(tiles < 1LL * sms * per_sm ? tiles : 1LL * sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Cin, cin_p, Co,
      tc_log2, tiles_x, sp_tiles, static_cast<int>(tiles), circular, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x bf16 [B, H, W, Cin]; w bf16 from pack_weights for a channel tile of
// tile_n (128, 64 or 16) and cin_p = Cin rounded up to a multiple of 16;
// bias f32 [Co]; out bf16 [B, H, W, Co]. Co % 8 == 0; the output tile is
// (256 >> tc_log2) x (1 << tc_log2) pixels, tc_log2 in 3..5; all contiguous
// and 16-byte aligned, B H W < 2^31 (checked by ops/conv3x3.py). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int witw_conv3x3_bf16(const void* x, const void* w, const void* bias, void* out, int B, int H,
                      int W, int Cin, int cin_p, int Co, int tile_n, int tc_log2, int circular,
                      int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  if (tc_log2 < 3 || tc_log2 > 5 || cin_p % kStep != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_n) {
    case 128: return launch<128>(x, w, bias, out, B, H, W, Cin, cin_p, Co, tc_log2, circular, relu, s);
    case 64: return launch<64>(x, w, bias, out, B, H, W, Cin, cin_p, Co, tc_log2, circular, relu, s);
    case 16: return launch<16>(x, w, bias, out, B, H, W, Cin, cin_p, Co, tc_log2, circular, relu, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
