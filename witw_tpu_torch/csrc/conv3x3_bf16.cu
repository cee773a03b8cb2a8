// bf16 3x3 stride-1 convolution + bias (+ReLU) on the tensor cores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels exp/pallas_conv3x3.py:conv3x3_bias_relu
// (NHWC, zero or circular width padding) and
// exp/pallas_conv3x3.py:conv3x3_bias_relu_cw (the same function in the
// TPU-lane layout [B, H, C, W]). For x bf16 [B, H, W, Cin] (NHWC), packed
// weights bf16 [Co, 3, 3, Cin_p] (Cin zero-padded to a multiple of 16) and
// bias f32 [Co]:
//
//   acc[b, r, c, o] = sum_{dy, dx, ci} x[b, r + dy - 1, c + dx - 1, ci] * w[o, dy, dx, ci]
//   y = bf16_rn(max(acc + bias[o], 0))          (f32 accumulation, one rounding)
//
// with the height zero-padded by 1, and the width zero-padded by 1 or, with
// `circular`, read modulo W (the overhead tower's wrapping panorama).
//
// Bound: at the towers' shapes the tensor-core rate (9 * Cin multiply-adds
// per output element against 2 bytes of output and 2 * Cin / 9 bytes of
// input, per pixel: far above the 295 FLOP per byte where an H100 turns
// compute-bound in bf16). The separate bias and ReLU passes that PyTorch
// runs after cuDNN's conv are memory passes; here they are the epilogue.
//
// Design: an implicit GEMM through mma.sync m16n8k16 (bf16 in, f32
// accumulate). One block of 8 warps per (8 x 16 output pixels, 64 output
// channels, image): M = 128 pixels, N = 64 channels, K = 9 * Cin_p streamed
// 32 input channels at a time. Each step stages the tile's input halo
// (10 x 18 pixels x 32 channels, zero outside the image and past Cin; its
// columns taken mod W when circular) and the weight chunk [64][9][32] in
// shared memory, with row strides padded so that the fragment loads of a
// warp hit 32 distinct banks. Warp w computes tile rows 2 (w % 4) and
// 2 (w % 4) + 1 against channels 32 (w / 4) .. +31: 2 x 4 mma tiles, 9 taps
// x 2 k16 steps per chunk. The epilogue adds the bias in f32, applies ReLU,
// rounds once to bf16, stages the 128 x 64 tile in shared memory and
// writes it with 16-byte stores. Cin 3 or 5 (conv1_1) runs as 16 channels,
// the padding's products wasted. No cp.async or TMA pipelining yet: loads
// and mma alternate (later work: wgmma and TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;
constexpr int kTileCols = 16;
constexpr int kTileCo = 64;
constexpr int kChunk = 32;                        // input channels per step
constexpr int kXRows = kTileRows + 2;
constexpr int kXCols = kTileCols + 2;
constexpr int kXPixWords = kChunk / 2 + 4;        // 16 words of data + 4 of padding
constexpr int kXWords = kXRows * kXCols * kXPixWords;
constexpr int kWCoWords = 9 * kChunk / 2 + 4;     // 144 words of data + 4 of padding
constexpr int kWWords = kTileCo * kWCoWords;
constexpr int kOutPixWords = kTileCo / 2 + 4;     // epilogue staging: 32 + 4
constexpr int kOutWords = kTileRows * kTileCols * kOutPixWords;
constexpr size_t kSmemBytes = sizeof(uint32_t) * (kXWords + kWWords);
static_assert(kOutWords <= kWWords, "the epilogue reuses the weight buffer");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
                    int Cin, int cin_p, int Co, int circular, int relu) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;            // [10][18][20 words]: 32 channels + padding per pixel
  uint32_t* ws = smem + kXWords;  // [64 co][148 words]: [9 taps][32 channels] + padding

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int group = lane / 4;  // mma row (A, C) / column (B) within a fragment
  const int tig = lane % 4;    // thread in group
  const int wm = warp % 4;     // tile rows 2 wm, 2 wm + 1
  const int wn = warp / 4;     // channels 32 wn .. 32 wn + 31
  const int co_tiles = (Co + kTileCo - 1) / kTileCo;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kTileCo;
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileCols;
  const bool vec_x = (Cin % 8) == 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
    }
  }

  for (int k0 = 0; k0 < cin_p; k0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    // Input halo: 180 pixels x 4 groups of 8 channels.
    for (int i = tid; i < kXRows * kXCols * 4; i += kThreads) {
      const int q = i % 4;
      const int pix = i / 4;
      const int gr = r0 - 1 + pix / kXCols;
      int gc = c0 - 1 + pix % kXCols;
      bool ok = gr >= 0 && gr < H;
      if (circular) {
        gc = ((gc % W) + W) % W;
      } else {
        ok = ok && gc >= 0 && gc < W;
      }
      const int ch = k0 + 8 * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok && ch < Cin) {
        const __nv_bfloat16* src = x + ((static_cast<size_t>(b) * H + gr) * W + gc) * Cin + ch;
        if (vec_x) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {  // Cin 3 or 5: element by element, zero past Cin
          __align__(16) __nv_bfloat16 e[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) e[t] = (ch + t < Cin) ? src[t] : __float2bfloat16_rn(0.f);
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(xs + pix * kXPixWords + 4 * q) = v;
    }
    // Weight chunk: 64 co x 9 taps x 4 groups of 8 channels.
    for (int i = tid; i < kTileCo * 9 * 4; i += kThreads) {
      const int q = i % 4;
      const int t = (i / 4) % 9;
      const int co = i / 36;
      const int ch = k0 + 8 * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co0 + co < Co && ch < cin_p) {
        v = *reinterpret_cast<const uint4*>(w + (static_cast<size_t>(co0 + co) * 9 + t) * cin_p + ch);
      }
      *reinterpret_cast<uint4*>(ws + co * kWCoWords + t * (kChunk / 2) + 4 * q) = v;
    }
    __syncthreads();

    const int ksteps = min(2, (cin_p - k0) / 16);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      for (int s = 0; s < ksteps; ++s) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = 2 * wm + i + dy;
          const uint32_t* p0 = xs + (row * kXCols + group + dx) * kXPixWords + 8 * s + tig;
          const uint32_t* p1 = p0 + 8 * kXPixWords;  // pixel column group + 8
          a[i][0] = p0[0];
          a[i][1] = p1[0];
          a[i][2] = p0[4];
          a[i][3] = p1[4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t* pb = ws + (32 * wn + 8 * j + group) * kWCoWords + tap * (kChunk / 2) + 8 * s + tig;
          const uint32_t bf[2] = {pb[0], pb[4]};
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], bf);
        }
      }
    }
  }

  // Epilogue: bias, ReLU, one rounding, staged for 16-byte stores.
  __syncthreads();  // every warp is done with ws
  uint32_t* os = ws;  // [128 pixels][36 words]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 32 * wn + 8 * j + 2 * tig;
    const float b0 = (co0 + n < Co) ? bias[co0 + n] : 0.f;
    const float b1 = (co0 + n + 1 < Co) ? bias[co0 + n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // pixel column group, group + 8
        float y0 = __fadd_rn(acc[i][j][2 * h], b0);
        float y1 = __fadd_rn(acc[i][j][2 * h + 1], b1);
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        const int pix = (2 * wm + i) * kTileCols + group + 8 * h;
        os[pix * kOutPixWords + n / 2] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTileRows * kTileCols * (kTileCo / 8); i += kThreads) {
    const int q = i % (kTileCo / 8);
    const int pix = i / (kTileCo / 8);
    const int r = r0 + pix / kTileCols;
    const int c = c0 + pix % kTileCols;
    const int co = co0 + 8 * q;
    if (r < H && c < W && co < Co) {  // Co % 8 == 0: a group is all in or all out
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * H + r) * W + c) * Co + co) =
          *reinterpret_cast<const uint4*>(os + pix * kOutPixWords + 4 * q);
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
size_t witw_conv3x3_bf16_smem_bytes() { return kSmemBytes; }

// x bf16 [B, H, W, Cin]; w bf16 [Co, 3, 3, cin_p] with cin_p = Cin rounded
// up to a multiple of 16 (zeros past Cin); bias f32 [Co]; out bf16
// [B, H, W, Co]. Co % 8 == 0; all contiguous and 16-byte aligned (checked by
// ops/conv3x3.py). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int witw_conv3x3_bf16(const void* x, const void* w, const void* bias, void* out, int B, int H,
                      int W, int Cin, int cin_p, int Co, int circular, int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + kTileCols - 1) / kTileCols, (H + kTileRows - 1) / kTileRows,
                  B * ((Co + kTileCo - 1) / kTileCo));
  conv3x3_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Cin, cin_p, Co,
      circular, relu);
  return static_cast<int>(cudaGetLastError());
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
