// Kernel A of the static-int8 towers (int8_conv.cu), with stages removed,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel exp/int8_isolate.py:conv_like, which ran
// the TPU's int8 conv kernel with its DMA or its patch build removed to see
// where its time went. The TPU's stages do not exist on Hopper, so this is
// the same decomposition of the port's own kernel A. For a pre-padded xp
// int8 [B, H + 2, WP, C] (columns >= W + 2 unused), packed weights int8
// [N, 3, 3, C] (wmat [9C, N] repacked by exp/int8_isolate.py) and m f32 [N]:
//
//   full: y[b, h, w, n] = clip(rint(float(sum_{dy, dx, c} xp[b, h + dy, w + dx, c]
//                                      * w[n, dy, dx, c]) * m[n]), 0, 127)   (int8)
//
//   nodma:   the input halo is never read from device memory: the shared
//            slab is zero-filled once per block; weight chunks are staged
//            as in full. full - nodma = the input's device-memory copies.
//   nopatch: the halo is staged from device memory as in full, but the
//            dp4a loop takes its x operands from a zero-filled shared buffer
//            read once per chunk, in place of the per-tap shifted reads.
//            full - nopatch = the shifted shared-memory operand reads.
//   What neither mode removes (the dp4a and the weight-operand reads) is
//   the rest of full's time.
//
// Both stripped modes compute zeros (zero operands, no bias). The TPU's
// left their scratch uninitialized; here they are defined. Every mode issues
// the same dp4a: the loop structure is kernel A's (int8_common.cuh), and
// chip_smoke.py counts IDP.4A in each instantiation's SASS.
//
// Bound: the __dp4a issue rate of the CUDA cores, as kernel A (9 C / 4 dp4a
// per output). Design: kernel A's tile (8 x 16 pixels x 64 channels per
// block, 32-channel chunks, 256 threads of 8 pixels x 4 channels); the input
// is pre-padded, so stride 1, no padding logic, and no height or width
// masking of the halo other than the array's own bounds.

#include "int8_common.cuh"

namespace {

using namespace witw;

constexpr int kTileRows = 8;   // output rows per block (= kPix)
constexpr int kTileCols = 16;  // output columns per block
constexpr int kXCols = kTileCols + 2;
constexpr int kXWords = (kTileRows + 2) * kXCols * kChunkWords;

enum Mode { kFull = 0, kNoPatch = 1, kNoDma = 2 };

// nopatch's dp4a loop: accumulate_chunk with the x operands of every tap
// and pixel taken from the two word groups zs[0..7], read once.
__device__ __forceinline__ void accumulate_resident(int (&acc)[kPix][4], const int* zs,
                                                    const int* ws, int ng, int tn) {
  const int4 x0 = *reinterpret_cast<const int4*>(zs);
  const int4 x1 = *reinterpret_cast<const int4*>(zs + 4);
  for (int t = 0; t < 9; ++t) {
    for (int g = 0; g < ng; ++g) {
      int4 wv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wv[k] = *reinterpret_cast<const int4*>(ws + (t * kChunkWords + 4 * g + k) * kTileCo + 4 * tn);
      }
      const int4 xv = g == 0 ? x0 : x1;
#pragma unroll
      for (int i = 0; i < kPix; ++i) dot_group(acc[i], xv, wv);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
conv_like_kernel(const int8_t* __restrict__ xp, const int* __restrict__ w,
                 const int* __restrict__ bias_q, const float* __restrict__ m,
                 int8_t* __restrict__ out, int Hp, int WP, int C, int cin_words, int N, int H,
                 int W) {
  // The halo slab, then 8 words that stay zero (nopatch's x operands).
  __shared__ __align__(16) int xs[kXWords + kChunkWords];
  __shared__ __align__(16) int ws[kWChunkInts];

  const int tid = threadIdx.x;
  const int tn = tid % 16;
  const int tm = tid / 16;
  const int co_tiles = (N + kTileCo - 1) / kTileCo;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kTileCo;
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileCols;

  int base[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) base[i] = (i * kXCols + tm) * kChunkWords;

  int acc[kPix][4];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  if (kMode != kFull) {
    for (int i = (kMode == kNoDma ? 0 : kXWords) + tid; i < kXWords + kChunkWords; i += kThreads) {
      xs[i] = 0;
    }
  }

  for (int cw0 = 0; cw0 < cin_words; cw0 += kChunkWords) {
    const int nw = min(kChunkWords, cin_words - cw0);
    __syncthreads();  // the previous chunk is consumed
    if (kMode != kNoDma) {
      for (int i = tid; i < kXWords; i += kThreads) {
        const int wd = i % kChunkWords;
        const int pix = i / kChunkWords;
        const int gr = r0 + pix / kXCols;
        const int gc = c0 + pix % kXCols;
        int v = 0;
        if (wd < nw && gr < Hp && gc < WP) {
          v = *reinterpret_cast<const int*>(
              xp + ((static_cast<size_t>(b) * Hp + gr) * WP + gc) * C + 4 * (cw0 + wd));
        }
        xs[i] = v;
      }
    }
    load_weight_chunk(ws, w, N, cin_words, co0, cw0, nw);
    __syncthreads();
    if (kMode == kNoPatch) {
      accumulate_resident(acc, xs + kXWords, ws, (nw + 3) / 4, tn);
    } else {
      accumulate_chunk(acc, xs, base, kXCols * kChunkWords, kChunkWords, 0, ws, (nw + 3) / 4, tn);
    }
  }

  const int co = co0 + 4 * tn;
  const int c = c0 + tm;
  if (co >= N || c >= W) return;  // N % 4 == 0: a group is all in or all out
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int r = r0 + i;
    if (r >= H) break;
    const size_t o = ((static_cast<size_t>(b) * H + r) * W + c) * N + co;
    *reinterpret_cast<int*>(out + o) = requant_pack(acc[i], bias_q, m, co, 0.f);
  }
}

}  // namespace

extern "C" {

// xp int8 [B, H + 2, WP, C], w int8 [N, 3, 3, C], bias_q int32 [N] (zeros),
// m f32 [N] -> out int8 [B, H, W, N]; mode 0 full, 1 nopatch, 2 nodma. C and
// N multiples of 4, W + 2 <= WP, all contiguous and 16-byte aligned (checked
// by exp/int8_isolate.py). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int witw_conv_like(const void* xp, const void* w, const void* bias_q, const void* m, void* out,
                   int B, int H, int WP, int C, int N, int W, int mode, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0) return 0;
  const dim3 grid((W + kTileCols - 1) / kTileCols, (H + kTileRows - 1) / kTileRows,
                  B * ((N + kTileCo - 1) / kTileCo));
  const auto launch = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xp), static_cast<const int*>(w),
        static_cast<const int*>(bias_q), static_cast<const float*>(m),
        static_cast<int8_t*>(out), H + 2, WP, C, C / 4, N, H, W);
  };
  switch (mode) {
    case kFull: launch(conv_like_kernel<kFull>); break;
    case kNoPatch: launch(conv_like_kernel<kNoPatch>); break;
    case kNoDma: launch(conv_like_kernel<kNoDma>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
