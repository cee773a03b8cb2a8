// VGG block 2 of the static-int8 towers in one pass, for Hopper (sm_90a):
// conv2_1 -> requant -> conv2_2 -> requant -> 2x2 max pool, with conv2_1's
// output kept in shared memory.
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
// width-VALID convs). Weights are the packed int8 [128, 3, 3, Cin] form.
//
// The trap (exp/fused_block2.py:68-76): conv2_2's padding is zeros of y1,
// not conv2_1 evaluated outside the image. So y1's halo rows -1 and H are
// zero, and with zero width padding so are its columns -1 and W. With
// `circular`, y1 at column -1 is conv2_1 at column W-1 (and W at 0): the
// input tile is read with its columns taken mod W, which makes conv2_1
// circular, and its halo columns come out right without masking.
//
// Bound: the __dp4a issue rate, as int8_conv.cu, plus the halo: a block
// recomputes conv2_1 on an 18 x 18 tile for 16 x 16 conv2_2 outputs, in 3
// passes of 128 pixels. y1 never reaches device memory: per image of the
// CVUSA surface tower that saves writing and reading 2 MB.
//
// Design: one block per (8 x 8 pool-2 outputs, image), 256 threads, 85.5 KB
// of dynamic shared memory: the input tile x (20 x 20 pixels x 64 ch), the
// y1 tile (18 x 18 x 128) and one weight chunk (int8_common.cuh). Stage 1
// computes y1 in 64-channel halves and writes it, requantized and masked,
// into shared memory. Stage 2 computes conv2_2 for two 8 x 16 halves of the
// tile; each thread then pools its 8 rows in pairs and the column pairs of
// neighbouring threads (lanes 16 apart) with a shuffle, using __vmaxs4 on
// 4 packed channels.

#include "int8_common.cuh"

namespace {

using namespace witw;

constexpr int kCin = 64;
constexpr int kC = 128;
constexpr int kPoolTile = 8;                 // pool-2 outputs per block side
constexpr int kOut = 2 * kPoolTile;          // conv2_2 outputs per block side
constexpr int kY1 = kOut + 2;                // y1 tile side
constexpr int kX = kOut + 4;                 // input tile side
constexpr int kXWords = kCin / 4;
constexpr int kY1Words = kC / 4;
constexpr int kY1Pixels = kY1 * kY1;
constexpr int kXInts = kX * kX * kXWords;
constexpr int kY1Ints = kY1Pixels * kY1Words;
constexpr size_t kSmemBytes = sizeof(int) * (kXInts + kY1Ints + kWChunkInts);

__global__ void __launch_bounds__(kThreads)
fused_block2_kernel(const int8_t* __restrict__ x, const int* __restrict__ w1,
                    const int* __restrict__ b1, const float* __restrict__ m1,
                    const int* __restrict__ w2, const int* __restrict__ b2,
                    const float* __restrict__ m2, int8_t* __restrict__ out, int H, int W, int Hp,
                    int Wp, int circular) {
  extern __shared__ __align__(16) int smem[];
  int* xs = smem;             // [kX][kX][16]
  int* y1 = xs + kXInts;      // [kY1][kY1][32]
  int* ws = y1 + kY1Ints;     // [9][8][64]

  const int tid = threadIdx.x;
  const int tn = tid % 16;
  const int tm = tid / 16;
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * kPoolTile;
  const int pc0 = blockIdx.x * kPoolTile;
  const int r0 = 2 * pr0;  // first conv2_2 output row / column of the tile
  const int c0 = 2 * pc0;

  const int* xw = reinterpret_cast<const int*>(x);
  for (int i = tid; i < kXInts; i += kThreads) {
    const int wd = i % kXWords;
    const int pix = i / kXWords;
    const int gr = r0 - 2 + pix / kX;
    int gc = c0 - 2 + pix % kX;
    bool ok = gr >= 0 && gr < H;
    if (circular) {
      gc = ((gc % W) + W) % W;
    } else {
      ok = ok && gc >= 0 && gc < W;
    }
    xs[i] = ok ? xw[((static_cast<size_t>(b) * H + gr) * W + gc) * kXWords + wd] : 0;
  }

  int acc[kPix][4];
  int base[kPix];

  // Stage 1: y1 over the 18 x 18 tile (origin r0-1, c0-1), 128 pixels a pass.
  for (int p0 = 0; p0 < kY1Pixels; p0 += kPix * 16) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = p0 + tm + 16 * i;
      base[i] = p < kY1Pixels ? ((p / kY1) * kX + p % kY1) * kXWords : 0;
    }
    for (int h = 0; h < kC / kTileCo; ++h) {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      }
      for (int k = 0; k < kXWords / kChunkWords; ++k) {
        __syncthreads();
        load_weight_chunk(ws, w1, kC, kXWords, h * kTileCo, k * kChunkWords, kChunkWords);
        __syncthreads();
        accumulate_chunk(acc, xs, base, kX * kXWords, kXWords, k * kChunkWords, ws, 2, tn);
      }
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int p = p0 + tm + 16 * i;
        if (p >= kY1Pixels) continue;
        const int gr = r0 - 1 + p / kY1;
        const int gc = c0 - 1 + p % kY1;
        const bool ok = gr >= 0 && gr < H && (circular || (gc >= 0 && gc < W));
        y1[p * kY1Words + h * 16 + tn] =
            ok ? requant_pack(acc[i], b1, m1, h * kTileCo + 4 * tn, 0.f) : 0;
      }
    }
  }

  // Stage 2: conv2_2 over rows 8a .. 8a+7 of the 16 x 16 tile, then pool.
  int* outw = reinterpret_cast<int*>(out);
  for (int a = 0; a < kOut / kPix; ++a) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) base[i] = ((kPix * a + i) * kY1 + tm) * kY1Words;
    for (int h = 0; h < kC / kTileCo; ++h) {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      }
      for (int k = 0; k < kY1Words / kChunkWords; ++k) {
        __syncthreads();  // also orders stage 1's y1 writes before these reads
        load_weight_chunk(ws, w2, kC, kY1Words, h * kTileCo, k * kChunkWords, kChunkWords);
        __syncthreads();
        accumulate_chunk(acc, y1, base, kY1 * kY1Words, kY1Words, k * kChunkWords, ws, 2, tn);
      }
      int pooled[kPix / 2];
#pragma unroll
      for (int i = 0; i < kPix / 2; ++i) {
        const int q0 = requant_pack(acc[2 * i], b2, m2, h * kTileCo + 4 * tn, 0.f);
        const int q1 = requant_pack(acc[2 * i + 1], b2, m2, h * kTileCo + 4 * tn, 0.f);
        const int v = __vmaxs4(q0, q1);
        pooled[i] = __vmaxs4(v, __shfl_xor_sync(0xffffffffu, v, 16));  // column tm ^ 1
      }
      const int pc = pc0 + tm / 2;
      if ((tm & 1) == 0 && pc < Wp) {
#pragma unroll
        for (int i = 0; i < kPix / 2; ++i) {
          const int pr = pr0 + (kPix / 2) * a + i;
          if (pr < Hp) {
            outw[((static_cast<size_t>(b) * Hp + pr) * Wp + pc) * kY1Words + h * 16 + tn] =
                pooled[i];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (checked by the wrapper).
size_t witw_fused_block2_smem_bytes() { return kSmemBytes; }

// x int8 [B, H, W, 64]; w1 int8 [128, 3, 3, 64]; w2 int8 [128, 3, 3, 128];
// b1, b2 int32 [128]; m1, m2 f32 [128]; out int8 [B, H/2, W/2, 128]. All
// contiguous and 16-byte aligned (checked by ops/fused_block2.py). Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int witw_fused_block2(const void* x, const void* w1, const void* b1, const void* m1,
                      const void* w2, const void* b2, const void* m2, void* out, int B, int H,
                      int W, int circular, void* stream) {
  const int Hp = H / 2;
  const int Wp = W / 2;
  if (B <= 0 || Hp <= 0 || Wp <= 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_block2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Wp + kPoolTile - 1) / kPoolTile, (Hp + kPoolTile - 1) / kPoolTile, B);
  fused_block2_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(w1), static_cast<const int*>(b1),
      static_cast<const float*>(m1), static_cast<const int*>(w2), static_cast<const int*>(b2),
      static_cast<const float*>(m2), static_cast<int8_t*>(out), H, W, Hp, Wp, circular);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
