// Int8 3x3 convolution with a fused requant (or dequant) epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels exp/int8_conv_pallas.py:conv3x3_int8,
// exp/int8_conv_v2.py:conv3x3_int8_v2 (the same function, a whole image per
// grid step) and exp/r4_conv_taps.py:conv3x3_int8_taps (its circular-width
// form). For x int8 [B, H, W, Cin] (NHWC) and packed weights int8
// [Co, 3, 3, Cin_p]:
//
//   acc[b, r, c, o] = sum_{dy, dx, ci} x[b, r*sh + dy - 1, c + dx - pad_w, ci]
//                                      * w[o, dy, dx, ci]     (int32, exact)
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
// Bound: the __dp4a issue rate of the CUDA cores (no tensor cores yet). Each
// output costs 9 * Cin / 4 dp4a; the tile reuses every staged input word for
// 64 output channels and every staged weight word for 128 pixels. Per
// 4-word group a thread issues 12 16-byte shared loads for 128 dp4a.
//
// Design: one block per (8 x 16 output tile, 64 output channels, image).
// Input channels stream through shared memory 32 at a time: the block stages
// the tile's input halo ((8-1)*sh + 3 rows x 18 columns x 32 channels, zero
// outside the image and past Cin) and the matching weight chunk, then every
// thread accumulates its 8 pixels x 4 channels (int8_common.cuh). Cin not a
// multiple of 4 (conv1_1: 3 or 5 channels) is read byte by byte into words
// whose missing channels are zero. Ragged tiles are masked on store.

#include "int8_common.cuh"

namespace {

using namespace witw;

constexpr int kTileRows = 8;   // output rows per block (= kPix)
constexpr int kTileCols = 16;  // output columns per block (= 256 / 16 threads)
constexpr int kMaxStride = 2;
constexpr int kXRows = (kTileRows - 1) * kMaxStride + 3;
constexpr int kXCols = kTileCols + 2;

// Input word (channels c .. c+3) of the pixel starting at x + off.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ x, size_t off, int c, int Cin) {
  if ((Cin & 3) == 0) return *reinterpret_cast<const int*>(x + off + c);
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c + k < Cin) v |= (static_cast<unsigned>(static_cast<uint8_t>(x[off + c + k]))) << (8 * k);
  }
  return static_cast<int>(v);
}

template <bool kDequant>
__global__ void __launch_bounds__(kThreads)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int* __restrict__ w,
                    const int* __restrict__ bias_q, const float* __restrict__ scale,
                    const float* __restrict__ bias_f, void* __restrict__ out, int H, int W,
                    int Cin, int cin_words, int Co, int Ho, int Wo, int sh, int pad_w, float lo) {
  __shared__ __align__(16) int xs[kXRows * kXCols * kChunkWords];
  __shared__ __align__(16) int ws[kWChunkInts];

  const int tid = threadIdx.x;
  const int tn = tid % 16;
  const int tm = tid / 16;
  const int co_tiles = (Co + kTileCo - 1) / kTileCo;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kTileCo;
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileCols;
  const int in_r0 = r0 * sh - 1;
  const int in_c0 = c0 - pad_w;
  const int rows_in = (kTileRows - 1) * sh + 3;
  const int row_words = kXCols * kChunkWords;

  int base[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) base[i] = (i * sh * kXCols + tm) * kChunkWords;

  int acc[kPix][4];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  for (int cw0 = 0; cw0 < cin_words; cw0 += kChunkWords) {
    const int nw = min(kChunkWords, cin_words - cw0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < rows_in * kXCols * kChunkWords; i += kThreads) {
      const int wd = i % kChunkWords;
      const int pix = i / kChunkWords;
      const int gr = in_r0 + pix / kXCols;
      const int gc = in_c0 + pix % kXCols;
      int v = 0;
      if (wd < nw && gr >= 0 && gr < H && gc >= 0 && gc < W) {
        const size_t off = ((static_cast<size_t>(b) * H + gr) * W + gc) * Cin;
        v = load_word(x, off, 4 * (cw0 + wd), Cin);
      }
      xs[i] = v;
    }
    load_weight_chunk(ws, w, Co, cin_words, co0, cw0, nw);
    __syncthreads();
    accumulate_chunk(acc, xs, base, row_words, kChunkWords, 0, ws, (nw + 3) / 4, tn);
  }

  const int co = co0 + 4 * tn;
  const int c = c0 + tm;
  if (co >= Co || c >= Wo) return;  // Co % 4 == 0: a group is all in or all out
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int r = r0 + i;
    if (r >= Ho) break;
    const size_t o = ((static_cast<size_t>(b) * Ho + r) * Wo + c) * Co + co;
    if constexpr (kDequant) {
      float4 y;
      y.x = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][0]), scale[co + 0]), bias_f[co + 0]);
      y.y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][1]), scale[co + 1]), bias_f[co + 1]);
      y.z = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][2]), scale[co + 2]), bias_f[co + 2]);
      y.w = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][3]), scale[co + 3]), bias_f[co + 3]);
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = y;
    } else {
      *reinterpret_cast<int*>(static_cast<int8_t*>(out) + o) = requant_pack(acc[i], bias_q, scale, co, lo);
    }
  }
}

template <bool kDequant>
int launch(const void* x, const void* w, const void* bias_q, const void* scale,
           const void* bias_f, void* out, int B, int H, int W, int Cin, int cin_p, int Co,
           int sh, int pad_w, float lo, void* stream) {
  const int Ho = (H - 1) / sh + 1;
  const int Wo = W + 2 * pad_w - 2;
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Co <= 0) return 0;
  const dim3 grid((Wo + kTileCols - 1) / kTileCols, (Ho + kTileRows - 1) / kTileRows,
                  B * ((Co + kTileCo - 1) / kTileCo));
  conv3x3_int8_kernel<kDequant><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(w),
      static_cast<const int*>(bias_q), static_cast<const float*>(scale),
      static_cast<const float*>(bias_f), out, H, W, Cin, cin_p / 4, Co, Ho, Wo, sh, pad_w, lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int8 out [B, Ho, Wo, Co]; lo is 0 (ReLU folded) or -127. Launches on
// `stream` and returns cudaGetLastError() (0 on success). The wrapper
// (ops/int8_conv.py) checks shapes, Co % 4 == 0, Cin_p = Cin rounded up to
// a multiple of 4, sh in {1, 2}, pad_w in {0, 1} and 16-byte alignment.
int witw_conv3x3_int8(const void* x, const void* w, const void* bias_q, const void* m, void* out,
                      int B, int H, int W, int Cin, int cin_p, int Co, int sh, int pad_w, int relu,
                      void* stream) {
  return launch<false>(x, w, bias_q, m, nullptr, out, B, H, W, Cin, cin_p, Co, sh, pad_w,
                       relu ? 0.f : -127.f, stream);
}

// f32 out [B, Ho, Wo, Co] = float(acc) * dequant + bias_f (no bias_q).
int witw_conv3x3_int8_dequant(const void* x, const void* w, const void* dequant,
                              const void* bias_f, void* out, int B, int H, int W, int Cin,
                              int cin_p, int Co, int sh, int pad_w, void* stream) {
  return launch<true>(x, w, nullptr, dequant, bias_f, out, B, H, W, Cin, cin_p, Co, sh, pad_w,
                      0.f, stream);
}

}  // extern "C"
