// The pieces of the __dp4a int8 3x3 conv kernel of conv_like.cu, the probe
// of kernel A's first, __dp4a design, for Hopper (sm_90a). Kernels A
// (int8_conv.cu) and C (fused_block2.cu) run on s8 wgmma and include
// int8_wgmma.cuh instead.
//
// The kernel is a direct convolution on int8 NHWC activations with an int32
// accumulator, computed with __dp4a (4 int8 products summed into an int32
// per instruction) on the CUDA cores.
//
// Thread layout (256 threads): tn = tid % 16 picks 4 consecutive output
// channels (4*tn .. 4*tn+3 of a 64-channel pass), tm = tid / 16 picks an
// output column; each thread holds 8 output pixels (rows 0..7 of the tile at
// column tm) x 4 channels = 32 int32 accumulators.
//
// Shared-memory layouts (all int32 words, one word = 4 int8 channels):
// - activations: pixel-major, `pix_words` words per pixel, so the 8 words of
//   one 4-word group are one 16-byte load; the two pixels a warp reads in one
//   load are broadcast to its 16 lanes each.
// - weights: one chunk of 8 input words (32 channels) for 64 output
//   channels, as [9 taps][8 words][64 co]: lane tn reads its 4 channels of
//   one word as one 16-byte load, and the 16 lanes read 256 contiguous bytes.
//
// Weights in device memory are the packed form that
// models/quantize.prepare_static_qparams builds: int8 [Co, 3, 3, Cin_p] with
// Cin zero-padded to a multiple of 4, i.e. int32 words [Co][9][Cin_p / 4].

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace witw {

constexpr int kThreads = 256;
constexpr int kTileCo = 64;      // output channels per pass
constexpr int kPix = 8;          // output pixels per thread (one tile column)
constexpr int kChunkWords = 8;   // input words (32 channels) per weight chunk
constexpr int kWChunkInts = 9 * kChunkWords * kTileCo;

// Stage w[co0 : co0+64, :, :, words word0 : word0+nw] into ws as
// [9][8][64], zero for co >= Co and for words >= nw. Consecutive threads
// read consecutive words of one (co, tap) row: 32-byte runs in device memory.
__device__ __forceinline__ void load_weight_chunk(int* ws, const int* __restrict__ w, int Co,
                                                  int cin_words, int co0, int word0, int nw) {
  for (int i = threadIdx.x; i < kWChunkInts; i += kThreads) {
    const int wd = i % kChunkWords;
    const int t = (i / kChunkWords) % 9;
    const int co = i / (kChunkWords * 9);
    int v = 0;
    if (co0 + co < Co && wd < nw) {
      v = w[(static_cast<size_t>(co0 + co) * 9 + t) * cin_words + word0 + wd];
    }
    ws[(t * kChunkWords + wd) * kTileCo + co] = v;
  }
}

// a[j] += <x word k, w word k of channel j> over the 4 words k of one group.
__device__ __forceinline__ void dot_group(int (&a)[4], const int4 xv, const int4 (&wv)[4]) {
  a[0] = __dp4a(xv.x, wv[0].x, a[0]);
  a[1] = __dp4a(xv.x, wv[0].y, a[1]);
  a[2] = __dp4a(xv.x, wv[0].z, a[2]);
  a[3] = __dp4a(xv.x, wv[0].w, a[3]);
  a[0] = __dp4a(xv.y, wv[1].x, a[0]);
  a[1] = __dp4a(xv.y, wv[1].y, a[1]);
  a[2] = __dp4a(xv.y, wv[1].z, a[2]);
  a[3] = __dp4a(xv.y, wv[1].w, a[3]);
  a[0] = __dp4a(xv.z, wv[2].x, a[0]);
  a[1] = __dp4a(xv.z, wv[2].y, a[1]);
  a[2] = __dp4a(xv.z, wv[2].z, a[2]);
  a[3] = __dp4a(xv.z, wv[2].w, a[3]);
  a[0] = __dp4a(xv.w, wv[3].x, a[0]);
  a[1] = __dp4a(xv.w, wv[3].y, a[1]);
  a[2] = __dp4a(xv.w, wv[3].z, a[2]);
  a[3] = __dp4a(xv.w, wv[3].w, a[3]);
}

// acc[i][j] += sum over the 9 taps and `ng` 4-word groups of the staged
// weight chunk. base[i] is pixel i's top-left input word in xs; a tap (dy,
// dx) adds dy * row_words + dx * pix_words; word_off selects the chunk's
// words within a pixel.
__device__ __forceinline__ void accumulate_chunk(int (&acc)[kPix][4], const int* xs,
                                                 const int (&base)[kPix], int row_words,
                                                 int pix_words, int word_off, const int* ws,
                                                 int ng, int tn) {
  for (int t = 0; t < 9; ++t) {
    const int tap = (t / 3) * row_words + (t % 3) * pix_words + word_off;
    for (int g = 0; g < ng; ++g) {
      int4 wv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wv[k] = *reinterpret_cast<const int4*>(
            ws + (t * kChunkWords + 4 * g + k) * kTileCo + 4 * tn);
      }
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int4 xv = *reinterpret_cast<const int4*>(xs + base[i] + tap + 4 * g);
        dot_group(acc[i], xv, wv);
      }
    }
  }
}

// The int8 epilogue of models/quantize._requant for 4 channels co..co+3:
// clip(round(float(acc + bias_q) * m), lo, 127), packed into one word.
// The _rn intrinsics keep nvcc from contracting into an FMA; rintf rounds
// half to even, as jnp.round and torch.round do.
__device__ __forceinline__ int requant_pack(const int (&a)[4], const int* __restrict__ bias_q,
                                            const float* __restrict__ m, int co, float lo) {
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f = rintf(__fmul_rn(__int2float_rn(a[j] + bias_q[co + j]), m[co + j]));
    f = fminf(fmaxf(f, lo), 127.f);
    packed |= (static_cast<unsigned>(static_cast<int>(f)) & 0xffu) << (8 * j);
  }
  return static_cast<int>(packed);
}

}  // namespace witw

extern "C" const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
