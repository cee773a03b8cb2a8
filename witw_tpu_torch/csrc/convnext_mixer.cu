// The ConvNeXt block's token mixer in one pass over NHWC, for Hopper (sm_90a):
//
//   y[b, i, j, :] = bf16(LN_c(dwconv7x7(bf16(x))[b, i, j, :] + bias))
//
// x [B, H, W, C] (the block input, f32 or bf16, read as stored), the depthwise
// weight [C, 1, 7, 7] (f32, rounded to bf16 as it is staged), its bias, the
// LayerNorm's weight and bias [C] (f32). Zero padding 3. Products and sums in
// f32; the bias is added in f32; the LayerNorm over C in f32 (the mean, then
// the biased variance of the deviations, eps, the affine); one rounding to
// bf16 at the end. The conv's f32 sum goes into the LayerNorm unrounded.
//
// It replaces no TPU kernel: the JAX package has no ConvNeXt. It fuses what
// the bf16 block ran as five memory passes (the block input cast to bf16,
// cuDNN's depthwise conv, the bias added into an f32 upcast, ATen's f32
// LayerNorm, the cast to bf16), about 30 bytes a channel-pixel, into one that
// reads the input once and writes the bf16 output once: 6 bytes a
// channel-pixel from f32 (4 from bf16).
//
// Bound, at the Sample4Geo eval's shapes: 1,237.6 GB an eval at 3.35 TB/s is
// 0.369 s; 20.16 TFLOP of multiply-adds on the CUDA cores (depthwise products
// have no matrix-unit form as they stand) is 0.30 s at the f32 FMA peak of
// ~67 TFLOP/s. So the kernel is bound by bytes and by the FFMA issue rate at
// once: the design keeps the bytes read near those the work needs, keeps a
// chunk's copies in flight while the one before computes, and spends few
// instructions besides the FFMAs:
//
// - A cluster of N blocks owns a tile of 96 output pixels of one image (12 x
//   8, 8 x 12 or 4 x 24, whichever wastes least on the map); block r owns
//   channels [r CS, (r + 1) CS) (CS 32, 64 or 128; N <= 8). So the tile, and
//   with it the halo's share of the reads, does not shrink as C grows, and a
//   block's f32 conv sums ([96][CS + 4]) fit in shared memory beside two
//   staged chunks: two blocks (256 threads each) an SM up to C 512.
// - The clusters are persistent (as many as fit at once), each walking the
//   tiles with a stride of their number, so that neighbouring tiles run
//   together and their halos meet in L2. A block loads and rounds its slice
//   of the weights once.
// - A block takes its tile in chunks of 32 channels. A chunk's (TR + 6) x
//   (TC + 6) halo arrives by 16-byte cp.async copies (zeros outside the
//   image), their offsets found once a tile; each thread rounds the f32
//   values it copied to the bf16 grid in place as they land (bf16 inputs are
//   widened as the conv reads them). The next chunk's copies, or the next
//   tile's first, are issued before this chunk's conv, into the other stage.
// - Each warp takes a TH x TW micro-tile of the chunk, lane = channel (each
//   shared-memory load 32 consecutive words): 49 weights in registers, a
//   register window of TW + 6 inputs slid down the TH + 6 input rows, each
//   window load feeding up to 7 x TW FFMAs (588 FFMAs a lane against 90
//   loads at 3 x 4).
// - The LayerNorm: two threads a pixel take the mean of the block's slice
//   and the squared deviations from it (two passes over its sums); after one
//   cluster barrier a thread a pixel reads the N slices' pairs through
//   distributed shared memory and merges them in rank order (the same in
//   every block, so all normalize alike): the pixel's mean, and its variance
//   as the slices' squared deviations plus CS times their means' squared
//   deviations from it (Chan et al.'s exact merge; never E[x^2] - mean^2).
//   Then each lane normalizes 4 channels and writes them (8 bytes; a warp
//   256 contiguous bytes).
// - Measured on the card while it was designed: one block a pixel tile of
//   all C (the sums' tile shrinking to 16 pixels at C 1024) spent most of its
//   time waiting on its copies and re-read its halo 4x from L2; a LayerNorm
//   of a warp a pixel waited on chains of shuffles; three cluster barriers a
//   tile cost a fifth of the time. The cluster's barrier itself costs 3-6%.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace witw;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 7;         // kernel size
constexpr int kPad = kK / 2;  // zero padding
constexpr int kTaps = kK * kK;
constexpr int kChunk = 32;      // channels a chunk: one a lane
constexpr int kMaxSlice = 128;  // channels a block
constexpr int kMaxCluster = 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A staged run of the window, as f32 values on the bf16 grid: f32 stages
// were rounded as they landed, bf16 ones are widened here.
template <int N, int STRIDE>
__device__ __forceinline__ void load_window(const float* src, float (&win)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) win[j] = src[j * STRIDE];
}
template <int N, int STRIDE>
__device__ __forceinline__ void load_window(const __nv_bfloat16* src, float (&win)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) win[j] = __bfloat162float(src[j * STRIDE]);
}

// The output tiles the kernel instantiates: (TR, TC) pixels of a cluster's
// tile, (TH, TW) of a warp's micro-tile, one micro-tile a warp. choose()
// picks one from the map's size.
struct TileShape {
  int tr, tc, th, tw;
};
constexpr TileShape kTiles[] = {{12, 8, 3, 4}, {8, 12, 4, 3}, {4, 24, 4, 3}};
constexpr int kConfigs = sizeof(kTiles) / sizeof(kTiles[0]);

// A block's shared memory at `cs` channels a block, for an input of
// `in_bytes` bytes a value: two stages of a chunk's halo [IR][IC][32] in
// the input's type; the block's slice of the weights [cs][49] (rounded),
// the conv bias and the LayerNorm's weight and bias [cs]; the f32 conv sums
// [P][cs + 4]; per pixel two buffers of the slice's (mean, squared
// deviations), the mean and 1 / std.
constexpr size_t smem_bytes(TileShape t, size_t in_bytes, int cs) {
  return 2 * in_bytes * (t.tr + 2 * kPad) * (t.tc + 2 * kPad) * kChunk +
         sizeof(float) * (static_cast<size_t>(cs) * (kTaps + 3) +
                          static_cast<size_t>(t.tr * t.tc) * (cs + 4) + 6 * t.tr * t.tc);
}

template <int CONFIG>
struct Tile {
  static constexpr TileShape kShape = kTiles[CONFIG];
  static constexpr int TR = kShape.tr, TC = kShape.tc, TH = kShape.th, TW = kShape.tw;
  static constexpr int IR = TR + 2 * kPad;  // staged input rows
  static constexpr int IC = TC + 2 * kPad;  // staged input columns
  static constexpr int P = TR * TC;         // output pixels of a tile
  static constexpr int MX = TC / TW;        // micro-tiles across
  static_assert(TR % TH == 0 && TC % TW == 0, "tile");
  static_assert((TR / TH) * MX == kWarps, "one micro-tile a warp a chunk");
  static_assert(2 * P <= kThreads && P % 16 == 0, "two threads a pixel, whole warps, in the LayerNorm's sums");
};

template <typename T, int TH, int TW, int ROW, int COL>
__device__ __forceinline__ void conv_micro(const T* __restrict__ src, const float (&w)[kTaps],
                                           float (&acc)[TH][TW]) {
#pragma unroll
  for (int ir = 0; ir < TH + 2 * kPad; ++ir) {
    float win[TW + 2 * kPad];
    load_window<TW + 2 * kPad, COL>(src + ir * ROW, win);
#pragma unroll
    for (int oy = 0; oy < TH; ++oy) {
      const int ky = ir - oy;
      if (ky >= 0 && ky < kK) {
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
          for (int ox = 0; ox < TW; ++ox)
            acc[oy][ox] = fmaf(w[ky * kK + kx], win[ox + kx], acc[oy][ox]);
        }
      }
    }
  }
}

// A thread's share of the 16-byte copies of a tile's halo, one chunk of 32
// channels at a time: the copies' offsets into the image are found once a
// tile (-1 outside it: 16 zeros), and copy e of the halo lands at byte 16 e
// of the stage ([IR][IC][32] in the input's type).
template <typename T, class Geo>
struct Copies {
  static constexpr int kPer = 16 / sizeof(T);  // channels a copy
  static constexpr int kAll = Geo::IR * Geo::IC * kChunk / kPer;
  static constexpr int kIters = (kAll + kThreads - 1) / kThreads;
  int off[kIters];

  __device__ __forceinline__ void plan(int r0, int c0, int H, int W, int C) {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int pix = e / (kChunk / kPer);
      const int yy = r0 - kPad + pix / Geo::IC;
      const int xx = c0 - kPad + pix % Geo::IC;
      const bool in = e < kAll && yy >= 0 && yy < H && xx >= 0 && xx < W;
      off[k] = in ? (yy * W + xx) * C + (e % (kChunk / kPer)) * kPer : -1;
    }
  }
  // Chunk [cb, cb + 32) of the image at `img` into `stage`, one cp.async group.
  __device__ __forceinline__ void issue(T* stage, const T* img, int cb) const {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kAll)
        cp_async16(stage + e * kPer, off[k] >= 0 ? img + off[k] + cb : img, off[k] >= 0 ? 16u : 0u);
    }
    cp_async_commit();
  }
  // After the copies have landed: this thread's f32 values rounded to the
  // bf16 grid in place (bf16 stages are widened as the conv reads them).
  __device__ __forceinline__ void round(T* stage) const {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        const int e = threadIdx.x + k * kThreads;
        if (e < kAll && off[k] >= 0) {
          float4* p = reinterpret_cast<float4*>(stage) + e;
          const float4 v = *p;
          const float2 a = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
          const float2 c = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
          *p = make_float4(a.x, a.y, c.x, c.y);
        }
      }
    }
  }
};

template <typename T, int CONFIG, int CS>
__global__ void __launch_bounds__(kThreads, 2)
convnext_mixer_kernel(const T* __restrict__ x, const float* __restrict__ dw_w,
                      const float* __restrict__ dw_b, const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b, __nv_bfloat16* __restrict__ out, int H,
                      int W, int C, int tiles_y, int tiles_x, int n_tiles, float eps) {
  using Geo = Tile<CONFIG>;
  constexpr int TR = Geo::TR, TC = Geo::TC, TH = Geo::TH, TW = Geo::TW;
  constexpr int cs = CS;  // channels of the block's slice
  static_assert(CS % kChunk == 0 && CS <= kMaxSlice, "slice");
  constexpr int kStage = Geo::IR * Geo::IC * kChunk;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / n_ranks;
  const int first = blockIdx.x / n_ranks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_in = reinterpret_cast<T*>(smem_raw);                      // [2][IR][IC][32]
  float* s_w = reinterpret_cast<float*>(s_in + 2 * kStage);      // [cs][49]
  float* s_bias = s_w + cs * kTaps;                              // [cs]
  float* s_g = s_bias + cs;                                      // [cs]
  float* s_b = s_g + cs;                                         // [cs]
  constexpr int pitch = cs + 4;  // a row of conv sums: 4 words more, so that 8
                                 // threads reading 8 rows' float4 hit 32 banks
  float* s_out = s_b + cs;                                       // [P][pitch]
  float2* s_part = reinterpret_cast<float2*>(s_out + Geo::P * pitch);  // [2][P]
  float* s_mean = reinterpret_cast<float*>(s_part + 2 * Geo::P);      // [P]
  float* s_rstd = s_mean + Geo::P;                                     // [P]

  const int c_slice = rank * cs;
  constexpr int n_chunks = cs / kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int my = (warp / Geo::MX) * TH;
  const int mx = (warp % Geo::MX) * TW;
  auto origin = [&](int tile, int& b, int& r0, int& c0) {
    c0 = (tile % tiles_x) * TC;
    tile /= tiles_x;
    r0 = (tile % tiles_y) * TR;
    b = tile / tiles_y;
  };

  if (first >= n_tiles) return;  // the whole cluster: its blocks share `first`
  const size_t image = static_cast<size_t>(H) * W * C;
  int b, r0, c0;
  origin(first, b, r0, c0);
  Copies<T, Geo> copies;
  copies.plan(r0, c0, H, W, C);
  copies.issue(s_in, x + b * image, c_slice);
  // The block's slice of the parameters, once: the weights rounded to bf16.
  for (int e = threadIdx.x; e < cs * kTaps; e += kThreads)
    s_w[e] = bf16_round(__ldg(dw_w + static_cast<size_t>(c_slice) * kTaps + e));
  for (int e = threadIdx.x; e < cs; e += kThreads) {
    s_bias[e] = __ldg(dw_b + c_slice + e);
    s_g[e] = __ldg(ln_w + c_slice + e);
    s_b[e] = __ldg(ln_b + c_slice + e);
  }

  int stage = 0;
  int parity = 0;
  for (int tile = first; tile < n_tiles; tile += n_clusters) {
    origin(tile, b, r0, c0);
    for (int k = 0; k < n_chunks; ++k) {
      cp_async_wait<0>();
      copies.round(s_in + stage * kStage);
      __syncthreads();  // chunk k is in; every warp is done with the other stage
      // The next chunk's copies fly while this one computes: the next chunk
      // of this tile, or the first of the cluster's next tile.
      if (k + 1 < n_chunks) {
        copies.issue(s_in + (stage ^ 1) * kStage, x + b * image, c_slice + (k + 1) * kChunk);
      } else if (tile + n_clusters < n_tiles) {
        int nb, nr0, nc0;
        origin(tile + n_clusters, nb, nr0, nc0);
        copies.plan(nr0, nc0, H, W, C);
        copies.issue(s_in + (stage ^ 1) * kStage, x + nb * image, c_slice);
      }
      // One micro-tile a warp, lane = channel.
      const int ch = k * kChunk + lane;
      float w[kTaps];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) w[t] = s_w[ch * kTaps + t];
      float acc[TH][TW];
#pragma unroll
      for (int oy = 0; oy < TH; ++oy)
#pragma unroll
        for (int ox = 0; ox < TW; ++ox) acc[oy][ox] = 0.f;
      conv_micro<T, TH, TW, Geo::IC * kChunk, kChunk>(
          s_in + stage * kStage + (my * Geo::IC + mx) * kChunk + lane, w, acc);
      const float bias = s_bias[ch];
#pragma unroll
      for (int oy = 0; oy < TH; ++oy)
#pragma unroll
        for (int ox = 0; ox < TW; ++ox)
          s_out[((my + oy) * TC + mx + ox) * pitch + ch] = acc[oy][ox] + bias;
      stage ^= 1;
    }
    __syncthreads();

    // The LayerNorm over all C channels of each pixel. Two threads a pixel
    // (even and odd float4s of its row) take the mean of the block's slice
    // and the squared deviations from it, two passes over its sums; once
    // the cluster has every slice's pair, a thread a pixel merges them in
    // rank order (the same in every block, so all normalize alike) into
    // the pixel's mean and variance: Chan et al.'s exact merge, the slices'
    // squared deviations plus cs times their means' squared deviations from
    // the pixel's mean. The pairs alternate between two buffers, so one
    // cluster barrier a tile keeps a block from overwriting a pair that
    // another block still reads.
    // The two passes unroll by at most 8 float4s, and the write below by 6
    // steps: unrolled whole at 128 channels a block, they would hold a
    // pixel's 64 sums (or 12 steps' loads) live at once and spill registers.
    constexpr int nq = cs / 4;
    {
      const int p = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      if (p < Geo::P) {
        const float4* row = reinterpret_cast<const float4*>(s_out + p * pitch) + half;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
        for (int j = 0; j < nq / 2; ++j) {
          const float4 v = row[2 * j];
          s0 += v.x + v.y;
          s1 += v.z + v.w;
        }
        const float mean = (s0 + s1 + __shfl_xor_sync(0xffffffffu, s0 + s1, 1)) / cs;
        float q0 = 0.f, q1 = 0.f;
#pragma unroll 8
        for (int j = 0; j < nq / 2; ++j) {
          const float4 v = row[2 * j];
          const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean, dw = v.w - mean;
          q0 = fmaf(dx, dx, fmaf(dy, dy, q0));
          q1 = fmaf(dz, dz, fmaf(dw, dw, q1));
        }
        const float m2 = q0 + q1 + __shfl_xor_sync(0xffffffffu, q0 + q1, 1);
        if (half == 0) s_part[parity * Geo::P + p] = make_float2(mean, m2);
      }
    }
    cluster.sync();
    if (threadIdx.x < Geo::P) {
      const int p = threadIdx.x;
      float2 part[kMaxCluster];
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < n_ranks) {
          part[r] = cluster.map_shared_rank(s_part, r)[parity * Geo::P + p];
          sum += part[r].x;
        }
      }
      const float mean = sum / n_ranks;
      float m2 = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < n_ranks) {
          const float d = part[r].x - mean;
          m2 += fmaf(cs * d, d, part[r].y);
        }
      }
      s_mean[p] = mean;
      s_rstd[p] = rsqrtf(m2 / C + eps);
    }
    __syncthreads();
    parity ^= 1;

    // Normalize and write: 4 channels a lane, cs / 4 lanes a pixel, as many
    // pixels a warp at once as that leaves lanes for; 8 bytes a lane.
    constexpr int per = 32 / nq;
    constexpr int steps = (Geo::P + kWarps * per - 1) / (kWarps * per);
    const int q = lane % nq;
    const float4 gw = reinterpret_cast<const float4*>(s_g)[q];
    const float4 gb = reinterpret_cast<const float4*>(s_b)[q];
    __nv_bfloat16* out_b = out + static_cast<size_t>(b) * H * W * C + c_slice;
#pragma unroll 6
    for (int j = 0; j < steps; ++j) {
      const int px = (j * kWarps + warp) * per + lane / nq;
      const int yy = r0 + px / TC;
      const int xx = c0 + px % TC;
      if (px < Geo::P && yy < H && xx < W) {
        const float mean = s_mean[px];
        const float rstd = s_rstd[px];
        const float4 v = reinterpret_cast<const float4*>(s_out + px * pitch)[q];
        const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaf((v.x - mean) * rstd, gw.x, gb.x),
                                                        fmaf((v.y - mean) * rstd, gw.y, gb.y));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaf((v.z - mean) * rstd, gw.z, gb.z),
                                                        fmaf((v.w - mean) * rstd, gw.w, gb.w));
        uint2 u;
        u.x = *reinterpret_cast<const uint32_t*>(&lo);
        u.y = *reinterpret_cast<const uint32_t*>(&hi);
        reinterpret_cast<uint2*>(out_b + (static_cast<size_t>(yy) * W + xx) * C)[q] = u;
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its last pairs
}

// The card's device index, or -1 past the first kMaxDevices: the kernels'
// attributes and their clusters' occupancy are a device's own.
constexpr int kMaxDevices = 64;
int current_device() {
  int d = -1;
  if (cudaGetDevice(&d) != cudaSuccess || d < 0 || d >= kMaxDevices) return -1;
  return d;
}

template <typename T, int CONFIG, int CS>
int launch(const void* x, const float* dw_w, const float* dw_b, const float* ln_w,
           const float* ln_b, void* out, int B, int H, int W, int C, float eps,
           cudaStream_t stream) {
  using Geo = Tile<CONFIG>;
  const int n_ranks = C / CS;
  if (C % CS != 0 || n_ranks < 1 || n_ranks > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  auto kernel = convnext_mixer_kernel<T, CONFIG, CS>;
  const size_t smem = smem_bytes(Geo::kShape, sizeof(T), CS);
  cudaError_t e = cudaSuccess;
  static bool configured[kMaxDevices] = {};  // the kernel's attributes, set once a device
  if (!configured[dev]) {
    e = set_smem(kernel, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  const int tiles_y = (H + Geo::TR - 1) / Geo::TR;
  const int tiles_x = (W + Geo::TC - 1) / Geo::TC;
  const long long n_tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Persistent clusters: as many as fit on the card at once (found once a
  // device and cluster size), each walking the tiles with a stride of their
  // number.
  static int known[kMaxDevices][kMaxCluster + 1] = {};
  int& clusters = known[dev][n_ranks];
  if (clusters == 0) {
    cfg.gridDim = dim3(static_cast<unsigned>(n_ranks));
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long grid = n_tiles < clusters ? n_tiles : clusters;
  cfg.gridDim = dim3(static_cast<unsigned>(grid * n_ranks));
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), dw_w, dw_b, ln_w, ln_b,
                         static_cast<__nv_bfloat16*>(out), H, W, C, tiles_y, tiles_x,
                         static_cast<int>(n_tiles), eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The tiling of C channels on an H x W map: the tile that computes and
// stages the fewest pixels over the map (a staged halo pixel, a 4-byte read
// from L2 and a few instructions, at half a computed one's 49 FFMAs); then
// the widest slice of 32, 64 or 128 channels, at most kMaxCluster to a
// cluster, whose block fits two to an SM with f32 input, else the widest.
struct Choice {
  int config, slice;
};
constexpr size_t kTwoPerSm = 228 * 1024 / 2 - 1024;  // the H100's 228 KB, less 1 KB a block

bool choose(int C, int H, int W, Choice* c) {
  long long best = -1;
  for (int i = 0; i < kConfigs; ++i) {
    const TileShape t = kTiles[i];
    const long long n = static_cast<long long>((H + t.tr - 1) / t.tr) * ((W + t.tc - 1) / t.tc);
    const long long cost = n * (2 * t.tr * t.tc + (t.tr + 2 * kPad) * (t.tc + 2 * kPad));
    if (best < 0 || cost < best) {
      best = cost;
      c->config = i;
    }
  }
  int widest = 0, fitting = 0;
  for (int cs = kChunk; cs <= kMaxSlice; cs *= 2) {
    if (C <= 0 || C % cs != 0 || C / cs > kMaxCluster) continue;
    widest = cs;
    if (smem_bytes(kTiles[c->config], sizeof(float), cs) <= kTwoPerSm) fitting = cs;
  }
  c->slice = fitting ? fitting : widest;
  return widest != 0;
}

// The slice width and the tile as template parameters.
template <typename T, int CONFIG>
int launch_slice(const void* x, const float* dw_w, const float* dw_b, const float* ln_w,
                 const float* ln_b, void* out, int B, int H, int W, int C, int slice,
                 float eps, cudaStream_t s) {
  switch (slice) {
    case 32:
      return launch<T, CONFIG, 32>(x, dw_w, dw_b, ln_w, ln_b, out, B, H, W, C, eps, s);
    case 64:
      return launch<T, CONFIG, 64>(x, dw_w, dw_b, ln_w, ln_b, out, B, H, W, C, eps, s);
    case 128:
      return launch<T, CONFIG, 128>(x, dw_w, dw_b, ln_w, ln_b, out, B, H, W, C, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const float* dw_w, const float* dw_b, const float* ln_w,
             const float* ln_b, void* out, int B, int H, int W, int C, float eps,
             cudaStream_t s) {
  Choice c;
  if (!choose(C, H, W, &c)) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kConfigs == 3, "one case a tile");
  switch (c.config) {
    case 0: return launch_slice<T, 0>(x, dw_w, dw_b, ln_w, ln_b, out, B, H, W, C, c.slice, eps, s);
    case 1: return launch_slice<T, 1>(x, dw_w, dw_b, ln_w, ln_b, out, B, H, W, C, c.slice, eps, s);
    case 2: return launch_slice<T, 2>(x, dw_w, dw_b, ln_w, ln_b, out, B, H, W, C, c.slice, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x_dtype: 0 f32, 1 bf16. x [B, H, W, C] -> out [B, H, W, C] bf16, both
// contiguous and 16-byte aligned; the f32 weights contiguous and 16-byte
// aligned (checked by ops/convnext_mixer.py). The tiling is choose()'s.
// Launches on `stream` and returns the launch's CUDA error (0 on success;
// cudaErrorInvalidValue for an unknown dtype or a C with no split).
int witw_convnext_mixer(const void* x, int x_dtype, const void* dw_w, const void* dw_b,
                        const void* ln_w, const void* ln_b, void* out, int B, int H, int W,
                        int C, float eps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const float*>(dw_w);
  const auto* wb = static_cast<const float*>(dw_b);
  const auto* g = static_cast<const float*>(ln_w);
  const auto* gb = static_cast<const float*>(ln_b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return dispatch<float>(x, w, wb, g, gb, out, B, H, W, C, eps, s);
    case 1: return dispatch<__nv_bfloat16>(x, w, wb, g, gb, out, B, H, W, C, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tiling witw_convnext_mixer launches for C channels on an H x W map
// and input dtype `x_dtype` (0 f32, 1 bf16), into out[8]: the tile's index,
// rows and columns, the warp's micro-tile rows and columns, the blocks of a
// cluster, the channels of a block and a block's shared memory in bytes.
// Returns 0, or cudaErrorInvalidValue for a C it does not take.
int witw_convnext_mixer_geometry(int C, int H, int W, int x_dtype, long long* out) {
  Choice c;
  if (x_dtype < 0 || x_dtype > 1 || H < 0 || W < 0 || !choose(C, H, W, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const TileShape t = kTiles[c.config];
  const long long v[8] = {c.config, t.tr, t.tc, t.th, t.tw, C / c.slice, c.slice,
                          static_cast<long long>(smem_bytes(t, x_dtype == 0 ? 4 : 2, c.slice))};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
