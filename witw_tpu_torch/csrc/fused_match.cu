// Fused circular correlation + argmax orientation + chord distance, for
// Hopper (sm_90a), f32.
//
// Replaces witw_tpu/ops/pallas/fused_match.py:fused_corr_distance (the
// Pallas TPU kernel). For every gallery map g and query q:
//
//   corr[q, i] = sum_k <o_g[(i+k) mod W], s_q[k]>              (i < W, k < sw)
//   orient     = argmax_i corr[q, i]       (lowest index on ties, NaN wins)
//   d[g, q]    = 2 (1 - max corr * rsqrt(max(wsq[g, orient], 1e-20))
//                         / max(||s_q||, 1e-10))
//
// Only d and orient reach device memory; the [G, Q, W] correlation stays in
// registers.
//
// Layout: o [G, W, hc], s [sw, Q, hc], wsq [G, W] (f32, contiguous), with
// the feature-map height folded into the channels (hc = h * c).
//
// Bound: f32 FMA throughput. At CVUSA shapes (W = sw = hc = 64) each (g, q)
// pair costs W * sw * hc = 262k multiply-adds against 16 KB of gallery map
// and 16 KB of query, so the kernel is compute-bound on the CUDA cores
// (no tensor cores, no TF32: results must agree with the f32 reference).
//
// Design:
// - One block per (gallery map, tile of 64 queries): the grid tiles both G
//   and Q. The whole gallery map sits in shared memory; the queries stream
//   through it one width column k at a time ([64, hc] per step), so shared
//   memory holds (W + 64) rows of hc floats whatever Q and sw are.
// - The circular shift is modular row addressing into the shared gallery
//   map (row (i+k) mod W), in place of the TPU kernel's pltpu.roll.
// - 256 threads as 16 query groups x 16 shift lanes; each thread keeps a
//   4 x 4 register tile (queries tq+16a, shifts ti+16b) and accumulates it
//   with fmaf over (k, j). Rows are padded to hc+1 floats so the 16 lanes
//   reading 16 different gallery rows hit 16 different banks.
// - Widths above 64 run in passes of 64 shifts; max/argmax is reduced per
//   pass in registers and across the 16 shift lanes with warp shuffles, and
//   carried across passes in registers.
// - A ragged last query tile is zero-filled in shared memory and masked on
//   store; shifts past W are masked out of the argmax. Nothing is padded in
//   device memory.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kQTile = 64;  // queries per block; ops/fused_match.py mirrors it
constexpr int kLanes = 16;  // shift lanes (and query groups) per block
constexpr int kMicro = 4;   // register tile is kMicro x kMicro
constexpr int kITile = kLanes * kMicro;  // shifts per pass

// Does (v, i) beat the running best (bv, bi)? Larger value wins; NaN beats
// every number; equal values keep the lower index (argmax semantics).
__device__ __forceinline__ void take_better(float v, int i, float& bv, int& bi) {
  const bool v_nan = v != v;
  const bool b_nan = bv != bv;
  const bool greater = (v > bv) || (v_nan && !b_nan);
  const bool equal = (v == bv) || (v_nan && b_nan);
  if (greater || (equal && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_corr_distance_kernel(const float* __restrict__ o, const float* __restrict__ s,
                           const float* __restrict__ wsq, float* __restrict__ d,
                           int* __restrict__ orient, int W, int hc, int Q, int sw) {
  extern __shared__ float smem[];
  const int ld = hc + 1;
  float* o_sm = smem;                     // [W][ld]
  float* s_sm = o_sm + W * ld;            // [kQTile][ld]
  float* snorm_sm = s_sm + kQTile * ld;   // [kQTile]

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ti = tid & (kLanes - 1);  // shift lane
  const int tq = tid / kLanes;        // query group

  const float* o_g = o + static_cast<size_t>(g) * W * hc;
  for (int r = warp; r < W; r += kThreads / 32) {
    for (int j = lane; j < hc; j += 32) o_sm[r * ld + j] = o_g[r * hc + j];
  }

  float best_v[kMicro];
  int best_i[kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    best_v[a] = -INFINITY;
    best_i[a] = INT_MAX;
  }
  float snorm_part = 0.f;

  for (int i0 = 0; i0 < W; i0 += kITile) {
    float acc[kMicro][kMicro];
    int row0[kMicro];
#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
#pragma unroll
      for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;
    }
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int i = i0 + ti + kLanes * b;
      row0[b] = i < W ? i : 0;  // masked shifts read a valid row
    }

    for (int k = 0; k < sw; ++k) {
      __syncthreads();  // the previous query column is consumed; o_sm is written
      const float* s_k = s + (static_cast<size_t>(k) * Q + q0) * hc;
      for (int r = warp; r < kQTile; r += kThreads / 32) {
        const bool valid = q0 + r < Q;
        for (int j = lane; j < hc; j += 32) {
          s_sm[r * ld + j] = valid ? s_k[static_cast<size_t>(r) * hc + j] : 0.f;
        }
      }
      __syncthreads();

      if (i0 == 0 && tid < kQTile) {
        const float* row = s_sm + tid * ld;
        for (int j = 0; j < hc; ++j) snorm_part = fmaf(row[j], row[j], snorm_part);
      }

      const float* srow[kMicro];
      const float* orow[kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) srow[a] = s_sm + (tq + kLanes * a) * ld;
#pragma unroll
      for (int b = 0; b < kMicro; ++b) {
        int r = row0[b] + k;  // row0 < W and k < sw <= W, so one wrap suffices
        if (r >= W) r -= W;
        orow[b] = o_sm + r * ld;
      }
#pragma unroll 4
      for (int j = 0; j < hc; ++j) {
        float sv[kMicro];
        float ov[kMicro];
#pragma unroll
        for (int a = 0; a < kMicro; ++a) sv[a] = srow[a][j];
#pragma unroll
        for (int b = 0; b < kMicro; ++b) ov[b] = orow[b][j];
#pragma unroll
        for (int a = 0; a < kMicro; ++a) {
#pragma unroll
          for (int b = 0; b < kMicro; ++b) acc[a][b] = fmaf(sv[a], ov[b], acc[a][b]);
        }
      }
    }

#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
      float v = -INFINITY;
      int vi = INT_MAX;
#pragma unroll
      for (int b = 0; b < kMicro; ++b) {
        const int i = i0 + ti + kLanes * b;
        if (i < W) take_better(acc[a][b], i, v, vi);
      }
      // The 16 shift lanes of a query group are one half-warp: xor offsets
      // below 16 stay inside it.
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
        take_better(ov, oi, v, vi);
      }
      take_better(v, vi, best_v[a], best_i[a]);
    }
  }

  if (tid < kQTile) snorm_sm[tid] = sqrtf(snorm_part);
  __syncthreads();

  if (ti == 0) {
#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
      const int qq = tq + kLanes * a;
      const int q = q0 + qq;
      if (q < Q) {
        const int i = best_i[a];
        const float w = wsq[static_cast<size_t>(g) * W + i];
        const float cosv =
            best_v[a] * (1.0f / sqrtf(fmaxf(w, 1e-20f))) / fmaxf(snorm_sm[qq], 1e-10f);
        const size_t out = static_cast<size_t>(g) * Q + q;
        d[out] = 2.0f * (1.0f - cosv);
        orient[out] = i;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `smem` is the dynamic shared memory of one block, in bytes:
// 4 * ((W + kQTile) * (hc + 1) + kQTile), computed by ops/fused_match.py.
int witw_fused_corr_distance(const void* o, const void* s, const void* wsq, void* d,
                             void* orient, int G, int W, int hc, int Q, int sw,
                             size_t smem, void* stream) {
  if (G <= 0 || Q <= 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_corr_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(G, (Q + kQTile - 1) / kQTile);
  fused_corr_distance_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(s),
      static_cast<const float*>(wsq), static_cast<float*>(d), static_cast<int*>(orient), W,
      hc, Q, sw);
  return static_cast<int>(cudaGetLastError());
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
