// The layout probes of the fused int8 block kernels, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels exp/mosaic_caps.py:t1, t2 and t4, which
// asked whether the TPU compiler lowers 64-lane slices, lane concats and the
// parity patch build of int8 values. On this card the same functions are
// plain byte moves; for x int8 with rows of C bytes (h = C / 2):
//
//   t1 half_sum:    out int32 [R, h] = x[:, :h] + x[:, h:]
//   t2 swap_halves: out int8 [R, C]  = concat(x[:, h:], x[:, :h])
//   t4 copy:        out int8 [R*W, C] = concat(x[..., :h].reshape(R*W, h),
//                                              x[..., h:].reshape(R*W, h))
//
// t4's concat puts row p's two halves back side by side: row for row it is
// x.reshape(R*W, C), so its kernel is a copy. (exp/mosaic_caps.py:t3, the
// s8 dot, runs on the matmul kernel, csrc/mm_probe.cu.)
//
// Bound: bytes (each input read once, each output written once); at the
// probes' sizes (32 to 96 KB) the launch itself. Design: a grid-stride loop
// in which a thread moves 16 bytes with one vector load and one (t1: four)
// vector stores; h is a multiple of 16, so every vector is aligned.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ size_t first_index() {
  return static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ size_t grid_stride() {
  return static_cast<size_t>(gridDim.x) * blockDim.x;
}

// One thread per 16 output columns: 16 bytes of each half in, 64 bytes out.
__global__ void __launch_bounds__(kThreads)
half_sum_kernel(const int8_t* __restrict__ x, int* __restrict__ out, size_t rows, int h) {
  const int vecs = h / 16;
  for (size_t i = first_index(); i < rows * vecs; i += grid_stride()) {
    const size_t r = i / vecs;
    const int c = static_cast<int>(i % vecs) * 16;
    const int4 lo = *reinterpret_cast<const int4*>(x + r * 2 * h + c);
    const int4 hi = *reinterpret_cast<const int4*>(x + r * 2 * h + h + c);
    const int8_t* l = reinterpret_cast<const int8_t*>(&lo);
    const int8_t* u = reinterpret_cast<const int8_t*>(&hi);
    int4* o = reinterpret_cast<int4*>(out + r * h + c);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[q] = make_int4(l[4 * q] + u[4 * q], l[4 * q + 1] + u[4 * q + 1],
                       l[4 * q + 2] + u[4 * q + 2], l[4 * q + 3] + u[4 * q + 3]);
    }
  }
}

// Output vector v of a row reads input vector (v + h / 16) mod (2h / 16).
__global__ void __launch_bounds__(kThreads)
swap_halves_kernel(const int4* __restrict__ x, int4* __restrict__ out, size_t rows, int h) {
  const int vecs = 2 * h / 16;
  for (size_t i = first_index(); i < rows * vecs; i += grid_stride()) {
    const size_t r = i / vecs;
    const int v = static_cast<int>(i % vecs);
    out[i] = x[r * vecs + (v + vecs / 2) % vecs];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const int4* __restrict__ x, int4* __restrict__ out, size_t vecs) {
  for (size_t i = first_index(); i < vecs; i += grid_stride()) out[i] = x[i];
}

int blocks_for(size_t items) {
  const size_t b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// x int8 [rows, 2h] -> out int32 [rows, h]. h a multiple of 16, all
// contiguous and 16-byte aligned (checked by exp/mosaic_caps.py). Each entry
// launches on `stream` and returns cudaGetLastError() (0 on success).
int witw_caps_half_sum(const void* x, void* out, long long rows, int h, void* stream) {
  const size_t items = static_cast<size_t>(rows) * (h / 16);
  if (items == 0) return 0;
  half_sum_kernel<<<blocks_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int*>(out), static_cast<size_t>(rows), h);
  return static_cast<int>(cudaGetLastError());
}

// x int8 [rows, 2h] -> out int8 [rows, 2h] with the halves swapped.
int witw_caps_swap_halves(const void* x, void* out, long long rows, int h, void* stream) {
  const size_t items = static_cast<size_t>(rows) * (2 * h / 16);
  if (items == 0) return 0;
  swap_halves_kernel<<<blocks_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), static_cast<size_t>(rows), h);
  return static_cast<int>(cudaGetLastError());
}

// out = x, n_bytes a multiple of 16.
int witw_caps_copy(const void* x, void* out, long long n_bytes, void* stream) {
  const size_t vecs = static_cast<size_t>(n_bytes) / 16;
  if (vecs == 0) return 0;
  copy_kernel<<<blocks_for(vecs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), vecs);
  return static_cast<int>(cudaGetLastError());
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
