// 2x2 / stride-2 max pool over NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel exp/pallas_maxpool.py:maxpool2x2:
//
//   out[b, i, j, c] = max(x[b, 2i, 2j, c], x[b, 2i, 2j+1, c],
//                         x[b, 2i+1, 2j, c], x[b, 2i+1, 2j+1, c])
//
// for i < H / 2, j < W / 2 (floor: a trailing odd row or column is dropped,
// as reduce_window VALID and torch's MaxPool2d do; the TPU kernel asserted
// even dims). Instantiated for int8 (the static-int8 towers' pools 1 and 3),
// bf16 and f32. A NaN in a window gives NaN, as torch.amax does.
//
// Bound: device-memory bandwidth (4 bytes read per byte written, no reuse).
// Each thread moves one 16-byte vector of channels of one output pixel when
// the channel row is a multiple of 16 bytes (every pool of the towers), else
// one element; a grid-stride loop covers the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t pmax(int8_t a, int8_t b) { return a > b ? a : b; }
__device__ __forceinline__ float pmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ __nv_bfloat16 pmax(__nv_bfloat16 a, __nv_bfloat16 b) {
  const float fa = __bfloat162float(a);
  const float fb = __bfloat162float(b);
  return (fa > fb || fa != fa) ? a : b;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
maxpool2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int Ho,
                  int Wo, long long n) {
  using VT = Vec<T, V>;
  const int cv = C / V;
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* ov = reinterpret_cast<VT*>(out);
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; idx < n;
       idx += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(idx % cv);
    long long t = idx / cv;
    const int j = static_cast<int>(t % Wo);
    t /= Wo;
    const int i = static_cast<int>(t % Ho);
    const long long b = t / Ho;
    const size_t p00 = ((static_cast<size_t>(b) * H + 2 * i) * W + 2 * j) * cv + c;
    const size_t row = static_cast<size_t>(W) * cv;
    const VT a0 = xv[p00];
    const VT a1 = xv[p00 + cv];
    const VT a2 = xv[p00 + row];
    const VT a3 = xv[p00 + row + cv];
    VT r;
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = pmax(pmax(a0.v[k], a1.v[k]), pmax(a2.v[k], a3.v[k]));
    ov[idx] = r;
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int H, int W, int C, void* stream) {
  const int Ho = H / 2;
  const int Wo = W / 2;
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0) return 0;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = C % kVec == 0;
  const long long n = static_cast<long long>(B) * Ho * Wo * (vec ? C / kVec : C);
  const long long want = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    maxpool2x2_kernel<T, kVec><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), H, W, C, Ho, Wo, n);
  } else {
    maxpool2x2_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), H, W, C, Ho, Wo, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 int8, 1 bf16, 2 f32. x [B, H, W, C] -> out [B, H/2, W/2, C], both
// contiguous and 16-byte aligned (checked by ops/maxpool.py). Launches on
// `stream` and returns cudaGetLastError() (0 on success; 1 for an unknown
// dtype, cudaErrorInvalidValue).
int witw_maxpool2x2(const void* x, void* out, int dtype, int B, int H, int W, int C,
                    void* stream) {
  switch (dtype) {
    case 0: return launch<int8_t>(x, out, B, H, W, C, stream);
    case 1: return launch<__nv_bfloat16>(x, out, B, H, W, C, stream);
    case 2: return launch<float>(x, out, B, H, W, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
