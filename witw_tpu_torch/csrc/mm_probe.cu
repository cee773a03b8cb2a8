// Matmul rate probe on the tensor cores through mma.sync, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels exp/int8_mm_probe.py:mm (s8 x s8 -> int32),
// exp/int8_mm_probe.py:mmf (bf16 x bf16 -> f32) and exp/mosaic_caps.py:t3
// (an s8 dot with N = 64: mm with reps = 1). For a [M, K] and b [K, N],
// passed as bt = b^T [N, K] (K contiguous, packed once by the wrapper):
//
//   s8:   out[i, j] = reps * sum_k a[i, k] b[k, j]          (int32, mod 2^32)
//   bf16: out = the f32 sum of reps copies of a @ b       (f32 accumulate)
//
// The TPU kernel keeps a and b resident in VMEM and its accumulator in
// vregs across `reps` dots: it measures the matrix unit's rate. So does this
// one. Bound: the tensor-core rate, 2 M K N reps operations (989 TFLOP/s
// bf16, 1979 TOP/s int8 dense on an H100 SXM); a and b are read from device
// memory once. This tiling does not reach that bound: per k-step a warp
// loads 4 ldmatrix.x4 (2 KB) for 8 mma, 16 FLOP (bf16) or 32 ops (s8) per
// byte of shared-memory traffic, which at 128 bytes per clock per SM caps
// it near half the peak. It measures this tiling, not mma.sync's ceiling.
//
// Design: one block of 8 warps per 32 x 32 output tile, so that M = 2048,
// N = 128 gives 256 blocks for 132 SMs (a 64 x 128 tile would give 16). The
// block stages its 32 rows of a and 32 rows of bt, all of K, in shared memory
// once (each row padded by 16 bytes, so that the 8 row addresses of an
// ldmatrix phase hit 8 distinct 16-byte bank groups), then runs `reps` times
// over K. K is split over the 8 warps in 32-byte k-steps (one mma depth:
// k32 for s8, k16 for bf16, the same fragment layout in bytes); each warp
// keeps the whole 32 x 32 tile (2 x 4 mma tiles) in registers across reps,
// loads its fragments with ldmatrix.x4 one k-step ahead of the mma that use
// them, and never re-reads device memory. s8: mma m16n8k32 with an s32
// accumulator and no .satfinite, so the sum wraps mod 2^32 as the TPU's
// int32 sum does. bf16: m16n8k16 with f32 accumulate. With kWholeDots (the
// default entry), each warp forms its share of each rep's dot in a zeroed
// fragment and adds it to the accumulator with one round to nearest. The
// order is not the TPU's (a sum over warps of sums over reps, not a sum of
// whole dots), so the result is held to reps * 2^-24 * max|y|. The pass is
// there because the tensor core's f32 sum truncates: accumulating straight
// across reps (kWholeDots false) lands outside that bound at reps 128 and
// 1024, at no measurable gain in rate (PERF.md). At the end the 8
// warps' partial tiles are summed in warp order through shared memory.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;       // output rows and columns of one block
constexpr int kStep = 32;       // bytes of K per mma
constexpr int kRowPad = 16;     // bytes after each staged row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint8_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int32 sums wrap mod 2^32 (unsigned arithmetic); f32 sums round once.
__device__ __forceinline__ int add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }

// The A fragments of both 16-row halves and the B fragments of all four
// 8-column tiles, for the k-step at byte offset kb.
struct Frags {
  uint32_t a[2][4];
  uint32_t b[4][2];
};

__device__ __forceinline__ void load_frags(Frags& f, const uint8_t* a_row, const uint8_t* b_row,
                                           int stride, int kb) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(f.a[mt], a_row + 16 * mt * stride + kb);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    ldmatrix_x4(r, b_row + 16 * p * stride + kb);
    f.b[2 * p][0] = r[0];
    f.b[2 * p][1] = r[1];
    f.b[2 * p + 1][0] = r[2];
    f.b[2 * p + 1][1] = r[3];
  }
}

template <typename Acc>
__device__ __forceinline__ void mma_frags(Acc (&d)[2][4][4], const Frags& f) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma(d[mt][nt], f.a[mt], f.b[nt]);
  }
}

// d += this warp's share of one dot: k-steps warp, warp + 8, ... of n_steps,
// fragments loaded one step ahead.
template <typename Acc>
__device__ __forceinline__ void warp_dot(Acc (&d)[2][4][4], const uint8_t* a_row,
                                         const uint8_t* b_row, int stride, int warp, int n_steps) {
  Frags f0, f1;
  int s = warp;
  if (s < n_steps) load_frags(f0, a_row, b_row, stride, s * kStep);
  for (; s < n_steps; s += 2 * kWarps) {
    const int s1 = s + kWarps;
    if (s1 < n_steps) load_frags(f1, a_row, b_row, stride, s1 * kStep);
    mma_frags(d, f0);
    if (s1 + kWarps < n_steps) load_frags(f0, a_row, b_row, stride, (s1 + kWarps) * kStep);
    if (s1 < n_steps) mma_frags(d, f1);
  }
}

template <typename Acc, bool kWholeDots>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt, Acc* __restrict__ out,
          int N, int k_bytes, int reps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int stride = k_bytes + kRowPad;

  // Stage rows m0.. of a and n0.. of bt (all of K) once, 16 bytes a thread.
  const int chunks = k_bytes / 16;
  for (int i = tid; i < 2 * kTile * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = i % chunks;
    const uint8_t* src = r < kTile ? a + static_cast<size_t>(m0 + r) * k_bytes
                                   : bt + static_cast<size_t>(n0 + r - kTile) * k_bytes;
    *reinterpret_cast<uint4*>(smem + r * stride + 16 * c) =
        *reinterpret_cast<const uint4*>(src + 16 * c);
  }
  __syncthreads();

  // ldmatrix row addresses of this lane: A rows l % 16 at byte 16 (l / 16);
  // B rows l % 8 + 8 (l / 16) at byte 16 ((l / 8) % 2).
  const uint8_t* a_row = smem + (lane % 16) * stride + 16 * (lane / 16);
  const uint8_t* b_row = smem + (kTile + lane % 8 + 8 * (lane / 16)) * stride + 16 * ((lane / 8) % 2);
  const int n_steps = k_bytes / kStep;

  Acc acc[2][4][4] = {};
  for (int r = 0; r < reps; ++r) {
    if constexpr (!kWholeDots) {  // s8, or bf16 in the tensor core's truncating sum
      warp_dot(acc, a_row, b_row, stride, warp, n_steps);
    } else {
      Acc part[2][4][4] = {};
      warp_dot(part, a_row, b_row, stride, warp, n_steps);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = add(acc[mt][nt][q], part[mt][nt][q]);
        }
      }
    }
  }

  // Sum the warps' tiles in warp order: red[warp][row][col].
  __syncthreads();  // every warp is done with the operands
  Acc* red = reinterpret_cast<Acc*>(smem);
  const int group = lane / 4;
  const int tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * mt + group + 8 * (q / 2);
        const int col = 8 * nt + 2 * tig + q % 2;
        red[(warp * kTile + row) * kTile + col] = acc[mt][nt][q];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    Acc s = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = add(s, red[w * kTile * kTile + i]);
    out[static_cast<size_t>(m0 + i / kTile) * N + n0 + i % kTile] = s;
  }
}

size_t smem_bytes(int k_bytes) {
  const size_t operands = static_cast<size_t>(2 * kTile) * (k_bytes + kRowPad);
  const size_t reduce = sizeof(int) * kWarps * kTile * kTile;
  return operands > reduce ? operands : reduce;
}

template <typename Acc, bool kWholeDots>
int launch(const void* a, const void* bt, void* out, int M, int N, int k_bytes, int reps,
           void* stream) {
  if (M <= 0 || N <= 0 || reps <= 0) return 0;
  const size_t smem = smem_bytes(k_bytes);  // more than a block may use: the attribute fails
  const cudaError_t e = cudaFuncSetAttribute(
      mm_kernel<Acc, kWholeDots>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / kTile, M / kTile);
  mm_kernel<Acc, kWholeDots><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt), static_cast<Acc*>(out), N,
      k_bytes, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for rows of k_bytes bytes.
size_t witw_mm_probe_smem_bytes(int k_bytes) { return smem_bytes(k_bytes); }

// a int8 [M, K], bt int8 [N, K] -> out int32 [M, N] = reps * (a @ bt^T) mod
// 2^32. M and N multiples of 64, K a multiple of 32, all contiguous and
// 16-byte aligned (checked by exp/int8_mm_probe.py). Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int witw_mm_s8(const void* a, const void* bt, void* out, int M, int N, int K, int reps,
               void* stream) {
  return launch<int, false>(a, bt, out, M, N, K, reps, stream);
}

// a bf16 [M, K], bt bf16 [N, K] -> out f32 [M, N], the sum of reps copies
// of a @ bt^T; the same conditions. whole_dots != 0 adds each rep's share
// with one round to nearest; 0 accumulates in the tensor core throughout.
int witw_mm_bf16(const void* a, const void* bt, void* out, int M, int N, int K, int reps,
                 int whole_dots, void* stream) {
  return whole_dots ? launch<float, true>(a, bt, out, M, N, 2 * K, reps, stream)
                    : launch<float, false>(a, bt, out, M, N, 2 * K, reps, stream);
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
