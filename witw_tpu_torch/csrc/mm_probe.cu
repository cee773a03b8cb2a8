// Matmul rate probe on the warpgroup tensor cores (wgmma), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels exp/int8_mm_probe.py:mm (s8 x s8 -> int32),
// exp/int8_mm_probe.py:mmf (bf16 x bf16 -> f32) and exp/mosaic_caps.py:t3
// (an s8 dot with N = 64: mm with reps = 1). For a [M, K] and b [K, N],
// passed as bt = b^T [N, K] (K contiguous, as the wrapper's pack_b makes it):
//
//   s8:   out[i, j] = reps * sum_k a[i, k] b[k, j]          (int32, mod 2^32)
//   bf16: out = the f32 sum of reps copies of a @ b       (f32 accumulate)
//
// The TPU kernel keeps a and b resident in VMEM and its accumulator in
// vregs across `reps` dots: it measures the matrix unit's rate. So does this
// one: a and b are read from device memory once, and the sums stay on chip
// across reps. Bound: the tensor-core rate, 2 M K N reps operations (989
// TFLOP/s bf16, 1979 TOP/s int8 dense on an H100 SXM). Only wgmma reaches it.
//
// Design. wgmma m64nNk32 (s8 in, s32 accumulate; SASS IGMMA) or m64nNk16
// (bf16 in, f32 accumulate; HGMMA) with A from registers and B from shared
// memory; a k-step is 32 bytes of K in both types. A block of two
// warpgroups owns 64 rows of a, 2 x WN columns of b (WN = 256, 128, 64 or
// 32 per warpgroup; 128 at most for bf16, whose whole-dot pass keeps two
// accumulators) and one of S slices of K, at most 9 k-steps (288 bytes)
// each, so that M = 2048, N = 128 fills the card (32 tiles x 4 slices for
// s8 at K = 1152, x 8 for bf16; two blocks an SM fit at WN <= 64) where one
// block per tile would leave 100 of 132 SMs idle.
// - Each thread loads its rows of the slice of a once into registers (9
//   k-steps x 4 registers) in wgmma's A fragment layout (rows lane / 4 and
//   + 8 of its warp's 16, bytes 4 (lane % 4) and + 16 of each step). With A
//   in registers only B is read from shared memory: 128 operations per
//   byte, against the 64 that the SM needs to keep its tensor cores fed (128
//   bytes per clock per SM against 8192 int8 operations); with both from
//   shared memory m64n128k32 carries 85.
// - The block copies its slice of bt into shared memory once (16-byte
//   cp.async) in the no-swizzle K-major order of the B descriptor: [k-step]
//   [2 WN / 8 groups][2 k halves][8 rows][16 bytes], LBO 128, SBO 256.
// - Per rep, each warpgroup issues 9 wgmma as one commit group, with no
//   branch between them (a branch between two wgmma makes ptxas wait for
//   the first before it issues the second). A slice of fewer steps runs
//   its last ones on zero A fragments. s8 accumulates straight across reps:
//   no .satfinite, so the s32 sum wraps mod 2^32 as the TPU's int32 sum
//   does. bf16 with kWholeDots (the default entry) forms each rep's dot in a
//   second accumulator (scale-d 0 on its first step), waits for it and adds
//   it with one round to nearest: the tensor core's f32 sum truncates, and
//   accumulating straight across reps (kWholeDots false) lands outside
//   reps * 2^-24 * max|y| at 1024 reps.
// - With S > 1 each block stores its partial tile into a workspace [S, M,
//   N], and reduce_slices adds the S partials of each element in slice
//   order (wrapping adds for s32, round to nearest for f32): deterministic,
//   and the blocks need no co-scheduling. The order is not the TPU's (a sum
//   over K slices of sums over reps), so bf16 at many reps is held to reps *
//   2^-24 * max|y|; the checks' inputs are integers, whose sums below 2^24
//   are exact in any order.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "int8_wgmma.cuh"

namespace {

using namespace witw;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 64;       // rows of a per block: one wgmma M
constexpr int kStepBytes = 32;  // bytes of K per wgmma: k32 of s8, k16 of bf16
constexpr int kSteps = 9;       // k-steps of a slice, held in registers

struct S8 {
  using Acc = int;
};
struct Bf16 {
  using Acc = float;
};

// d[64 x N] (+)= a[64 x 32 bytes] (registers) * b[32 bytes x N] (shared
// memory, K-major descriptor); scale_d 0 overwrites d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(typename T::Acc (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<S8, 32>(int (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<S8, 64>(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<S8, 128>(int (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<S8, 256>(int (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<Bf16, 32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<Bf16, 64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<Bf16, 128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bits(int x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

template <typename T, int WN, bool kWholeDots>
__global__ void __launch_bounds__(kThreads, WN <= 64 ? 2 : 1)
mm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt, typename T::Acc* __restrict__ out,
          int M, int N, int k_bytes, int reps) {
  using Acc = typename T::Acc;
  constexpr int kBN = 2 * WN;    // columns of the block
  constexpr int kAcc = WN / 2;   // accumulator registers of a thread
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int slice = blockIdx.z;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kBN;
  const int steps = k_bytes / kStepBytes;
  const int s0 = slice * steps / gridDim.z;  // this block's k-steps [s0, s0 + ns)
  const int ns = (slice + 1) * steps / gridDim.z - s0;

  // The slice of bt, rows n0.., into the B descriptor's order.
  const uint32_t bs = smem_addr(smem);
  const int chunks = 2 * ns;  // 16-byte chunks of a row
  for (int i = tid; i < kBN * chunks; i += kThreads) {
    const int n = i / chunks;
    const int j = i % chunks;
    cp_async16(bs + (j / 2) * kBN * kStepBytes + (n / 8) * 256 + (j % 2) * 128 + (n % 8) * 16,
               bt + static_cast<size_t>(n0 + n) * k_bytes + (s0 * kStepBytes + 16 * j), 16);
  }
  cp_async_commit();

  // This thread's A fragments: rows 16 warp + lane / 4 and + 8, bytes
  // 4 (lane % 4) and + 16 of each k-step; zeros past the slice, whose B
  // descriptor reads the slice's first step.
  uint32_t af[kSteps][4];
  uint64_t bd[kSteps];
  const uint8_t* ar =
      a + static_cast<size_t>(m0 + 16 * warp + lane / 4) * k_bytes + (s0 * kStepBytes + 4 * (lane % 4));
  const size_t row8 = 8 * static_cast<size_t>(k_bytes);
  const uint32_t bw = bs + wg * (WN / 8) * 256;  // this warpgroup's columns
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const bool in = j < ns;
    const uint8_t* p = ar + j * kStepBytes;
    af[j][0] = in ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
    af[j][1] = in ? __ldg(reinterpret_cast<const unsigned*>(p + row8)) : 0u;
    af[j][2] = in ? __ldg(reinterpret_cast<const unsigned*>(p + 16)) : 0u;
    af[j][3] = in ? __ldg(reinterpret_cast<const unsigned*>(p + row8 + 16)) : 0u;
    bd[j] = desc(bw + (in ? j : 0) * kBN * kStepBytes, 128, 256);
  }
  cp_async_wait<0>();
  fence_proxy_async();  // the copies, before wgmma's reads
  __syncthreads();

  Acc acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = Acc(0);
  if constexpr (kWholeDots) {
    Acc part[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) part[i] = Acc(0);
    for (int r = 0; r < reps; ++r) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) wgmma_rs<T, WN>(part, af[j], bd[j], j > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        fence_operand(part[i]);
        acc[i] = __fadd_rn(acc[i], part[i]);
      }
    }
  } else {
    for (int r = 0; r < reps; ++r) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) wgmma_rs<T, WN>(acc, af[j], bd[j], 1);
      wgmma_commit();
      wgmma_wait<1>();  // at most two reps in flight
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
  }

  // The partial tile, into out (one slice) or slice `slice` of the workspace.
  Acc* dst = out + static_cast<size_t>(slice) * M * N + static_cast<size_t>(m0 + 16 * warp + lane / 4) * N +
             (n0 + wg * WN + 2 * (lane % 4));
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    *reinterpret_cast<uint2*>(dst + 8 * j) = make_uint2(bits(acc[4 * j]), bits(acc[4 * j + 1]));
    *reinterpret_cast<uint2*>(dst + 8 * static_cast<size_t>(N) + 8 * j) =
        make_uint2(bits(acc[4 * j + 2]), bits(acc[4 * j + 3]));
  }
}

// int32 sums wrap mod 2^32; f32 sums round once.
__device__ __forceinline__ int add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }

// out[i] = the sum of part[0][i], ..., part[slices - 1][i] in that order,
// four elements a thread.
template <typename Acc>
__global__ void __launch_bounds__(256)
reduce_slices(const Acc* __restrict__ part, Acc* __restrict__ out, size_t quads, int slices) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  using Vec = std::conditional_t<std::is_same_v<Acc, int>, int4, float4>;
  Vec s = reinterpret_cast<const Vec*>(part)[i];
  for (int q = 1; q < slices; ++q) {
    const Vec v = reinterpret_cast<const Vec*>(part)[q * quads + i];
    s.x = add(s.x, v.x);
    s.y = add(s.y, v.y);
    s.z = add(s.z, v.z);
    s.w = add(s.w, v.w);
  }
  reinterpret_cast<Vec*>(out)[i] = s;
}

template <typename T, int WN, bool kWholeDots>
int launch(const void* a, const void* bt, void* out, void* work, int M, int N, int k_bytes, int reps,
           int slices, cudaStream_t stream) {
  using Acc = typename T::Acc;
  const auto kernel = mm_kernel<T, WN, kWholeDots>;
  const int smem = 2 * WN * kSteps * kStepBytes;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Acc* part = static_cast<Acc*>(slices > 1 ? work : out);
  kernel<<<dim3(M / kRows, N / (2 * WN), slices), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt), part, M, N, k_bytes, reps);
  e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return static_cast<int>(e);
  const size_t quads = static_cast<size_t>(M) * N / 4;
  reduce_slices<Acc><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
      part, static_cast<Acc*>(out), quads, slices);
  return static_cast<int>(cudaGetLastError());
}

// wn: 256 (s8 only), 128, 64 or 32 columns per warpgroup.
template <typename T, bool kWholeDots>
int dispatch(const void* a, const void* bt, void* out, void* work, int M, int N, int k_bytes, int reps, int wn,
             int slices, void* stream) {
  const int steps = k_bytes / kStepBytes;
  if (M <= 0 || N <= 0 || reps <= 0) return 0;
  if (M % kRows != 0 || k_bytes % kStepBytes != 0 || steps == 0 || slices < 1 || slices > steps ||
      (steps + slices - 1) / slices > kSteps || N % (2 * wn) != 0 || N / (2 * wn) > 65535 || slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wn) {
    case 256:
      if constexpr (std::is_same_v<T, S8>) {
        return launch<T, 256, kWholeDots>(a, bt, out, work, M, N, k_bytes, reps, slices, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    case 128: return launch<T, 128, kWholeDots>(a, bt, out, work, M, N, k_bytes, reps, slices, s);
    case 64: return launch<T, 64, kWholeDots>(a, bt, out, work, M, N, k_bytes, reps, slices, s);
    case 32: return launch<T, 32, kWholeDots>(a, bt, out, work, M, N, k_bytes, reps, slices, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a int8 [M, K], bt int8 [N, K] -> out int32 [M, N] = reps * (a @ bt^T) mod
// 2^32. wn (256, 128, 64 or 32) columns per warpgroup, N a multiple of
// 2 wn; M a multiple of 64; K a multiple of 32 split into `slices` slices of
// at most 9 x 32 bytes; work int32 [slices, M, N] (unused for one slice);
// all contiguous and 16-byte aligned (the wrapper, exp/int8_mm_probe.py,
// picks wn and slices and checks the rest). Launches on `stream` and
// returns the CUDA error code (0 on success).
int witw_mm_s8(const void* a, const void* bt, void* out, void* work, int M, int N, int K, int reps, int wn,
               int slices, void* stream) {
  return dispatch<S8, false>(a, bt, out, work, M, N, K, reps, wn, slices, stream);
}

// a bf16 [M, K], bt bf16 [N, K] -> out f32 [M, N], the sum of reps copies
// of a @ bt^T; the same conditions on 2 K bytes of K, wn at most 128, work
// f32. whole_dots != 0 adds each rep's dot with one round to nearest; 0
// accumulates in the tensor core throughout.
int witw_mm_bf16(const void* a, const void* bt, void* out, void* work, int M, int N, int K, int reps,
                 int whole_dots, int wn, int slices, void* stream) {
  return whole_dots ? dispatch<Bf16, true>(a, bt, out, work, M, N, 2 * K, reps, wn, slices, stream)
                    : dispatch<Bf16, false>(a, bt, out, work, M, N, 2 * K, reps, wn, slices, stream);
}

}  // extern "C"
