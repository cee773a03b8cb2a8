// The layout probes of the fused int8 block kernels, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels exp/mosaic_caps.py:t1, t2 and t4, which
// asked whether the TPU compiler lowers 64-lane int8 slices, lane concats and
// the parity patch build. Here they ask the same of the Tensor Memory
// Accelerator (TMA): int8 boxes of half a row at a column offset of half a
// row, and 3D boxes stored as 2D. For x int8 with rows of C bytes (h = C / 2):
//
//   t1 half_sum:    out int32 [R, h] = x[:, :h] + x[:, h:]
//   t2 swap_halves: out int8 [R, C]  = concat(x[:, h:], x[:, :h])
//   t4 patches:     out int8 [R*W, C] = concat(x[..., :h].reshape(R*W, h),
//                                              x[..., h:].reshape(R*W, h))
//
// Row for row t4 is x.reshape(R*W, C). (exp/mosaic_caps.py:t3, the s8 dot,
// runs on the matmul kernel, csrc/mm_probe.cu.)
//
// Bound: bytes, each input read once and each output written once. At
// kernel C's block-2 slab (134 MB in) that is the memory rate; at the TPU
// script's shapes (32 to 128 KB) it is the launch: one kernel node of a
// graph and one round trip to memory.
//
// Design. A unit of work is a box of rows times a column chunk of each half
// (a box dimension holds at most 256 elements, so a half past 256 bytes takes
// several chunks), and block u takes unit u. One thread loads the unit's two
// halves by two TMA tensor loads counted on one mbarrier. t2 and t4 store them
// back by two TMA tensor stores at the output's columns, and no thread touches
// the bytes: t2 at the swapped columns; t4 loads each half as the 3D box
// [rows, W, chunk] of x [R, W, C] and stores it as the 2D box [rows * W,
// chunk] of the output, the parity patch build. t1's 256 threads widen and add
// the halves from shared memory into an int32 box, which one TMA store
// writes. Overlap at the slab comes from the blocks resident on an SM (eight
// of t1's 24 KB, 14 of t2's and t4's 16 KB): a persistent grid whose one
// thread walked the units through a ring of 4 or 8 stages measured no faster,
// and took more code. At the probes' sizes a box holds an eighth of the rows,
// so that eight SMs share the round trip. The tensor maps are encoded on the
// host on every call (the pointers change) through the driver's
// cuTensorMapEncodeTiled, and passed as __grid_constant__ parameters, which a
// CUDA graph captures by value.
// Launch: programmatic dependent launch (PDL). Before griddepcontrol.wait a
// kernel only initialises its barrier and prefetches its tensor maps, so that
// part overlaps the kernel before it; every global read and write comes after
// the wait; once a block has issued its loads it lets the next kernel launch.
// The tiling is exp/mosaic_caps.py:geometry's.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace witw;

constexpr int kSumThreads = 256;   // t1: threads that widen and add
constexpr int kCopyThreads = 1;    // t2, t4: one thread issues every copy

// What geometry() chose, and what follows from it. Block u takes unit u.
struct Plan {
  int units;       // boxes of rows x column chunks: the grid
  int chunks;      // column chunks of a half
  int chunk;       // columns of a chunk (elements)
  int h;           // columns of a half
  int box_rows;    // rows a box steps over in the input (t4: slab rows of W pixels)
  int out_rows;    // output rows a box writes (box_rows * W)
  int half_bytes;  // one half's box in shared memory, padded to 128 bytes
  int out_bytes;   // t1: the int32 output box, padded to 128 bytes
};

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// One box of a 2D map at {c0, c2} or of a 3D map at {c0, 0, c2} (innermost
// first) into shared memory, counted on `bar`.
template <int kDims>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c2, uint32_t bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (kDims == 2) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(dst), "l"(m), "r"(c0), "r"(c2), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        ::"r"(dst), "l"(m), "r"(c0), "r"(0), "r"(c2), "r"(bar)
        : "memory");
  }
}
// One box of shared memory to a 2D map at {c0, c1}, in the current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Until every bulk group has completed, its writes included.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Waits for the grids this one depends on to complete and flush (a no-op
// without PDL); then lets the next grid launch.
__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ int byte_at(uint32_t w, int k) {  // signed byte k of w
  return static_cast<int>(w << (24 - 8 * k)) >> 24;
}

// Load the block's unit (both halves) into shared memory, counted on `bar`.
template <int kDims>
__device__ __forceinline__ void load_unit(const CUtensorMap* in, const Plan& p, uint32_t lo, uint32_t bar) {
  const int u = static_cast<int>(blockIdx.x);
  const int col = (u % p.chunks) * p.chunk, row = (u / p.chunks) * p.box_rows;
  mbar_arrive_expect_tx(bar, 2 * p.out_rows * p.chunk);  // two int8 boxes of out_rows x chunk
  tma_load<kDims>(lo, in, col, row, bar);
  tma_load<kDims>(lo + p.half_bytes, in, p.h + col, row, bar);
}

// t2 (kDims 2, swapped) and t4 (kDims 3, in place): one thread a block.
template <int kDims, bool kSwap>
__global__ void __launch_bounds__(kCopyThreads)
copy_halves_kernel(const __grid_constant__ CUtensorMap in, const __grid_constant__ CUtensorMap out, const Plan p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  const uint32_t lo = smem_addr(smem), bar = smem_addr(&full);
  mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  prefetch_map(&in);
  prefetch_map(&out);
  grid_dependency_wait();

  load_unit<kDims>(&in, p, lo, bar);
  launch_dependents();
  mbar_wait(bar, 0);
  fence_proxy_async();
  const int u = static_cast<int>(blockIdx.x);
  const int col = (u % p.chunks) * p.chunk, row = (u / p.chunks) * p.out_rows;
  tma_store(&out, lo, (kSwap ? p.h : 0) + col, row);
  tma_store(&out, lo + p.half_bytes, (kSwap ? 0 : p.h) + col, row);
  bulk_commit();
  bulk_wait_all();
}

// t1: thread 0 loads and stores; all threads widen and add, one 4-byte word
// of each half into 16 bytes of int32 at a time.
__global__ void __launch_bounds__(kSumThreads)
half_sum_kernel(const __grid_constant__ CUtensorMap in, const __grid_constant__ CUtensorMap out, const Plan p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  const int tid = threadIdx.x;
  const uint32_t lo = smem_addr(smem), hi = lo + p.half_bytes, sum = hi + p.half_bytes;
  const uint32_t bar = smem_addr(&full);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&in);
    prefetch_map(&out);
  }
  __syncthreads();
  grid_dependency_wait();

  if (tid == 0) load_unit<2>(&in, p, lo, bar);
  launch_dependents();
  mbar_wait(bar, 0);
  for (int w = tid; w < p.out_rows * p.chunk / 4; w += kSumThreads) {
    const uint32_t a = lds32(lo + 4 * w), b = lds32(hi + 4 * w);
    sts128(sum + 16 * w, byte_at(a, 0) + byte_at(b, 0), byte_at(a, 1) + byte_at(b, 1),
           byte_at(a, 2) + byte_at(b, 2), byte_at(a, 3) + byte_at(b, 3));
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    const int u = static_cast<int>(blockIdx.x);
    tma_store(&out, sum, (u % p.chunks) * p.chunk, (u / p.chunks) * p.out_rows);
    bulk_commit();
    bulk_wait_all();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once (no link to libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A tensor map over a row-major tensor of `dims` dimensions: `size` and the
// box innermost first, `pitch` the byte strides of the outer dimensions.
int encode(CUtensorMap* map, CUtensorMapDataType type, int dims, const void* base, const cuuint64_t* size,
           const cuuint64_t* pitch, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(dims), const_cast<void*>(base), size, pitch, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

int pad128(long long bytes) { return static_cast<int>((bytes + 127) / 128 * 128); }

Plan make_plan(long long rows, int width, int cols, int chunk, int box_rows, bool sum) {
  Plan p;
  p.h = cols / 2;
  p.chunk = chunk;
  p.chunks = p.h / chunk;
  p.box_rows = box_rows;
  p.out_rows = box_rows * width;
  p.units = static_cast<int>((rows + box_rows - 1) / box_rows) * p.chunks;
  p.half_bytes = pad128(static_cast<long long>(p.out_rows) * chunk);
  p.out_bytes = sum ? pad128(4LL * p.out_rows * chunk) : 0;
  return p;
}

int smem_bytes(const Plan& p) { return 2 * p.half_bytes + p.out_bytes; }

template <typename Kernel>
int launch(Kernel kernel, int threads, const Plan& p, int pdl, cudaStream_t stream, const CUtensorMap& in,
           const CUtensorMap& out) {
  const int smem = smem_bytes(p);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.units);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, in, out, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// What geometry() guarantees: a chunk of a multiple of 16 bytes that divides
// a half, boxes of at most 256 along each dimension, units that fit the grid.
bool plan_ok(long long rows, int width, int cols, int chunk, int box_rows) {
  return rows > 0 && width > 0 && width <= 256 && cols > 0 && cols % 32 == 0 && chunk > 0 && chunk % 16 == 0 &&
         chunk <= 256 && (cols / 2) % chunk == 0 && box_rows > 0 && box_rows * width <= 256 &&
         (rows + box_rows - 1) / box_rows * ((cols / 2) / chunk) < 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The tiling (chunk, box_rows; t4 also width) is exp/mosaic_caps.py:geometry's
// for these sizes; x and out contiguous and 16-byte aligned (checked there).
// Each entry encodes its tensor maps, launches on `stream` with PDL when
// `pdl` is 1, and returns 0, a cudaError_t, or 100000 + the CUresult of a
// refused tensor map.

// x int8 [rows, cols] -> out int32 [rows, cols / 2], the sum of the halves.
int witw_caps_half_sum(const void* x, void* out, long long rows, int cols, int chunk, int box_rows, int pdl,
                       void* stream) {
  if (!plan_ok(rows, 1, cols, chunk, box_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(rows, 1, cols, chunk, box_rows, true);
  CUtensorMap in_map, out_map;
  const cuuint64_t in_size[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t in_pitch[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint64_t out_size[2] = {static_cast<cuuint64_t>(p.h), static_cast<cuuint64_t>(rows)};
  const cuuint64_t out_pitch[1] = {4ULL * p.h};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(box_rows)};
  int e = encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, in_size, in_pitch, box);
  if (e == 0) e = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, out, out_size, out_pitch, box);
  if (e != 0) return e;
  return launch(half_sum_kernel, kSumThreads, p, pdl, static_cast<cudaStream_t>(stream), in_map, out_map);
}

// x int8 [rows, cols] -> out int8 [rows, cols] with the halves swapped.
int witw_caps_swap_halves(const void* x, void* out, long long rows, int cols, int chunk, int box_rows, int pdl,
                          void* stream) {
  if (!plan_ok(rows, 1, cols, chunk, box_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(rows, 1, cols, chunk, box_rows, false);
  CUtensorMap in_map, out_map;
  const cuuint64_t size[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(box_rows)};
  int e = encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, size, pitch, box);
  if (e == 0) e = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, out, size, pitch, box);
  if (e != 0) return e;
  return launch(copy_halves_kernel<2, true>, kCopyThreads, p, pdl, static_cast<cudaStream_t>(stream),
                in_map, out_map);
}

// x int8 [rows, width, cols] -> out int8 [rows * width, cols]: each half's
// 3D boxes [box_rows, width, chunk] stored as 2D boxes [box_rows * width, chunk].
int witw_caps_patches(const void* x, void* out, long long rows, int width, int cols, int chunk, int box_rows,
                      int pdl, void* stream) {
  if (!plan_ok(rows, width, cols, chunk, box_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(rows, width, cols, chunk, box_rows, false);
  CUtensorMap in_map, out_map;
  const cuuint64_t in_size[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(width),
                                 static_cast<cuuint64_t>(rows)};
  const cuuint64_t in_pitch[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(cols) * width};
  const cuuint32_t in_box[3] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(width),
                                static_cast<cuuint32_t>(box_rows)};
  const cuuint64_t out_size[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows) * width};
  const cuuint64_t out_pitch[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t out_box[2] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(p.out_rows)};
  int e = encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, x, in_size, in_pitch, in_box);
  if (e == 0) e = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, out, out_size, out_pitch, out_box);
  if (e != 0) return e;
  return launch(copy_halves_kernel<3, false>, kCopyThreads, p, pdl, static_cast<cudaStream_t>(stream),
                in_map, out_map);
}

}  // extern "C"
