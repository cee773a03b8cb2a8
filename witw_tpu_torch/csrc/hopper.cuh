// The Hopper (sm_90a) plumbing every kernel library of csrc/ shares, defined
// once: shared-memory addresses, mbarriers, bulk and 16-byte asynchronous
// copies, the proxy fence, the wgmma fences, waits and matrix descriptors,
// vector shared-memory stores and loads; on the host, the persistent grid of
// a launch, the dynamic shared-memory attribute, and the error string each
// library exports.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace witw {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16) into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// 16 bytes from global memory, or 16 zeros when `src_bytes` is 0, to a
// shared-memory address or to a generic pointer into shared memory.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  cp_async16(smem_addr(dst), src, src_bytes);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}
// Orders this thread's generic-proxy shared-memory accesses (cp.async,
// st.shared) before the async proxy's (wgmma's reads, the TMA's).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, int a, int b, int c, int d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void sts64(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(static_cast<uint16_t>(v)) : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// No-swizzle K-major matrix descriptor: start address, LBO (bytes to the next
// core matrix along K) and SBO (bytes to the next 8 rows of M or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keeps the compiler from moving register uses across a wgmma wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// The dynamic shared memory `kernel` may use, in bytes.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The grid of a persistent launch of `kernel` over `tiles` tiles, each
// block walking tiles blockIdx.x + i * gridDim.x: one block per slot that
// can be resident on the card at `threads` threads and `smem` bytes of
// dynamic shared memory, and no more blocks than tiles. Sets `smem` first.
// Returns the first CUDA error; *grid is set only on success.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, long long tiles, int* grid) {
  cudaError_t e = set_smem(kernel, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) *grid = static_cast<int>(tiles < 1LL * sms * per_sm ? tiles : 1LL * sms * per_sm);
  return e;
}

// Codes from kEncodeError up are kEncodeError + the CUresult of a tensor
// map that cuTensorMapEncodeTiled refused (caps.cu); below it, cudaError_t.
constexpr int kEncodeError = 100000;

}  // namespace witw

// Every library's message for the codes its entry points return.
extern "C" const char* witw_cuda_error_string(int e) {
  if (e >= witw::kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
