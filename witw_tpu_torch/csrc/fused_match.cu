// Fused circular correlation + argmax orientation + chord distance, for
// Hopper (sm_90a), on the tensor cores in 3xTF32 (f32 accuracy).
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
// Layout: o [G, W, hc], s [sw, chunks, Q, pitch], wsq [G, W] (f32,
// contiguous), with the feature-map height folded into the channels
// (hc = h * c). The channels run in `chunks` chunks of hc_pad = 8 kSteps
// (kSteps <= 8; hc <= chunks * hc_pad): s holds chunk ch of column k's
// queries as rows of `pitch` floats, hc_pad channels and then zeros (the
// wrapper lays it out). One chunk when hc <= 64 and the maps fit; more where
// hc is larger or the maps would not fit 227 KB of shared memory with two
// ring stages (W >= 128 at hc = 64). Any hc and W are taken: the kernel holds
// windows of the maps (below), of all sw columns wherever they fit.
//
// Bound: multiply-adds. At CVUSA shapes (W = sw = hc = 64) a (g, q) pair
// costs W * sw * hc = 262k of them against 16 KB of gallery map and 16 KB of
// query. On the CUDA cores (67 TFLOP/s f32) the earlier kernel was bound by
// its shared-memory loads (2 multiply-adds per load, 19.5 TFLOP/s). Here they
// run on the tensor cores as 3xTF32: each f32 value x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and small*big + big*small
// + big*big (the small terms first) keeps about 2^-21 of each product, at
// 3 x 8.59 GFLOP per G = Q = 128 call against 494.7 TFLOP/s of TF32. wgmma
// reads only the top 19 bits of an f32, so both parts are rounded explicitly.
// What limits it then is the rate of the register-fed (A from registers)
// tf32 wgmma: on an H100 80GB HBM3 at 700 W an m64n64k8 takes about 54
// cycles instead of 32, and the kernel takes as long as its wgmma loop alone
// (profile_match.py: 58% of the 3xTF32 bound). Everything else, the loads,
// the split and the copies, runs beside it.
//
// Design: for one gallery map, corr is a GEMM over the contraction (k, j):
// C[q, i] = sum_{k,j} S[q, (k, j)] * O[(i + k) mod W, j]. For column k the
// B operand is the map read from row k on, so it is never materialised.
// - A block holds kMaps = 2 gallery maps and kQTile = 64 queries: grid
//   (ceil(G / 2), ceil(Q / 64)). 384 threads: two consumer warpgroups, one
//   map each, and a producer warpgroup, one thread of which issues the
//   copies; setmaxnreg moves registers from it to the consumers.
// - A pass of shifts [i0, i0 + 64) over columns [k0, k0 + K) reads only map
//   rows (i0 + k0 + r) mod W, r < K + 63. So each map (its channel chunk)
//   sits in shared memory as a window of K + 63 rows, split: a big and a
//   small copy, each as planes of 4 channels (16 bytes) x rows, row r holding
//   o[(i0 + k0 + r) mod W]. The B operand of shift pass i0 at column k is
//   then a no-swizzle K-major descriptor (LBO one plane, SBO 8 rows) whose
//   start is row k - k0: a circular shift is a 16-byte offset of the start,
//   and 64 shifts never run off the end whatever W and sw are. Within an
//   8-channel step, plane 2c holds the even channels and plane 2c + 1 the
//   odd ones, matching the A fragments below. K = `kcols` is sw wherever
//   that fits beside two ring stages (at CVUSA shapes, one window of 127
//   rows holds the whole map), else the most columns that fit (sw > 1720).
// - The producer streams the query columns through a ring of 2-4 stages:
//   (the chunk of) column k of the block's 64 queries is one cp.async.bulk
//   of 64 rows of `pitch` floats (pitch = hc_pad or hc_pad + 8, so that the
//   consumers' 8-byte fragment loads hit 32 distinct banks), counted on the
//   stage's full mbarrier. Both warpgroups read the same column.
// - Each consumer warpgroup loads its A fragments (queries x 8 channels,
//   wgmma's tf32 register layout: rows g and g + 8 of its warp's 16, the
//   pair of channels 2t and 2t + 1 for K indices t and t + 4), frees the
//   stage, splits them in registers (two integer operations a part) and
//   issues per 8 channels three wgmma.mma_async m64n64k8 (A from registers,
//   B from shared memory): one column is 24 products of 32 tensor cycles
//   each at hc = 64. The fragments are double-buffered: column k + 1 is
//   loaded and split while column k's products run. The tensor cores' f32
//   sum truncates, so each column starts its accumulator afresh (scale-d 0)
//   and is added into a second f32 register set with round-to-nearest adds.
// - Items are ordered (pass, window, channel chunk, column): an item of the
//   ring is a chunk of a column, its products added into the total as a
//   column's are, and the total carries across chunks and windows. Each
//   warpgroup refills its map window once its products on the last item of
//   a (pass, window, chunk) are done; with one pass, window and chunk (the
//   CVUSA shapes) it is filled once.
// - Widths above 64 run in passes of 64 shifts over all sw columns. The max
//   and argmax are taken on the accumulator fragments (a thread's own 16
//   columns, then __shfl_xor 1 and 2 within the quad that shares a row) and
//   carried across passes; shifts >= W are masked out. ||s_q|| is summed
//   from the unsplit f32 values with fmaf in the first pass.
// - A ragged last query tile is not copied (its rows are never stored); a
//   block's missing second map (odd G) is zeros and not stored.
// Shared memory: 2 maps x 8 hc_pad (kcols + 63) bytes + stages x
// (256 pitch + 16) bytes; at CVUSA (one chunk, kcols 64) 130,048 + 4
// x 18,448 = 203,840 bytes (ops/fused_match.py:geometry computes it).
// ptxas: 168 registers at launch, no spills.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kConsumers = 256;  // two warpgroups, one gallery map each
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kMaps = 2;         // gallery maps per block; ops/fused_match.py mirrors it
constexpr int kQTile = 64;       // queries per block (M of wgmma)
constexpr int kShifts = 64;      // shifts per pass (N of wgmma)
constexpr int kMaxSteps = 8;     // 8-channel steps of a chunk: hc_pad <= 64
// Registers per thread after setmaxnreg: the producers, one thread of which
// issues the copies, give theirs to the consumers, whose two sets of split A
// fragments (2 x 2 x 32) and two f32 accumulators (2 x 32) take 192. The
// block is launched with 168 a thread, and setmaxnreg only moves registers
// within it: an increase past what the decreases released never completes.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * (kThreads - kConsumers) + kConsumerRegs * kConsumers <=
                  kLaunchRegs * kThreads,
              "setmaxnreg may only redistribute the block's registers");

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
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
// Orders this thread's generic-proxy shared-memory writes before the
// async-proxy reads of wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The 128 threads of consumer warpgroup wg (named barrier 1 + wg).
template <int wg>
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"n"(1 + wg) : "memory");
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite value, in two integer operations (the
// cvt takes about seven). A NaN stays NaN or becomes an infinity whose small
// part x - big is NaN, so a NaN still reaches the sum.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// The 3xTF32 split: x ~ big + small, both exact tf32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// No-swizzle K-major matrix descriptor: start address, LBO (bytes to the next
// core matrix along K) and SBO (bytes to the next 8 rows of N).
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
// Keep the compiler from moving register uses across a wgmma wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[64 x 64] (+)= a[64 x 8] * b[8 x 64] in tf32, f32 accumulate; a from
// registers (wgmma's fragment layout), b through a descriptor. scale_d 0
// overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

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

// An item of a block's sequence, ordered (pass, window, chunk, column): its
// pass, channel chunk and column k, and the first column k0 and the length
// of its window. Each thread steps through the items in order, so the item
// is advanced in place, without divisions (they would stand between the
// products of two items).
struct Item {
  int pass, ch, k, k0, len;
};
__device__ __forceinline__ Item first_item(int sw, int kcols) { return {0, 0, 0, 0, min(kcols, sw)}; }
__device__ __forceinline__ void advance(Item& m, int sw, int chunks, int kcols) {
  if (++m.k < m.k0 + m.len) return;
  m.k = m.k0;
  if (++m.ch < chunks) return;
  m.ch = 0;
  m.k0 += kcols;
  if (m.k0 >= sw) {
    m.k0 = 0;
    ++m.pass;
  }
  m.len = min(kcols, sw - m.k0);
  m.k = m.k0;
}

// kSteps: 8-channel steps of a chunk of a query column (hc_pad = 8 kSteps).
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
fused_corr_distance_kernel(const float* __restrict__ o, const float* __restrict__ s,
                           const float* __restrict__ wsq, float* __restrict__ d,
                           int* __restrict__ orient, int G, int W, int hc, int chunks, int pitch,
                           int Q, int sw, int stages, int kcols) {
  constexpr int hc_pad = 8 * kSteps;
  extern __shared__ __align__(128) unsigned char smem[];
  // [kMaps][big, small][hc_pad / 4 planes][rows][16 B] [stages][kQTile][pitch f32]
  // [full barriers][empty barriers]
  const int rows = kcols + kShifts - 1;
  const uint32_t plane_bytes = rows * 16;
  const uint32_t part_bytes = (hc_pad / 4) * plane_bytes;
  const uint32_t stage_bytes = kQTile * pitch * 4;
  const uint32_t maps0 = smem_addr(smem);
  const uint32_t ring0 = maps0 + kMaps * 2 * part_bytes;
  const uint32_t full0 = ring0 + stages * stage_bytes;
  const uint32_t empty0 = full0 + 8 * stages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int span = chunks * sw;                            // items of a pass
  const int items = (W + kShifts - 1) / kShifts * span;  // (pass, window, chunk, column)

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full0 + 8 * st, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * st, kConsumers / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: item it (chunk ch of column k) into stage it % stages, one
    // bulk copy of the block's queries (rows `pitch` floats apart in s too),
    // once the consumers have freed the stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      const uint32_t bytes = min(kQTile, Q - q0) * pitch * 4;
      Item m = first_item(sw, kcols);
      for (int it = 0; it < items; ++it, advance(m, sw, chunks, kcols)) {
        const int st = it % stages;
        if (it >= stages) mbar_wait(empty0 + 8 * st, (it / stages - 1) & 1);
        mbar_arrive_expect_tx(full0 + 8 * st, bytes);
        const int col = m.k * chunks + m.ch;  // (k, ch) in s
        bulk_copy(ring0 + st * stage_bytes, s + (static_cast<size_t>(col) * Q + q0) * pitch, bytes,
                  full0 + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // Consumers. Warpgroup wg computes map kMaps * blockIdx.x + wg; thread
    // (warp, lane) holds rows 16 (warp % 4) + g and + 8 (g = lane / 4) and,
    // per group n8 of 8 shifts, shifts 8 n8 + 2t and + 1 (t = lane % 4).
    // wg is a constant of each copy of the loop, so that the B descriptors
    // are uniform: all are computed before the products are issued, and none
    // is rewritten between two of them (ptxas would fence each one).
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t frag_off = ((16 * warp + g) * pitch + 2 * t) * 4;
    const auto consume = [&](auto wg_constant) {
      constexpr int wg = decltype(wg_constant)::value;
      const int gm = kMaps * blockIdx.x + wg;  // a missing map (odd G) is zeros, not stored
      const bool vec = hc % 8 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
      // Channel chunk ch of the warpgroup's gallery map, as a window of n
      // rows from map row `base` on, split, into shared memory: thread unit
      // (step c, row r < min(n, W)) writes row r, which holds map row
      // (base + r) mod W, and its copies r + W, r + 2W, ... < n. The first
      // barrier waits for the four warps' products on the previous fill
      // (each waited for its own).
      const auto fill = [&](int ch, int base, int n) {
        warpgroup_sync<wg>();
        const int m = min(n, W);
        for (int u = tid % 128; u < kSteps * m; u += 128) {
          const int r = u % m;
          const int c = u / m;
          const int src_row = (base + r) % W;
          const int c0 = 8 * (ch * kSteps + c);  // the step's first channel
          float v[8];
          if (gm >= G) {
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = 0.f;
          } else if (vec && c0 + 8 <= hc) {
            const auto* src =
                reinterpret_cast<const float4*>(o + (static_cast<size_t>(gm) * W + src_row) * hc + c0);
            const float4 x0 = __ldg(src);
            const float4 x1 = __ldg(src + 1);
            v[0] = x0.x, v[1] = x0.y, v[2] = x0.z, v[3] = x0.w;
            v[4] = x1.x, v[5] = x1.y, v[6] = x1.z, v[7] = x1.w;
          } else {
            const float* src = o + (static_cast<size_t>(gm) * W + src_row) * hc + c0;
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = c0 + j < hc ? __ldg(src + j) : 0.f;
          }
          uint32_t big[8], small[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) split_tf32(v[j], big[j], small[j]);
          const uint32_t even = maps0 + wg * 2 * part_bytes + 2 * c * plane_bytes;
          for (int rr = r; rr < n; rr += W) {
            const uint32_t at = even + rr * 16;
            sts128(at, big[0], big[2], big[4], big[6]);
            sts128(at + plane_bytes, big[1], big[3], big[5], big[7]);
            sts128(at + part_bytes, small[0], small[2], small[4], small[6]);
            sts128(at + part_bytes + plane_bytes, small[1], small[3], small[5], small[7]);
          }
        }
        fence_proxy_async();
        warpgroup_sync<wg>();
      };
      const uint64_t step_desc = (2 * plane_bytes) >> 4;  // one 8-channel step, in descriptor units
      const uint64_t small_desc = part_bytes >> 4;        // the small copy
      using Frags = uint32_t[kSteps][4];
      Frags big0, small0, big1, small1;  // column it's A fragments, it even / odd
      float acc[32], tot[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = tot[i] = 0.f;
      float best_v[2] = {-INFINITY, -INFINITY};
      int best_i[2] = {INT_MAX, INT_MAX};
      float sn[2] = {0.f, 0.f};
      Item cur = first_item(sw, kcols);  // the next item to issue

      // Column it's fragments from its ring stage, split; the stage is freed.
      const auto load = [&](int it, Frags& ab, Frags& as) {
        const int st = it % stages;
        const uint32_t col = ring0 + st * stage_bytes + frag_off;
        mbar_wait(full0 + 8 * st, (it / stages) & 1);
#pragma unroll
        for (int c = 0; c < kSteps; ++c) {
          const float2 lo = lds64(col + c * 32);
          const float2 hi = lds64(col + c * 32 + 8 * pitch * 4);
          const float raw[4] = {lo.x, hi.x, lo.y, hi.y};  // a0..a3: (g, t) (g+8, t) (g, t+4) (g+8, t+4)
          if (it < span) {  // the first pass: ||s_q||^2 of rows g and g + 8
            sn[0] = fmaf(raw[0], raw[0], sn[0]);
            sn[0] = fmaf(raw[2], raw[2], sn[0]);
            sn[1] = fmaf(raw[1], raw[1], sn[1]);
            sn[1] = fmaf(raw[3], raw[3], sn[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(raw[e], ab[c][e], as[c][e]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
      };
      // Item cur's 3 kSteps products into acc: small x big, big x small, then
      // big x big; the first starts acc afresh.
      const auto issue = [&](Frags& ab, Frags& as) {
        // Shift i0 of column k starts at row k - k0 of the map's window.
        const uint64_t b_big = desc(maps0 + wg * 2 * part_bytes + (cur.k - cur.k0) * 16, plane_bytes, 128);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kSteps; ++c) wgmma_tf32(acc, as[c], b_big + c * step_desc, c > 0);
#pragma unroll
        for (int c = 0; c < kSteps; ++c) wgmma_tf32(acc, ab[c], b_big + small_desc + c * step_desc, 1);
#pragma unroll
        for (int c = 0; c < kSteps; ++c) wgmma_tf32(acc, ab[c], b_big + c * step_desc, 1);
        wgmma_commit();
      };
      const auto fence_frags = [&](Frags& ab, Frags& as) {
#pragma unroll
        for (int c = 0; c < kSteps; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fence_operand(ab[c][e]);
            fence_operand(as[c][e]);
          }
        }
      };
      // Does item m end the items of one map fill (the columns of a window
      // and chunk)?
      const auto fill_ends = [&](const Item& m) { return m.k + 1 == m.k0 + m.len; };
      // The map's window as item m reads it.
      const auto refill = [&](const Item& m) { fill(m.ch, m.pass * kShifts + m.k0, m.len + kShifts - 1); };
      // Item it: its products are issued; once item it - 1's are done, item
      // it + 1 is loaded into their fragments while item it's run. Then acc
      // is added into tot (rounded to nearest); at the end of a pass its max
      // / argmax are taken, and at the end of a map fill the map is refilled
      // for the next item.
      const auto step = [&](int it, Frags& ab, Frags& as, Frags& nb, Frags& ns) {
        issue(ab, as);
        const Item m = cur;  // item it
        advance(cur, sw, chunks, kcols);
        wgmma_wait<1>();
        fence_frags(nb, ns);
        if (it + 1 < items) load(it + 1, nb, ns);
        wgmma_wait<0>();
        fence_frags(ab, as);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(acc[i]);
          tot[i] = __fadd_rn(tot[i], acc[i]);
        }
        if (!fill_ends(m)) return;
        if ((it + 1) % span == 0) {
          const int i0 = it / span * kShifts;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = -INFINITY;
            int vi = INT_MAX;
#pragma unroll
            for (int n8 = 0; n8 < kShifts / 8; ++n8) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = i0 + 8 * n8 + 2 * t + e;
                if (i < W) take_better(tot[4 * n8 + 2 * h + e], i, v, vi);
              }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {  // the quad that shares the row
              const float ov = __shfl_xor_sync(0xffffffffu, v, off);
              const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
              take_better(ov, oi, v, vi);
            }
            take_better(v, vi, best_v[h], best_i[h]);
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) tot[i] = 0.f;
        }
        if (it + 1 < items) refill(cur);
      };

      refill(cur);
      load(0, big0, small0);
      for (int it = 0; it < items; it += 2) {
        step(it, big0, small0, big1, small1);
        if (it + 1 < items) step(it + 1, big1, small1, big0, small0);
      }
      // The last column waited for every product; without a wait on every
      // path out of the loop, ptxas adds one and serializes the products.
      wgmma_wait<0>();

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sn[h] += __shfl_xor_sync(0xffffffffu, sn[h], 1);
        sn[h] += __shfl_xor_sync(0xffffffffu, sn[h], 2);
      }
      if (t == 0 && gm < G) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 16 * warp + g + 8 * h;
          if (q < Q) {
            const int i = best_i[h];
            const float w = wsq[static_cast<size_t>(gm) * W + i];
            const float cosv =
                best_v[h] * (1.0f / sqrtf(fmaxf(w, 1e-20f))) / fmaxf(sqrtf(sn[h]), 1e-10f);
            const size_t out = static_cast<size_t>(gm) * Q + q;
            d[out] = 2.0f * (1.0f - cosv);
            orient[out] = i;
          }
        }
      }
    };
    if (tid < 128) {
      consume(std::integral_constant<int, 0>{});
    } else {
      consume(std::integral_constant<int, 1>{});
    }
  }
}

template <int kSteps>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const float* o, const float* s,
           const float* wsq, float* d, int* orient, int G, int W, int hc, int chunks, int pitch, int Q,
           int sw, int stages, int kcols) {
  const auto kernel = fused_corr_distance_kernel<kSteps>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(o, s, wsq, d, orient, G, W, hc, chunks, pitch, Q, sw, stages,
                                           kcols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o f32 [G, W, hc]; s f32 [sw, chunks, Q, pitch] (chunk ch of a query row:
// its hc_pad channels, then zeros); wsq f32 [G, W]; d f32 [G, Q]; orient
// int32 [G, Q]; all contiguous and 4-byte aligned, s 16-byte aligned.
// hc_pad (a multiple of 8, at most 64: the channels of a chunk), `chunks`
// (hc_pad * chunks >= hc, no chunk past hc), `pitch` (at least hc_pad, a
// multiple of 8), `stages` and `smem` (the dynamic shared memory of a
// block, in bytes) and `kcols` (the query columns of a window of the maps,
// 1 <= kcols <= sw) come from ops/fused_match.py:geometry.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int witw_fused_corr_distance(const void* o, const void* s, const void* wsq, void* d,
                             void* orient, int G, int W, int hc, int hc_pad, int chunks, int pitch,
                             int Q, int sw, int stages, int kcols, size_t smem, void* stream) {
  if (G <= 0 || Q <= 0) return 0;
  const size_t need =
      static_cast<size_t>(kMaps) * 8 * hc_pad * (kcols + kShifts - 1) +
      static_cast<size_t>(stages) * (kQTile * pitch * 4 + 16);
  if (W <= 0 || sw <= 0 || sw > W || hc <= 0 || hc_pad <= 0 || hc_pad % 8 != 0 ||
      hc_pad > 8 * kMaxSteps || chunks < 1 || static_cast<long long>(hc_pad) * chunks < hc ||
      hc_pad * (chunks - 1) >= hc || pitch < hc_pad || pitch % 8 != 0 || stages < 1 || kcols < 1 ||
      kcols > sw || smem != need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((G + kMaps - 1) / kMaps, (Q + kQTile - 1) / kQTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* o_ = static_cast<const float*>(o);
  const auto* s_ = static_cast<const float*>(s);
  const auto* wsq_ = static_cast<const float*>(wsq);
  auto* d_ = static_cast<float*>(d);
  auto* orient_ = static_cast<int*>(orient);
  // One instantiation per 8-channel steps of a chunk (hc_pad checked above).
  constexpr decltype(&launch<1>) kLaunch[kMaxSteps] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                                       launch<5>, launch<6>, launch<7>, launch<8>};
  return kLaunch[hc_pad / 8 - 1](grid, smem, st, o_, s_, wsq_, d_, orient_, G, W, hc, chunks, pitch, Q, sw,
                                 stages, kcols);
}

const char* witw_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
