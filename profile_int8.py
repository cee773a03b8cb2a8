#!/usr/bin/env python3
"""Device-time breakdown of the port's static-int8 serving path on one NVIDIA GPU.

    python3 profile_int8.py [--steps 4] [--out chiprun_out/profile_int8.json]

Builds the port's kernels and calibrates random-weight towers (seed 0) on 8
preprocessed samples, as chip_smoke.py does, then:
1. runs torch.profiler over --steps int8 embed+match steps (batch 128,
   fov 360, inputs varied) and prints each kernel group's launches and self
   device time per step, its share of device time, and the device-busy
   share of the profiled wall time (merged kernel intervals over the time
   from the first kernel's start to the last one's end);
2. times kernel A at each conv of the surface tower and kernel C at block 2
   with CUDA events (median of 5) and prints useful int8 TOP/s: 2 x the
   multiply-adds of the real (unpadded) input channels over kernel time;
3. where kernel A's time goes at each of those convs: it builds three copies
   of csrc/int8_conv.cu edited at fixed lines (the script fails if a line it
   edits is gone) into witw_tpu_torch/_build/profile_int8/: "clock" (consumer
   thread 0 of each block reads clock64 around each tile's main loop, its
   waits for a full stage inside it, and its epilogue; producer thread 0
   around its waits for a free stage), "noload" (the producers copy nothing;
   the ring's barriers still turn) and "nomma" (the consumers issue no
   wgmma); it prints each copy's ms beside the kernel's and the clock copy's
   means per tile in SM cycles;
4. where kernel C's time goes at block 2 of the surface tower: three copies
   of csrc/fused_block2.cu, edited in the same way into the same directory:
   "clock" (consumer thread 0 reads clock64 around all of stage 1, until
   its first block's wgmma is done, around its waits for the halo and the
   weights and around its three y1 epilogues (the later blocks' wgmma runs
   beside them); around stage 2's main loop and its waits for data; around
   the pooling epilogue; the weights' producer thread around its waits for
   a free stage, the first halo thread around its waits for a free halo),
   "noload" (no halo and no weight copies; the barriers still turn) and
   "nomma" (no wgmma); each copy's ms beside the kernel's, and the clock
   copy's means per tile.
The same numbers go to --out as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (block2_args, card_line, conv_case, int8_distance, raw_batch, run_conv,
                        tower_calls)
from profile_conv import COUNTERS, build, edit
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, build_libraries
from witw_tpu_torch.models import quantize
from witw_tpu_torch.models.backbones.vgg16 import VGG16_BLOCKS
from witw_tpu_torch.ops import fused_block2, int8_conv
from witw_tpu_torch.train.pipeline import FovPipeline
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.profiling import cuda_ms

GROUPS = (  # (kernel-name pattern, group), first match wins
    (r"conv3x3_int8_kernel<\d+, true>", "kernel A, dequant epilogue"),
    (r"conv3x3_int8_kernel<\d+, false>", "kernel A, int8 conv + requant"),
    ("fused_block2_kernel", "kernel C, fused block 2"),
    ("maxpool2x2_kernel", "kernel B, max pool"),
    ("fused_corr_distance_kernel", "fused match"),
)
OTHER = "other: int8 preprocess (gather, index, normalize, quantize) and copies"
COPIES_DIR = BUILD_DIR / "profile_int8"
# kernel C's clock copy: cycles per tile of consumer thread 0 (stage 1 until
# its first block's wgmma is done, its waits for the halo and the weights,
# its three y1 epilogues, all of stage 1; stage 2's main loop, its waits for
# data, its pooling epilogue), tiles, and the producers' waits for a free
# weight stage and for a free halo
C_COUNTERS = ("s1_first", "s1_wait", "s1_epilogue", "s1_total", "s2_main", "s2_wait", "s2_epilogue",
              "tiles", "weights_wait_empty", "halo_wait_empty")


def group_of(name: str) -> str:
    return next((g for key, g in GROUPS if re.search(key, name)), OTHER)


def stripped(src: str, mode: str) -> str:
    """Kernel A's source without its copies (noload: the barriers still
    arrive) or without its wgmma (nomma)."""
    if mode == "noload":
        src, n = re.subn(r"\n(\s*)mbar_arrive_expect_tx\(full, kWBytes\);\n\s*bulk_copy\([^;]*\);",
                         r"\n\1mbar_arrive(full);", src)
        src, m = re.subn(r"\n(\s*)cp_async16\([^;]*\);", "", src)
        if n != 1 or m != 1:
            raise RuntimeError("profile_int8: kernel A's copies are not where expected")
        return src
    start = "        wgmma_fence();\n#pragma unroll\n        for (int tap"
    end = "        wgmma_wait<1>();  // the previous step is done: release its stage\n"
    a, b = src.index(start), src.index(end) + len(end)
    return src[:a] + src[b:]


def clocked(src: str) -> str:
    """Kernel A's source with clock64 counters (profile_conv.COUNTERS) read by
    witw_prof_read and cleared by witw_prof_reset."""
    src = edit(src, "namespace {\n", "__device__ unsigned long long g_prof[5];\nnamespace {\n")
    src = edit(src, 'extern "C" {\n',
               'extern "C" {\n'
               "void witw_prof_read(unsigned long long* h) { cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
               "void witw_prof_reset() {\n"
               "  const unsigned long long z[5] = {};\n"
               "  cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
               "}\n")
    src = edit(src, "      int acc[2][N / 2];\n",
               "      const long long t_tile = clock64();\n      long long t_full = 0;\n"
               "      int acc[2][N / 2];\n")
    src = edit(src, "        mbar_wait(full0 + 8 * st, (k / stages) & 1);\n",
               "        const long long t_w = clock64();\n"
               "        mbar_wait(full0 + 8 * st, (k / stages) & 1);\n"
               "        t_full += clock64() - t_w;\n")
    last = "      if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % stages));  // the tile's last step\n"
    src = edit(src, last, last + "      const long long t_main = clock64();\n")
    i = src.index("      // Epilogue: per pass")
    j = src.index("\ntemplate <int N, bool kDequant>\nint launch(")
    end = src.rindex("    }\n  }\n}", i, j)
    src = (src[:end] + "      if (tid == 0) {\n"
           "        atomicAdd(&g_prof[0], static_cast<unsigned long long>(t_main - t_tile));\n"
           "        atomicAdd(&g_prof[1], static_cast<unsigned long long>(clock64() - t_main));\n"
           "        atomicAdd(&g_prof[2], 1ull);\n"
           "        atomicAdd(&g_prof[3], static_cast<unsigned long long>(t_full));\n"
           "      }\n" + src[end:])
    return edit(src, "        if (k >= stages) mbar_wait(empty0 + 8 * st, (k / stages - 1) & 1);\n",
                "        if (k >= stages) {\n"
                "          const long long t_w = clock64();\n"
                "          mbar_wait(empty0 + 8 * st, (k / stages - 1) & 1);\n"
                "          if (p == 0) atomicAdd(&g_prof[4], static_cast<unsigned long long>(clock64() - t_w));\n"
                "        }\n")


def c_stripped(src: str, mode: str) -> str:
    """Kernel C's source without its halo and weight copies (noload: the
    barriers still arrive) or without its wgmma (nomma)."""
    if mode == "noload":
        src = edit(src, "          mbar_arrive_expect_tx(full, kWBytes);\n"
                   "          bulk_copy(ws0 + st * kWBytes, src, kWBytes, full);\n",
                   "          mbar_arrive(full);\n")
        return edit(src, "          cp_async16(xs0 + hp * kXPlane + pix * 16, src, ok ? 16 : 0);\n", "")
    src, n = re.subn(r"\n\s*wgmma_s8<kC>\([^;]*\);", "", src)
    if n != 2:
        raise RuntimeError("profile_int8: kernel C's wgmma calls are not where expected")
    return src


def c_clocked(src: str) -> str:
    """Kernel C's source with the clock64 counters of C_COUNTERS, read by
    witw_prof_read and cleared by witw_prof_reset."""
    n = len(C_COUNTERS)
    src = edit(src, "namespace {\n", f"__device__ unsigned long long g_prof[{n}];\nnamespace {{\n")
    src = edit(src, 'extern "C" {\n',
               'extern "C" {\n'
               "void witw_prof_read(unsigned long long* h) { cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
               "void witw_prof_reset() {\n"
               f"  const unsigned long long z[{n}] = {{}};\n"
               "  cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
               "}\n")

    def timed(line, var):  # accumulate the cycles of one statement into var
        pad = line[:len(line) - len(line.lstrip())]
        return edit_src(line, pad + "{ const long long t_w = clock64();\n" + line
                        + pad + f"{var} += clock64() - t_w; }}\n")

    def edit_src(old, new):
        nonlocal src
        src = edit(src, old, new)

    edit_src("        int acc[2][kC / 2];\n",
             "        const long long t_a = clock64();\n        long long c_w1 = 0, c_w2 = 0, c_e1 = 0;\n"
             "        int acc[2][kC / 2];\n")
    timed("        mbar_wait(halo_full, n & 1);\n", "c_w1")
    waits = ("#pragma unroll\n        for (int s = 0; s < kSteps1; ++s) mbar_wait(full0 + 8 * ((k + s) "
             "% kStages), ((k + s) / kStages) & 1);\n")
    edit_src(waits, "        { const long long t_w = clock64();\n" + waits
             + "        c_w1 += clock64() - t_w; }\n")
    timed("          store_y1<kFast>(a, 64 * blk, y1s0, b1_s, m1_s, r0, c0, H, W, circular);\n", "c_e1")
    first = "        consumers_sync();  // both warpgroups have done reading the previous tile's y1\n"
    edit_src(first, "        const long long t_f = clock64();\n" + first)
    edit_src("        // Stage 2: tile rows 8 wg .. 8 wg + 7, 8 x 8 block mb at column 8 mb.\n",
             "        const long long t_s2 = clock64();\n")
    timed("          mbar_wait(full0 + 8 * st, (k / kStages) & 1);\n", "c_w2")
    last = "        if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % kStages));  // the tile's last step\n"
    edit_src(last, last + "        const long long t_e2 = clock64();\n")
    i = src.index("        // Epilogue: the warp's pooled row")
    end = src.index("      }\n    };\n", i)
    src = (src[:end] + "        if (tid == 0) {\n"
           "          atomicAdd(&g_prof[0], static_cast<unsigned long long>(t_f - t_a));\n"
           "          atomicAdd(&g_prof[1], static_cast<unsigned long long>(c_w1));\n"
           "          atomicAdd(&g_prof[2], static_cast<unsigned long long>(c_e1));\n"
           "          atomicAdd(&g_prof[3], static_cast<unsigned long long>(t_s2 - t_a));\n"
           "          atomicAdd(&g_prof[4], static_cast<unsigned long long>(t_e2 - t_s2));\n"
           "          atomicAdd(&g_prof[5], static_cast<unsigned long long>(c_w2));\n"
           "          atomicAdd(&g_prof[6], static_cast<unsigned long long>(clock64() - t_e2));\n"
           "          atomicAdd(&g_prof[7], 1ull);\n"
           "        }\n" + src[end:])
    edit_src("          if (k >= kStages) mbar_wait(empty0 + 8 * st, (k / kStages - 1) & 1);\n",
             "          if (k >= kStages) {\n"
             "            const long long t_w = clock64();\n"
             "            mbar_wait(empty0 + 8 * st, (k / kStages - 1) & 1);\n"
             "            atomicAdd(&g_prof[8], static_cast<unsigned long long>(clock64() - t_w));\n"
             "          }\n")
    edit_src("        if (n > 0) mbar_wait(halo_empty, (n - 1) & 1);\n",
             "        if (n > 0) {\n"
             "          const long long t_w = clock64();\n"
             "          mbar_wait(halo_empty, (n - 1) & 1);\n"
             "          if (p == 32) atomicAdd(&g_prof[9], static_cast<unsigned long long>(clock64() - t_w));\n"
             "        }\n")
    return src


def block2_cycles(device, card, h, w):
    """Phase 4: kernel C and its three copies at block 2 of the surface
    tower, batch 128; the clock copy's means per tile."""
    src = (CSRC_DIR / "fused_block2.cu").read_text()
    libs = build({"c_kernel": src, "c_clock": c_clocked(src), "c_noload": c_stripped(src, "noload"),
                  "c_nomma": c_stripped(src, "nomma")}, COPIES_DIR)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.witw_fused_block2.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    gen = torch.Generator(device=device).manual_seed(9)
    (x, _, b1, m1, _, b2, m2), tables = block2_args(gen, device, 128, h, w)
    out = torch.empty(128, h // 2, w // 2, 128, dtype=torch.int8, device=device)

    def launch(lib):
        err = lib.witw_fused_block2(x.data_ptr(), tables["w1_wgmma"].data_ptr(), b1.data_ptr(),
                                    m1.data_ptr(), tables["w2_wgmma"].data_ptr(), b2.data_ptr(),
                                    m2.data_ptr(), out.data_ptr(), 128, h, w, 0,
                                    torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"kernel C launch failed ({err})")

    clock = libs["c_clock"]
    clock.witw_prof_reset()
    launch(clock)
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * len(C_COUNTERS))()
    clock.witw_prof_read(counts)
    tiles = counts[C_COUNTERS.index("tiles")]
    per_tile = {k: counts[i] / max(tiles, 1) for i, k in enumerate(C_COUNTERS) if k != "tiles"}
    ms = {name[2:]: cuda_ms(lambda lib=lib: launch(lib), 3, 5) for name, lib in libs.items()}
    print(f"[4] kernel C, block 2 [128, {h}, {w}, 64]: kernel {ms['kernel']:.4f} ms, noload "
          f"{ms['noload']:.4f}, nomma {ms['nomma']:.4f}, clock copy {ms['clock']:.4f}; per tile "
          f"({tiles} tiles, SM cycles of consumer thread 0): stage 1 {per_tile['s1_total']:.0f} (to its "
          f"first block's wgmma {per_tile['s1_first']:.0f}, of it waits for data "
          f"{per_tile['s1_wait']:.0f}; y1 epilogues {per_tile['s1_epilogue']:.0f}), stage 2 main loop "
          f"{per_tile['s2_main']:.0f} (waits for "
          f"data {per_tile['s2_wait']:.0f}), stage 2 epilogue {per_tile['s2_epilogue']:.0f}; "
          f"producers wait for a free weight stage {per_tile['weights_wait_empty']:.0f}, for a "
          f"free halo {per_tile['halo_wait_empty']:.0f} ({card})", flush=True)
    return {"shape": [128, h, w, 64], "tiles": tiles, "ms": ms, "cycles_per_tile": per_tile}


def cycles_per_layer(device, card, convs, names):
    """Phase 3: kernel A and its three copies at each conv; the clock copy's
    means per tile."""
    src = (CSRC_DIR / "int8_conv.cu").read_text()
    libs = build({"kernel": src, "clock": clocked(src), "noload": stripped(src, "noload"),
                  "nomma": stripped(src, "nomma")}, COPIES_DIR)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.witw_conv3x3_int8.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
        lib.witw_conv3x3_int8_dequant.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
    print(f"[3] kernel A per layer: ms of the kernel and of its copies without copies (noload) "
          f"or without wgmma (nomma); cycles per 256-pixel tile ({card})")
    gen = torch.Generator(device=device).manual_seed(7)
    rows, total = [], defaultdict(float)
    for name, (_, (h, w, cin), co, sh, pad, ep) in zip(names, convs):
        t = conv_case(gen, device, 128, (h, w, cin), co)
        ho, wo = int8_conv.output_hw(h, w, sh, pad)
        out = torch.empty(128, ho, wo, co, device=device,
                          dtype=torch.float32 if ep == "f32" else torch.int8)
        cols = int8_conv.tile_shape(ho, wo, sh)[1]
        shape = (128, h, w, cin, int8_conv.wgmma_channels(cin), co, sh, pad,
                 int8_conv.tile_n(co), cols.bit_length() - 1)

        def launch(lib):
            stream = torch.cuda.current_stream(device).cuda_stream
            if ep == "f32":
                err = lib.witw_conv3x3_int8_dequant(
                    t["x"].data_ptr(), t["w_wgmma"].data_ptr(), t["dequant"].data_ptr(),
                    t["bias_f"].data_ptr(), out.data_ptr(), *shape, stream)
            else:
                err = lib.witw_conv3x3_int8(
                    t["x"].data_ptr(), t["w_wgmma"].data_ptr(), t["bias_q"].data_ptr(),
                    t["m"].data_ptr(), out.data_ptr(), *shape, 1, stream)
            if err:
                raise RuntimeError(f"launch failed ({err}) at {name}")

        clock = libs["clock"]
        clock.witw_prof_reset()
        launch(clock)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * len(COUNTERS))()
        clock.witw_prof_read(counts)
        per_tile = {k: counts[i] / max(counts[2], 1) for i, k in enumerate(COUNTERS) if k != "tiles"}
        ms = {lib_name: cuda_ms(lambda lib=lib: launch(lib), 3, 5) for lib_name, lib in libs.items()}
        for lib_name, v in ms.items():
            total[lib_name] += v
        rows.append({"layer": name, "shape": [128, h, w, cin, co], "tiles": counts[2], "ms": ms,
                     "cycles_per_tile": per_tile})
        print(f"    {name} [{h}, {w}, {cin}] -> Co {co}, stride_h {sh}: kernel {ms['kernel']:.4f} ms, "
              f"noload {ms['noload']:.4f}, nomma {ms['nomma']:.4f}, clock copy {ms['clock']:.4f}; "
              f"per tile ({counts[2]} tiles): main loop {per_tile['main']:.0f} cycles (waits for "
              f"data {per_tile['wait_full']:.0f}), epilogue {per_tile['epilogue']:.0f}, producer "
              f"waits for a free stage {per_tile['wait_empty']:.0f}", flush=True)
        del t, out
    print("    summed: " + ", ".join(f"{k} {v:.4f} ms" for k, v in total.items()) + f" ({card})")
    return rows, dict(total)


def merged_us(intervals):
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/profile_int8.json")
    args = ap.parse_args()

    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    build_libraries(["int8_conv", "maxpool", "fused_block2", "fused_match"])

    cfg = fov_experiment("cvusa", 360)
    d = cfg.data
    pipeline = FovPipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(0))
    calib = {k: v[:8] for k, v in raw_batch(np.random.default_rng(4), cfg, 128).items()}
    sq_s, sq_o = quantize.quantize_pipeline_static(params, [pipeline.preprocess(calib)])
    gen = torch.Generator(device=device).manual_seed(11)
    staged = [
        {"surface": torch.rand(128, d.surface_height, d.surface_width_max, 3,
                               generator=gen, device=device) * 255.0,
         "overhead": torch.rand(128, d.overhead_size, d.overhead_size, 3,
                                generator=gen, device=device) * 255.0}
        for _ in range(4)
    ]
    for b in staged[:2]:  # warm
        int8_distance(d, sq_s, sq_o, b)
    torch.cuda.synchronize()

    # 1. device time by kernel group
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            int8_distance(d, sq_s, sq_o, staged[i % len(staged)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    span_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy_us = merged_us(spans)
    groups = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        g = groups[group_of(e.name)]
        g[0] += 1
        g[1] += e.time_range.elapsed_us()
    device_us = sum(us for _, us in groups.values())
    print(f"[1] static-int8 embed+match, batch 128, fov 360: {args.steps} profiled steps, "
          f"{wall_ms:.3f} ms/step host wall time under the profiler; device busy "
          f"{100 * busy_us / span_us:.1f}% of {span_us / 1e3 / args.steps:.3f} ms/step ({card})")
    report = {"card": card, "steps": args.steps, "wall_ms_per_step": wall_ms,
              "device_span_ms_per_step": span_us / 1e3 / args.steps,
              "device_busy": busy_us / span_us, "groups": {}, "layers": []}
    for name, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        ms = us / 1e3 / args.steps
        print(f"    {name}: {n / args.steps:g} launches/step, {ms:.3f} ms/step, "
              f"{100 * us / device_us:.1f}%")
        report["groups"][name] = {"launches_per_step": n / args.steps, "ms_per_step": ms,
                                  "share": us / device_us}

    # 2. useful int8 TOP/s by layer, surface tower, batch 128
    print(f"[2] useful int8 TOP/s by layer, surface tower, batch 128 ({card})")
    block2 = {f"conv_{i}" for i, _ in VGG16_BLOCKS[1]}
    names = [n for n in quantize.CONV_ORDER if n not in block2]
    convs = [c for c in tower_calls(d.surface_height, d.surface_width_max, 3, False)
             if c[0] == "conv"]
    gen = torch.Generator(device=device).manual_seed(7)
    for name, (_, (h, w, cin), co, sh, pad, ep) in zip(names, convs):
        t = conv_case(gen, device, 128, (h, w, cin), co)
        ms = cuda_ms(lambda: run_conv(t, sh, pad, ep), 3, 5)
        ho, wo = int8_conv.output_hw(h, w, sh, pad)
        tops = 2 * 128 * ho * wo * co * 9 * cin / (ms * 1e-3) / 1e12
        print(f"    kernel A {name} [{h}, {w}, {cin}] -> Co {co}, stride_h {sh}, {ep}: "
              f"{ms:.4f} ms, {tops:.1f} TOP/s")
        report["layers"].append({"kernel": "conv3x3_int8", "layer": name, "ms": ms, "tops": tops})
    h, w = d.surface_height // 2, d.surface_width_max // 2
    b2, tables = block2_args(gen, device, 128, h, w)
    ms = cuda_ms(lambda: fused_block2.fused_block2(*b2, **tables), 2, 5)
    tops = 2 * 128 * h * w * 128 * 9 * (64 + 128) / (ms * 1e-3) / 1e12
    print(f"    kernel C block 2 [{h}, {w}, 64] -> [{h // 2}, {w // 2}, 128]: "
          f"{ms:.4f} ms, {tops:.1f} TOP/s")
    report["layers"].append({"kernel": "fused_block2", "layer": "block 2", "ms": ms, "tops": tops})

    report["cycles"], report["cycles_summed_ms"] = cycles_per_layer(device, card, convs, names)
    report["block2_cycles"] = block2_cycles(device, card, h, w)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
