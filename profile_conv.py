#!/usr/bin/env python3
"""Where conv3x3_bf16's time goes at each conv of the bf16 surface tower, on one NVIDIA GPU.

    python3 profile_conv.py [--out chiprun_out/profile_conv.json]

Builds the kernel (witw_tpu_torch/csrc/conv3x3_bf16.cu) and three copies of
its source edited at fixed lines (the script fails if a line it edits is
gone), into witw_tpu_torch/_build/profile_conv/:
- clock: consumer thread 0 of each block reads clock64 around each tile's
  main loop (and, inside it, around its waits for a full stage) and around
  its epilogue, and producer thread 0 around its waits for a free stage;
- noload: the producers copy nothing (the ring's barriers still turn), so
  the time is the consumers' alone: wgmma, the barriers, the epilogue;
- nomma: the consumers issue no wgmma, so the time is the copies' and the
  epilogue's.
At each conv of the surface tower at batch 128 (random inputs, as
chip_smoke.py [14]) it times the kernel and each copy with CUDA events
(median of 5), and prints the clock copy's means per tile in SM cycles: main
loop, of which waits for data; epilogue; the producer's waits for a free
stage. The same numbers go to --out as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import torch

from chip_smoke import PEAK_BF16_PER_MS, bf16_conv_shapes, bound, card_line, conv_inputs, conv_work
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, nvcc_path
from witw_tpu_torch.ops import conv3x3
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.profiling import cuda_ms

OUT_DIR = BUILD_DIR / "profile_conv"
# clock copy's counters: main-loop cycles, epilogue cycles, tiles, full-stage
# waits (consumer), free-stage waits (producer)
COUNTERS = ("main", "epilogue", "tiles", "wait_full", "wait_empty")


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the kernel source no longer has one {old.strip()[:60]!r}")
    return src.replace(old, new)


def stripped(src: str, mode: str) -> str:
    """noload: no copies, the barriers still arrive; nomma: no wgmma."""
    if mode == "noload":
        src, n = re.subn(r"\n(\s*)mbar_arrive_expect_tx\(full, R::kWBytes\);\n\s*bulk_copy\([^;]*\);",
                         r"\n\1mbar_arrive(full);", src)
        src, m = re.subn(r"\n(\s*)cp_async16\([^;]*\);", "", src)
        if n != 1 or m != 1:
            raise RuntimeError("profile_conv: the kernel's copies are not where expected")
        return src
    start = "        wgmma_fence();\n#pragma unroll\n        for (int tap"
    end = "        wgmma_wait<1>();  // the previous step is done: release its stage\n"
    a, b = src.index(start), src.index(end) + len(end)
    return src[:a] + src[b:]


def clocked(src: str) -> str:
    src = edit(src, "namespace {\n", "__device__ unsigned long long g_prof[5];\nnamespace {\n")
    src = edit(src, 'extern "C" {\n',
               'extern "C" {\n'
               "void witw_prof_read(unsigned long long* h) { cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
               "void witw_prof_reset() {\n"
               "  const unsigned long long z[5] = {};\n"
               "  cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
               "}\n")
    src = edit(src, "      float acc[2][N / 2];\n",
               "      const long long t_tile = clock64();\n      long long t_full = 0;\n"
               "      float acc[2][N / 2];\n")
    src = edit(src, "        mbar_wait(full0 + 8 * st, (k / R::kStages) & 1);\n",
               "        const long long t_w = clock64();\n"
               "        mbar_wait(full0 + 8 * st, (k / R::kStages) & 1);\n"
               "        t_full += clock64() - t_w;\n")
    src = edit(src, "      if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % R::kStages));  // the tile's last step\n",
               "      if (lane == 0) mbar_arrive(empty0 + 8 * ((k - 1) % R::kStages));  // the tile's last step\n"
               "      const long long t_main = clock64();\n")
    i = src.index("      // Epilogue: bias in f32")
    j = src.index("\ntemplate <int N>\nint launch(")
    end = src.rindex("    }\n  }\n}", i, j)
    src = (src[:end] + "      if (tid == 0) {\n"
           "        atomicAdd(&g_prof[0], static_cast<unsigned long long>(t_main - t_tile));\n"
           "        atomicAdd(&g_prof[1], static_cast<unsigned long long>(clock64() - t_main));\n"
           "        atomicAdd(&g_prof[2], 1ull);\n"
           "        atomicAdd(&g_prof[3], static_cast<unsigned long long>(t_full));\n"
           "      }\n" + src[end:])
    return edit(src, "        if (k >= R::kStages) mbar_wait(empty0 + 8 * st, (k / R::kStages - 1) & 1);\n",
                "        if (k >= R::kStages) {\n"
                "          const long long t_w = clock64();\n"
                "          mbar_wait(empty0 + 8 * st, (k / R::kStages - 1) & 1);\n"
                "          if (p == 0) atomicAdd(&g_prof[4], static_cast<unsigned long long>(clock64() - t_w));\n"
                "        }\n")


def build(sources, out_dir=OUT_DIR):
    """{name: source} -> {name: ctypes library}, one nvcc per source, in parallel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_conv.json")
    args = ap.parse_args()

    device = require_cuda()
    card = card_line()
    print(card, flush=True)
    kernel_src = (CSRC_DIR / "conv3x3_bf16.cu").read_text()
    libs = build({"kernel": kernel_src, "clock": clocked(kernel_src),
                  "noload": stripped(kernel_src, "noload"), "nomma": stripped(kernel_src, "nomma")})
    for lib in libs.values():
        lib.witw_conv3x3_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

    d = fov_experiment("cvusa", 360).data
    gen = torch.Generator(device=device).manual_seed(15)
    rows = []
    for h, w, cin, co, circ, relu in bf16_conv_shapes(d.surface_height, d.surface_width_max, 3, False):
        x, wt, bias = conv_inputs(gen, device, 128, h, w, cin, co)
        packed = conv3x3.pack_weights(wt)
        out = torch.empty(128, h, w, co, dtype=torch.bfloat16, device=device)
        cols = conv3x3.tile_shape(h, w)[1]

        def launch(lib):
            err = lib.witw_conv3x3_bf16(
                x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(), 128, h, w, cin,
                conv3x3.padded_channels(cin), co, conv3x3.tile_n(co), cols.bit_length() - 1,
                int(circ), int(relu), torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed ({err}) at {(h, w, cin, co)}")

        clock = libs["clock"]
        clock.witw_prof_reset()
        launch(clock)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * len(COUNTERS))()
        clock.witw_prof_read(counts)
        per_tile = {k: counts[i] / max(counts[2], 1) for i, k in enumerate(COUNTERS) if k != "tiles"}
        ms = {name: cuda_ms(lambda lib=lib: launch(lib), 3, 5) for name, lib in libs.items()}
        flop, nbytes = conv_work(128, h, w, cin, co)
        row = {"shape": [128, h, w, cin, co], "tiles": counts[2], "ms": ms,
               "tflops": flop / ms["kernel"] / 1e9, "bound_ms": bound(flop, nbytes, PEAK_BF16_PER_MS)[0],
               "cycles_per_tile": per_tile}
        rows.append(row)
        print(f"B=128 HWC=({h}, {w}, {cin}) Co={co}: kernel {ms['kernel']:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s), noload {ms['noload']:.4f}, nomma {ms['nomma']:.4f}, "
              f"clock copy {ms['clock']:.4f}, bound {row['bound_ms']:.4f} ms; per tile ({counts[2]} "
              f"tiles): main loop {per_tile['main']:.0f} cycles (waits for data "
              f"{per_tile['wait_full']:.0f}), epilogue {per_tile['epilogue']:.0f}, producer waits "
              f"for a free stage {per_tile['wait_empty']:.0f} ({card})", flush=True)
        del x, packed, out
    total = {name: sum(r["ms"][name] for r in rows) for name in libs}
    print(f"surface tower's {len(rows)} convs summed: "
          + ", ".join(f"{name} {t:.4f} ms" for name, t in total.items()) + f" ({card})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "layers": rows, "summed_ms": total}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
