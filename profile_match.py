#!/usr/bin/env python3
"""Where the fused match kernel's time goes, on one NVIDIA GPU.

    python3 profile_match.py [--out profile_match.json] [--against DIR]

Builds the kernel (witw_tpu_torch/csrc/fused_match.cu) and copies of its
source edited at fixed places (the script fails if a place it edits is
gone), into witw_tpu_torch/_build/profile_match/:
- nomma: the consumers issue no wgmma, so the time is everything else: the
  maps' split into shared memory, the copies, the fragment loads and split,
  the barriers and the epilogue;
- nosplit: the fragments are not split (big is the raw f32, small zero), so
  the products are wrong and the time has no split;
- nocopy: the producer copies no query column (the ring's barriers still
  turn), so the time has no copies;
- onefold: each pass sums all its columns in the tensor cores' f32
  accumulator and rounds into the total once, not once a column;
- rsloop: the wgmma loop alone: the producer copies nothing and the
  consumers neither wait for nor read a column (their fragments are split
  from constants), so the time is the maps' split and the products;
- ssloop: rsloop with A read from shared memory through a descriptor (the
  map's other copy) instead of registers: the same products on the other
  operand route.
At the main path's shape (G = Q = 128) and the gallery block's (G = 8832,
Q = 128), both at W = sw = 64, hc = 64, random inputs from a seed, it
times each with CUDA events (direct launches with the wrapper's arguments,
median of 5) and prints ms, TF32 TFLOP/s (3 products a multiply-add), the
share of the 3xTF32 bound and max |d - plain| (f32, TF32 off). It also reads
the SM clock and the power draw with nvidia-smi while the kernel runs.

With --against DIR (another checkout of the repo, such as a `git archive` of
an earlier commit), phase [2] imports that checkout's
witw_tpu_torch.ops.fused_match beside this one's (it builds its own library)
and times both wrappers on the same inputs, in turns (this, DIR, DIR, this,
...): host-launched (CUDA events around back-to-back calls, median of 7) and
as device time from CUDA graphs (utils/profiling.graph_ms, median of two
graphs each). Both must agree with the plain version. Its shapes are the two
above and three at W = 256 (4 passes of 64 shifts): sw = W at hc 64 (2
channel chunks), and sw = 64 at hc 64 and at hc 16, where the kernel holds
windows of 127 rows, refilled per pass, in place of a whole map.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from chip_smoke import PEAK_TF32_PER_MS, card_line
from profile_conv import build, edit
from witw_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR
from witw_tpu_torch.match.distance import window_sq_norms
from witw_tpu_torch.ops import fused_match
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.profiling import cuda_ms, graph_ms

OUT_DIR = BUILD_DIR / "profile_match"
SHAPES = {"main path": (128, 128), "gallery block": (8832, 128)}  # (G, Q); W = sw = hc = 64
# Phase [2]'s shapes: (G, Q, h, W, c, sw).
COMPARED = {**{name: (g, q, 4, 64, 16, 64) for name, (g, q) in SHAPES.items()},
            "W 256, hc 64": (128, 128, 4, 256, 16, 256),
            "W 256, sw 64, hc 64": (128, 128, 4, 256, 16, 64),
            "W 256, sw 64, hc 16": (128, 128, 4, 256, 4, 64)}
PRODUCTS = """#pragma unroll
        for (int c = 0; c < kSteps; ++c) wgmma_tf32(acc, as[c], b_big + c * step_desc, c > 0);
#pragma unroll
        for (int c = 0; c < kSteps; ++c) wgmma_tf32(acc, ab[c], b_big + small_desc + c * step_desc, 1);
#pragma unroll
        for (int c = 0; c < kSteps; ++c) wgmma_tf32(acc, ab[c], b_big + c * step_desc, 1);
"""
SPLIT = "          for (int e = 0; e < 4; ++e) split_tf32(raw[e], ab[c][e], as[c][e]);\n"
COPY = """        mbar_arrive_expect_tx(full0 + 8 * st, bytes);
        const int col = m.k * chunks + m.ch;  // (k, ch) in s
        bulk_copy(ring0 + st * stage_bytes, s + (static_cast<size_t>(col) * Q + q0) * pitch, bytes,
                  full0 + 8 * st);
"""
PRODUCER = "      for (int it = 0; it < items; ++it, advance(m, sw, chunks, kcols)) {\n"
LOAD = ("      const auto load = [&](int it, Frags& ab, Frags& as) {\n",
        "        if (lane == 0) mbar_arrive(empty0 + 8 * st);\n      };\n")
SS = """__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

"""
FOLD = """        wgmma_wait<0>();
        fence_frags(ab, as);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(acc[i]);
          tot[i] = __fadd_rn(tot[i], acc[i]);
        }
        if (!fill_ends(m)) return;
"""


def variant(src: str, mode: str) -> str:
    if mode == "nomma":
        return edit(src, PRODUCTS, "")
    if mode == "nosplit":
        return edit(src, SPLIT, "          for (int e = 0; e < 4; ++e) ab[c][e] = __float_as_uint(raw[e]), "
                                "as[c][e] = 0u;\n")
    if mode == "nocopy":
        return edit(src, COPY, "        mbar_arrive(full0 + 8 * st);\n")
    if mode in ("rsloop", "ssloop"):
        src = edit(src, PRODUCER, PRODUCER.replace("it < items", "it < 0"))
        a, b = src.index(LOAD[0]), src.index(LOAD[1]) + len(LOAD[1])
        src = src[:a] + LOAD[0] + """#pragma unroll
        for (int c = 0; c < kSteps; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(1.0f + 0.001f * (c + e + it % 3), ab[c][e], as[c][e]);
        }
      };
""" + src[b:]
        if mode == "rsloop":
            return src
        src = edit(src, "// Does (v, i) beat the running best", SS + "// Does (v, i) beat the running best")
        for a, b, scale in (("as[c]", "b_big + c * step_desc", "c > 0"),
                            ("ab[c]", "b_big + small_desc + c * step_desc", "1"),
                            ("ab[c]", "b_big + c * step_desc", "1")):
            other = "b_big + small_desc + c * step_desc" if b == "b_big + c * step_desc" else "b_big + c * step_desc"
            src = edit(src, f"wgmma_tf32(acc, {a}, {b}, {scale});", f"wgmma_ss(acc, {other}, {b}, {scale});")
        return src
    src = edit(src, "wgmma_tf32(acc, as[c], b_big + c * step_desc, c > 0);",
               "wgmma_tf32(acc, as[c], b_big + c * step_desc, c > 0 || cur.k != 0);")
    return edit(src, FOLD, """        if (!fill_ends(m)) return;
        wgmma_wait<0>();
        fence_frags(ab, as);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(acc[i]);
          tot[i] = acc[i];
        }
""")


def other_fused_match(tree: Path):
    """The witw_tpu_torch.ops.fused_match module of another checkout,
    imported beside this one's: this checkout's modules are set aside while
    it imports and put back after, so that each wrapper keeps its own
    package (and library)."""
    def ours():
        return {k: m for k, m in sys.modules.items() if k.split(".")[0] == "witw_tpu_torch"}

    saved = ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(tree))
    try:
        module = importlib.import_module("witw_tpu_torch.ops.fused_match")
    finally:
        sys.path.remove(str(tree))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    if not Path(module.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"{tree} has no witw_tpu_torch/ops/fused_match.py")
    return module


def compare_wrappers(other, tree: Path, card: str, device) -> dict:
    """Phase [2]: this checkout's wrapper and ``other``'s in turns."""
    print(f"[2] fused_chord_distance_nhwc: this checkout against {tree}, in turns, on {card}", flush=True)
    gen = torch.Generator(device=device).manual_seed(1)
    report = {}
    for name, (g, q, h, w, c, sw) in COMPARED.items():
        o = torch.randn(g, h, w, c, generator=gen, device=device)
        s = torch.randn(q, h, sw, c, generator=gen, device=device)
        want = fused_match.fused_chord_distance_plain(o, s)[0]
        fns = {"this": lambda: fused_match.fused_chord_distance_nhwc(o, s),
               "against": lambda: other.fused_chord_distance_nhwc(o, s)}
        errs = {k: float((fn()[0] - want).abs().max()) for k, fn in fns.items()}
        if not max(errs.values()) < 1e-4:
            raise AssertionError(f"{name}: a wrapper disagrees with the plain version: {errs}")
        calls = 20 if g <= 1024 else 3
        host = {"this": [], "against": []}
        for rep in range(7):
            for k in (("this", "against") if rep % 2 == 0 else ("against", "this")):
                host[k].append(cuda_ms(fns[k], calls, 1))
        graphs = {"this": [], "against": []}
        for k in ("this", "against", "against", "this"):
            graphs[k].append(graph_ms(fns[k], calls=64 if g <= 1024 else 4, reps=3))
        row = {k: {"host_ms": statistics.median(host[k]), "device_ms": statistics.median(graphs[k]),
                   "max_abs_err": errs[k]} for k in fns}
        report[name] = row
        print(f"    {name} G={g} Q={q}: this {row['this']['host_ms']:.4f} ms host-launched, "
              f"{row['this']['device_ms']:.4f} ms device time (graphs); against "
              f"{row['against']['host_ms']:.4f}, {row['against']['device_ms']:.4f}; "
              f"max |d - plain| {errs['this']:.3e}, {errs['against']:.3e} ({card})", flush=True)
        del o, s, want
    return report


def sample_clock(run, seconds: float) -> str:
    """nvidia-smi's SM clock and power draw, read while ``run`` loops."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            run()
        torch.cuda.synchronize()

    worker = threading.Thread(target=loop)
    worker.start()
    time.sleep(seconds)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    stop.set()
    worker.join()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    parser.add_argument("--against", default=None, type=Path,
                        help="another checkout of the repo whose wrapper [2] times beside this one's")
    args = parser.parse_args()
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    modes = ("kernel", "nomma", "nosplit", "nocopy", "onefold", "rsloop", "ssloop")
    src = (CSRC_DIR / "fused_match.cu").read_text()
    libs = build({mode: src if mode == "kernel" else variant(src, mode) for mode in modes}, OUT_DIR)
    for lib in libs.values():
        lib.witw_fused_corr_distance.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
            ctypes.c_size_t, ctypes.c_void_p]
    print(f"[1] fused_corr_distance and its copies ({', '.join(modes[1:])}) on {card}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    report = {"card": card, "shapes": {}}
    for name, (g, q) in SHAPES.items():
        o = torch.randn(g, 4, 64, 16, generator=gen, device=device)
        s = torch.randn(q, 4, 64, 16, generator=gen, device=device)
        geo = fused_match.geometry(g, q, 64, 64)
        o_flat = o.permute(0, 2, 1, 3).reshape(g, 64, 64).contiguous()
        s_pad = fused_match.query_columns(s.permute(2, 0, 1, 3).reshape(64, q, 64).contiguous(), geo)
        wsq = window_sq_norms(o, 64).contiguous()
        d = torch.empty(g, q, device=device)
        orient = torch.empty(g, q, dtype=torch.int32, device=device)
        want = fused_match.fused_chord_distance_plain(o, s)[0]
        flop = 3 * 2.0 * g * q * 64 * 64 * 64
        rows = {}
        for mode, lib in libs.items():
            def call(lib=lib):
                err = lib.witw_fused_corr_distance(
                    o_flat.data_ptr(), s_pad.data_ptr(), wsq.data_ptr(), d.data_ptr(), orient.data_ptr(),
                    g, 64, 64, 64, 1, geo["pitch"], q, 64, geo["stages"], geo["kcols"], geo["smem_bytes"],
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{mode} launch failed: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = float((d - want).abs().max())
            ms = cuda_ms(call, 10 if g <= 1024 else 3, 5)
            rows[mode] = {"ms": ms, "tflops": flop / ms / 1e9, "of_bound": flop / PEAK_TF32_PER_MS / ms,
                          "max_abs_err": err}
            print(f"    {name} G={g} Q={q}: {mode:8s} {ms:.4f} ms  {flop / ms / 1e9:.1f} TFLOP/s  "
                  f"{100 * flop / PEAK_TF32_PER_MS / ms:.1f}% of the 3xTF32 bound  "
                  f"max |d - plain| {err:.3e}", flush=True)
            if mode == "kernel" and g > 1024:
                clock = sample_clock(call, 1.0)
                rows[mode]["clock_power"] = clock
                print(f"    {name}: SM clock, power while it runs: {clock}", flush=True)
        report["shapes"][name] = rows
    if args.against:
        report["against"] = {"tree": str(args.against),
                             "shapes": compare_wrappers(other_fused_match(args.against), args.against,
                                                        card, device)}
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
