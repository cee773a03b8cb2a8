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
   multiply-adds of the real (unpadded) input channels over kernel time.
The same numbers go to --out as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (block2_args, card_line, conv_case, int8_distance, raw_batch, run_conv,
                        tower_calls)
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.kernels.build import build_libraries
from witw_tpu_torch.models import quantize
from witw_tpu_torch.models.backbones.vgg16 import VGG16_BLOCKS
from witw_tpu_torch.ops import fused_block2, int8_conv
from witw_tpu_torch.train.pipeline import FovPipeline
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.profiling import cuda_ms

GROUPS = (  # (kernel-name substring, group), first match wins
    ("conv3x3_int8_kernel<true>", "kernel A, dequant epilogue"),
    ("conv3x3_int8_kernel", "kernel A, int8 conv + requant"),
    ("fused_block2_kernel", "kernel C, fused block 2"),
    ("maxpool2x2_kernel", "kernel B, max pool"),
    ("fused_corr_distance_kernel", "fused match"),
)
OTHER = "other: int8 preprocess (gather, index, normalize, quantize) and copies"


def group_of(name: str) -> str:
    return next((g for key, g in GROUPS if key in name), OTHER)


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
    b2 = block2_args(gen, device, 128, h, w)
    ms = cuda_ms(lambda: fused_block2.fused_block2(*b2), 2, 5)
    tops = 2 * 128 * h * w * 128 * 9 * (64 + 128) / (ms * 1e-3) / 1e12
    print(f"    kernel C block 2 [{h}, {w}, 64] -> [{h // 2}, {w // 2}, 128]: "
          f"{ms:.4f} ms, {tops:.1f} TOP/s")
    report["layers"].append({"kernel": "fused_block2", "layer": "block 2", "ms": ms, "tops": tops})

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
