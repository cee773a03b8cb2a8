#!/usr/bin/env python3
"""Device-time breakdown of the port's bf16 paths on one NVIDIA GPU.

    python3 profile_bf16.py [--steps 4] [--out profile_bf16.json]

Random-weight towers (seed 0), fov 360, CVUSA geometry, inputs varied every
step. torch.profiler over --steps steps of each path:
1. bf16 embed+match at batch 128 (FovPipeline.forward_distance);
2. the train step at batch 64 (FovPipeline.train_step: forward, backward of
   block 4 and the head, Adam).
For each it prints every kernel group's launches and device time per step,
its share of device time, and the device-busy share of the profiled span
(merged kernel intervals over the time from the first kernel's start to the
last one's end), then the 12 kernels with the most device time by name. With
--out the same numbers go to that file as JSON.
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

from chip_smoke import card_line
from profile_int8 import merged_us
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.kernels.build import build_libraries
from witw_tpu_torch.train.pipeline import FovPipeline
from witw_tpu_torch.utils.device import require_cuda

GROUPS = (  # (kernel-name substrings, group), first match wins
    (("conv3x3_bf16_kernel",), "conv3x3_bf16 kernel (fused conv + bias + ReLU)"),
    (("dgrad", "wgrad", "bprop", "convolution_backward"), "cuDNN conv backward"),
    (("fprop", "implicit_gemm", "xmma_fprop", "conv2d"), "cuDNN conv forward (stride-2 head)"),
    (("fused_corr_distance",), "fused match"),
    (("max_pool",), "2x2 max pool (forward / backward)"),
    (("multi_tensor_apply",), "Adam"),
    (("gemm", "gemv", "sm90_xmma"), "GEMMs (correlation, other)"),
)
OTHER = "other: elementwise, casts, copies, reductions, gathers"


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for keys, g in GROUPS if any(k.lower() in low for k in keys)), OTHER)


def profiled(run, steps: int, label: str, card: str) -> dict:
    """Profile ``steps`` calls of run(i); print and return the breakdown."""
    run(0)
    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side kernels only: the optimizer's step annotation is recorded
    # on the device timeline too and would count Adam twice
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    span_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy_us = merged_us(spans)
    groups = defaultdict(lambda: [0, 0.0])
    names = defaultdict(float)
    for e in kernels:
        g = groups[group_of(e.name)]
        g[0] += 1
        g[1] += e.time_range.elapsed_us()
        names[e.name] += e.time_range.elapsed_us()
    device_us = sum(us for _, us in groups.values())
    print(f"{label}: {steps} profiled steps, {wall_ms:.3f} ms/step host wall time under the "
          f"profiler; device time {device_us / 1e3 / steps:.3f} ms/step; device busy "
          f"{100 * busy_us / span_us:.1f}% of {span_us / 1e3 / steps:.3f} ms/step ({card})",
          flush=True)
    report = {"steps": steps, "wall_ms_per_step": wall_ms,
              "device_ms_per_step": device_us / 1e3 / steps,
              "device_span_ms_per_step": span_us / 1e3 / steps,
              "device_busy": busy_us / span_us, "groups": {}, "top_kernels": {}}
    for name, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        ms = us / 1e3 / steps
        print(f"    {name}: {n / steps:g} launches/step, {ms:.3f} ms/step, "
              f"{100 * us / device_us:.1f}%")
        report["groups"][name] = {"launches_per_step": n / steps, "ms_per_step": ms,
                                  "share": us / device_us}
    print("    top kernels by device time:")
    for name, us in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"      {us / 1e3 / steps:9.3f} ms/step  {name[:150]}")
        report["top_kernels"][name] = us / 1e3 / steps
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    build_libraries(["conv3x3_bf16", "fused_match"])

    cfg = fov_experiment("cvusa", 360)
    d = cfg.data
    pipeline = FovPipeline(cfg, device)
    gen = torch.Generator(device=device).manual_seed(11)

    def batches(b):
        return [{"surface": torch.rand(b, d.surface_height, d.surface_width_max, 3,
                                       generator=gen, device=device) * 255.0,
                 "overhead": torch.rand(b, d.overhead_size, d.overhead_size, 3,
                                        generator=gen, device=device) * 255.0}
                for _ in range(4)]

    params = pipeline.init(torch.Generator().manual_seed(0))
    staged = batches(128)
    report = {"card": card}
    report["embed_match_b128"] = profiled(
        lambda i: pipeline.forward_distance(params, staged[i % 4]), args.steps,
        "[1] bf16 embed+match, batch 128, fov 360", card)
    del staged, params

    state = pipeline.init_state(torch.Generator().manual_seed(0))
    staged = batches(cfg.train.batch_size)
    draws = torch.Generator().manual_seed(1)
    report["train_b64"] = profiled(
        lambda i: pipeline.train_step(state, staged[i % 4], draws), args.steps,
        f"[2] train step, batch {cfg.train.batch_size}, fov 360", card)
    if not np.isfinite(float(pipeline.eval_step(state, staged[0], draws)["loss"])):
        raise RuntimeError("non-finite loss after the profiled train steps")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
