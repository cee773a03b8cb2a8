#!/usr/bin/env python3
"""Smoke run of the PyTorch port (witw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises:
1. Require a CUDA device; print the card's name and power limit.
2. Build the fused-match CUDA kernel from witw_tpu_torch/csrc with nvcc
   (sm_90a); print the build seconds and ptxas' register/shared-memory use.
3. Hold the kernel against its plain PyTorch version in f32 (TF32 off) at
   the main-path, fov-90, ragged and gallery-block shapes.
4. Drive the slice at full CVUSA width (bf16 towers, batch 128, random
   weights from a seed): FovPipeline.forward_distance at fov 360 and 90.
5. Retrieval eval: train.loop.test (as test_ranks, which also returns the
   ranks) on 1024 synthetic pairs through the fused kernel. Then two
   reference checks: a small full-geometry batch on the GPU against the same
   pipeline on the CPU, and equal ranks from the fused and FFT evaluators on
   planted embeddings.
6. Time the kernel against the plain version, and embed+match pairs/s.

The launch count is reset just before phase 4 and read right after test()
in phase 5, so it counts the main path only: forward_distance at fov 360 and
90, and test(). Each of the three must raise it. The second-to-last line is
the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Without a GPU, or without the repo beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from witw_tpu.configs import fov_experiment
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, metrics_from_ranks
from witw_tpu_torch.kernels.build import build_library
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.ops import fused_match
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.pipeline import FovPipeline
from witw_tpu_torch.utils.device import require_cuda

RTOL, ATOL = 1e-5, 1e-6
TIE_REL = 1e-5  # plain top-2 correlation gap under which a pair is a near tie
KERNEL_SOURCE = "witw_tpu_torch/csrc/fused_match.cu"
KERNEL_REPLACES = "witw_tpu/ops/pallas/fused_match.py:83"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def maps(gen, g, q, h, w, c, sw, device):
    o = torch.randn(g, h, w, c, generator=gen, device=device)
    s = torch.randn(q, h, sw, c, generator=gen, device=device)
    return o, s


def compare_kernel(name, o, s):
    """Kernel vs plain on the same inputs; near-tie pairs (plain top-2 gap
    <= TIE_REL * |max|) are excluded, every other pair must agree."""
    d_k, or_k = fused_match.fused_chord_distance_nhwc(o, s)
    d_p, or_p = fused_match.fused_chord_distance_plain(o, s)
    top2 = torch.topk(circular_correlation(o, s), 2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= TIE_REL * top2[..., 0].abs()
    torch.cuda.synchronize()
    keep = ~tie
    orient_bad = int(((or_k != or_p) & keep).sum())
    err = (d_k - d_p).abs()[keep]
    max_abs = float(err.max()) if err.numel() else 0.0
    close = torch.isclose(d_k, d_p, rtol=RTOL, atol=ATOL) | tie
    log(f"  {name}: G={o.shape[0]} Q={s.shape[0]} h={o.shape[1]} W={o.shape[2]} "
        f"c={o.shape[3]} sw={s.shape[2]}  max_abs_err={max_abs:.3e}  "
        f"near_ties_excluded={int(tie.sum())}/{tie.numel()}  orient_mismatch={orient_bad}")
    if orient_bad or not bool(close.all()) or not bool(torch.isfinite(d_k).all()):
        raise AssertionError(f"kernel disagrees with its plain version at {name}")
    return max_abs


def cuda_ms(fn, calls: int, reps: int):
    """Median ms per call over ``reps`` runs of ``calls`` calls (warm)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def interleaved_ms(plain, kernel, calls: int, reps: int):
    """Plain and kernel timed in turns (plain, kernel, kernel, plain, ...)."""
    t_plain, t_kernel = [], []
    for rep in range(reps):
        order = [(plain, t_plain), (kernel, t_kernel)]
        for fn, out in (order if rep % 2 == 0 else order[::-1]):
            out.append(cuda_ms(fn, calls, 1))
    return statistics.median(t_kernel), statistics.median(t_plain)


def raw_batch(rng, cfg, b):
    d = cfg.data
    return {
        "surface": rng.uniform(0, 255, (b, d.surface_height, d.surface_width_max, 3)).astype(np.float32),
        "overhead": rng.uniform(0, 255, (b, d.overhead_size, d.overhead_size, 3)).astype(np.float32),
    }


def synthetic_loader(cfg, n, batch, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    for _ in range(n // batch):
        yield {
            "surface": rng.integers(0, 256, (batch, d.surface_height, d.surface_width_max, 3), np.uint8),
            "overhead": rng.integers(0, 256, (batch, d.overhead_size, d.overhead_size, 3), np.uint8),
        }


def planted_embeddings(rng, n, h, w, c, sw):
    """As tests/test_pallas_match.py plants them: each surface is a noisy
    window of its own overhead map."""
    o = rng.standard_normal((n, h, w, c)).astype(np.float32)
    s = rng.standard_normal((n, h, sw, c)).astype(np.float32)
    for i in range(n):
        start = rng.integers(0, w)
        cols = [(start + k) % w for k in range(sw)]
        s[i] = o[i][:, cols, :] + 0.1 * s[i]
    return o, s


def main() -> int:
    # 1. device
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    # 2. build
    t0 = time.perf_counter()
    lib_path, build_log = build_library("fused_match")
    fused_match._lib()
    log(f"[2] built {lib_path.name} with nvcc (sm_90a) in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "ptxas info" in line or "spill" in line:
            log("    " + line.strip())

    # 3. kernel vs plain, f32, TF32 off
    log("[3] fused_corr_distance vs plain PyTorch "
        f"(rtol {RTOL}, atol {ATOL}; near ties: top-2 gap <= {TIE_REL}*|max|)")
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = {
        "main path": (128, 128, 4, 64, 16, 64),
        "fov 90": (128, 128, 4, 64, 16, 16),
        "ragged": (37, 5, 4, 64, 16, 64),
        "gallery block": (8832, 128, 4, 64, 16, 64),
    }
    inputs = {k: maps(gen, *v, device) for k, v in shapes.items()}
    max_abs_err = max(compare_kernel(k, *inputs[k]) for k in shapes)

    # 4. the slice at full width
    fused_match.launches = 0
    cfg = fov_experiment("cvusa", 360)
    pipeline = FovPipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(0))
    batch = raw_batch(np.random.default_rng(0), cfg, 128)
    d360 = pipeline.forward_distance(params, batch)
    torch.cuda.synchronize()
    if d360.shape != (128, 128) or not bool(torch.isfinite(d360).all()):
        raise AssertionError(f"fov 360 distances: shape {tuple(d360.shape)}, finite "
                             f"{bool(torch.isfinite(d360).all())}")
    after_360 = fused_match.launches
    if after_360 < 1:
        raise AssertionError("forward_distance did not launch the fused kernel")
    cfg90 = fov_experiment("cvusa", 90)
    d90 = FovPipeline(cfg90, device).forward_distance(params, batch)
    torch.cuda.synchronize()
    if d90.shape != (128, 128) or not bool(torch.isfinite(d90).all()):
        raise AssertionError("fov 90 distances are not finite [128, 128]")
    if fused_match.launches <= after_360:
        raise AssertionError("fov 90 forward_distance did not launch the fused kernel")
    log(f"[4] forward_distance bf16 batch 128: fov 360 d [128, 128] mean {float(d360.mean()):.6f}; "
        f"fov 90 d [128, 128] mean {float(d90.mean()):.6f}; launches {fused_match.launches}")

    # 5. retrieval eval through the fused kernel
    n_eval, eval_batch = 1024, 64
    cfg_eval = fov_experiment("cvusa", 360)
    cfg_eval = cfg_eval.replace(eval=dataclasses.replace(cfg_eval.eval, batch_size=eval_batch))
    log(f"[5] train.loop.test on {n_eval} synthetic pairs, batches of {eval_batch}, use_fused=True")
    before_test = fused_match.launches
    metrics, ranks = loop.test_ranks(
        cfg_eval, pipeline, synthetic_loader(cfg_eval, n_eval, eval_batch, 2), params)
    launches = fused_match.launches
    if launches <= before_test:
        raise AssertionError("test() did not launch the fused kernel")
    if ranks.shape != (n_eval,) or ranks.min() < 1 or ranks.max() > n_eval:
        raise AssertionError(f"ranks out of [1, {n_eval}]: {ranks.min()}..{ranks.max()}")
    if metrics_from_ranks(ranks) != metrics:
        raise AssertionError("test() metrics do not follow from its ranks")
    log(f"    metrics {json.dumps(metrics)}; kernel launches: test() {launches - before_test}, "
        f"main path {launches}")

    # Checks past this point launch the kernel outside the counted main path.
    # A small full-geometry batch: GPU f32 against the same pipeline on the CPU.
    cfg32 = fov_experiment("cvusa", 360, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    small = raw_batch(np.random.default_rng(1), cfg32, 2)
    gpu32 = FovPipeline(cfg32, device).forward_distance(params, small).cpu()
    cpu_params = {t: {k: v.cpu() for k, v in p.items()} for t, p in params.items()}
    cpu32 = FovPipeline(cfg32, "cpu").forward_distance(cpu_params, small)
    ref_err = float((gpu32 - cpu32).abs().max())
    log(f"    f32 full geometry, batch 2: GPU (kernel) vs CPU (plain) max |dd| = {ref_err:.3e} (atol 1e-3)")
    if not ref_err <= 1e-3:
        raise AssertionError("GPU slice disagrees with the CPU slice")

    o_pl, s_pl = planted_embeddings(np.random.default_rng(3), 1024, 4, 64, 16, 64)
    r_fused = FovGalleryEvaluator(use_fused=True, device=device).ranks(o_pl, s_pl)
    r_fft = FovGalleryEvaluator(use_fused=False, device=device).ranks(o_pl, s_pl)
    if not np.array_equal(r_fused, r_fft):
        raise AssertionError(f"fused and FFT ranks differ on {int((r_fused != r_fft).sum())} queries")
    log(f"    planted [1024, 4, 64, 16]: fused == FFT ranks (mean rank {r_fused.mean():.4f})")

    # 6. timing (CUDA events, warm, median of >= 5)
    log(f"[6] timing on {card}")
    o, s = inputs["main path"]
    t_main, t_main_plain = interleaved_ms(
        lambda: fused_match.fused_chord_distance_plain(o, s),
        lambda: fused_match.fused_chord_distance_nhwc(o, s), calls=20, reps=7)
    log(f"    main path G=Q=128 sw=64: kernel {t_main:.4f} ms, plain {t_main_plain:.4f} ms ({card})")
    o, s = inputs["gallery block"]
    t_gal, t_gal_plain = interleaved_ms(
        lambda: fused_match.fused_chord_distance_plain(o, s),
        lambda: fused_match.fused_chord_distance_nhwc(o, s), calls=3, reps=7)
    log(f"    gallery block G=8832 Q=128 sw=64: kernel {t_gal:.4f} ms, plain {t_gal_plain:.4f} ms ({card})")
    del inputs, o, s

    gen_in = torch.Generator(device=device).manual_seed(1)
    d = cfg.data
    staged = [
        {"surface": torch.rand(128, d.surface_height, d.surface_width_max, 3,
                               generator=gen_in, device=device) * 255.0,
         "overhead": torch.rand(128, d.overhead_size, d.overhead_size, 3,
                                generator=gen_in, device=device) * 255.0}
        for _ in range(4)
    ]
    steps = 8
    step_of = iter(range(10**9))

    def stage(fn):
        return lambda: fn(params, staged[next(step_of) % len(staged)])

    t_pre = cuda_ms(stage(lambda p, b: pipeline.preprocess(b)), steps, 5)
    t_embed = cuda_ms(stage(pipeline.embed_step), steps, 5)
    t_fwd = cuda_ms(stage(pipeline.forward_distance), steps, 5)
    pairs_per_s = 128 * 1000.0 / t_fwd
    log(f"    embed+match bf16 batch 128 (fov 360, varied inputs): {t_fwd:.3f} ms/step, "
        f"{pairs_per_s:.2f} pairs/s; preprocess {t_pre:.3f} ms, embed (incl. preprocess) "
        f"{t_embed:.3f} ms, match {t_fwd - t_embed:.3f} ms ({card})")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "fused_corr_distance",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": t_main,
        "plain_ms": t_main_plain,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
