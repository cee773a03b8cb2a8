#!/usr/bin/env python3
"""Host-side costs of the heatmap sweep and the training CLI on one NVIDIA GPU.

    python3 profile_host.py [--tiles 512] [--out chiprun_out/profile_host.json]
                            [--against DIR]

Random-weight towers from seed 0; every input is made from a seed.
1. The sweep's tile loop (tools.build_index.embed_tiles, as tools.heatmap
   .sweep drives it) at chip_smoke.py [21]'s geometry: fov_experiment("witw",
   70), its synthetic 3-band strip at 0.3 m per pixel, the first --tiles
   windows of its 100 x 100 grid (750^2 px each, resampled to 256^2), the
   bf16 overhead tower, cold (no cache), host clock:
   a. the reads alone, as tiles/s: one thread on one strip handle, and
      build_index.READERS threads, a handle each, on runs of neighbouring
      tiles (the port's reader);
   b. the overhead tower alone on a staged batch of 64 (CUDA events);
   c. embed_tiles with build_index.READERS = 1 (witw_tpu's one producer
      thread); 8 readers sharing one strip handle; 8 readers with a handle
      each, the batch's tiles dealt round-robin; 8 readers with a handle
      each on runs of neighbouring tiles (the port);
   d. the last again under torch.profiler: the device's busy share of the
      loop's wall time (merged kernel intervals over the host clock).
2. The decode pool (data.loader.PairLoader) at chip_smoke.py [22]'s
   geometry: CVUSA pairs (JPEG 128 x 512, PNG 256^2), batch 64, the
   preset's 8 workers, 10 batches, for the pool's processes started by
   "spawn" and "forkserver" (loader.START_METHOD) and for threads: the first
   batch's latency (the pool's start and one batch), the other 9 batches'
   pairs/s, a second epoch's pairs/s on the same pool. This script's main
   module imports torch and the port, as the CLI's does.
3. The CLI as a user runs it: ``python -m witw_tpu_torch.cli.cvig_fov
   --mode train --epochs 1 --dataset cvusa --fov 360`` in a child process
   on 2024 synthetic pairs (1000 to val, the preset's val_quantity; 16 train
   steps of 64): its wall time and the loop's train pairs/s (its StepTimer
   over steps 3-16, from metrics.jsonl), beside the train step on the same
   pairs staged on the card (CUDA events, as chip_smoke.py [14]) and the
   loader alone (2, with the workers the CLI uses: PairLoader's default).
   With --against DIR (another checkout of the repo, such as a `git
   archive` of the parent under the gitignored archive_check/), the CLI of
   DIR's package and this one's also run in turns (DIR, this, this, DIR),
   each in a fresh directory.
Each line names the card and its power limit; --out writes the numbers as
JSON. The work directory .profile_host/ is removed at the end.
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import contextlib
import inspect
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.func import functional_call
from torch.profiler import ProfilerActivity, profile

from chip_smoke import card_line, write_cli_dataset, write_strip
from profile_int8 import merged_us
from witw_tpu_torch.cli import common as cli_common
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.data import loader
from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.kernels.build import build_libraries
from witw_tpu_torch.tools import build_index, geotiff, heatmap
from witw_tpu_torch.train.pipeline import FovPipeline
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.profiling import cuda_ms

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".profile_host"
BATCH = 64
LOADER_BATCHES = 10
CLI_TRAIN_STEPS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def readers(n: int):
    real = build_index.READERS
    build_index.READERS = n
    try:
        yield
    finally:
        build_index.READERS = real


def dealt(read_tile):
    """A reader whose thread t, given batch positions 8t..8t+7 by
    embed_tiles, reads the batch's tiles t, t + 8, ..., t + 56 instead."""
    per = BATCH // 8

    def read(i):
        start, j = divmod(i, BATCH)
        return read_tile(start * BATCH + j // per + per * (j % per))

    return read


def phase_sweep(card, device, n_tiles):
    cfg = fov_experiment("witw", 70)
    d = cfg.data
    bounds, side = write_strip(WORK)
    strip = str(WORK / "03_paris.tif")
    _, _, windows = heatmap.window_grid(bounds, 225.0, 56.25)
    windows = windows[:n_tiles]
    pipeline = FovPipeline(cfg, device)
    overhead = pipeline.init_state(torch.Generator().manual_seed(0)).params["overhead"]
    size = d.overhead_size
    log(f"[1] the sweep's tile loop: the first {n_tiles} windows of chip_smoke [21]'s 100 x 100 "
        f"grid on a {side} x {side} x 3 strip, fov_experiment('witw', 70), bf16, batch {BATCH}, "
        f"build_index.READERS = {build_index.READERS} ({os.cpu_count()} cores)")
    out = {}

    # a. the reads alone
    with heatmap.tile_reader(strip, windows, size) as read_tile:
        read_tile(0)
        t0 = time.perf_counter()
        for i in range(n_tiles):
            read_tile(i)
        out["reads_one_thread_tiles_per_s"] = n_tiles / (time.perf_counter() - t0)
    with heatmap.tile_reader(strip, windows, size) as read_tile:
        per = -(-BATCH // build_index.READERS)
        with futures.ThreadPoolExecutor(build_index.READERS) as pool:
            t0 = time.perf_counter()
            for start in range(0, n_tiles, BATCH):
                list(pool.map(lambda s: [read_tile(i) for i in range(s, min(s + per, n_tiles))],
                              range(start, min(start + BATCH, n_tiles), per)))
            out["reads_port_tiles_per_s"] = n_tiles / (time.perf_counter() - t0)
    log(f"    a. reads alone (window + resample to {size}^2): one thread, one handle "
        f"{out['reads_one_thread_tiles_per_s']:.2f} tiles/s; {build_index.READERS} threads, a "
        f"handle each, runs of neighbours {out['reads_port_tiles_per_s']:.2f} tiles/s ({card})")

    # b. the tower alone
    x = torch.rand(BATCH, size, size, 3, device=device) * 255.0

    def tower():
        with torch.no_grad():
            functional_call(pipeline.overhead_model, overhead,
                            (build_index.preprocess_tiles(d, x),),
                            {"train": False, "generator": None}, strict=True)

    t_tower = cuda_ms(tower, 3, 5)
    out["tower_ms_per_batch"] = t_tower
    out["tower_tiles_per_s"] = BATCH * 1e3 / t_tower
    log(f"    b. the overhead tower alone (preprocess + bf16 tower, a staged batch of {BATCH}): "
        f"{t_tower:.3f} ms = {out['tower_tiles_per_s']:.2f} tiles/s (CUDA events) ({card})")

    # c. embed_tiles cold, four readers
    def run(read_tile, n_readers):
        with readers(n_readers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb, _ = build_index.embed_tiles(pipeline, overhead, read_tile, n_tiles, BATCH)
            torch.cuda.synchronize()
            return n_tiles / (time.perf_counter() - t0), emb

    with heatmap.tile_reader(strip, windows, size) as read_tile:
        run(read_tile, build_index.READERS)  # warm-up: the towers' first launches, the page cache
    rates = {}
    with heatmap.tile_reader(strip, windows, size) as read_tile:
        rates["one_reader"], ref = run(read_tile, 1)
    with geotiff.GeoTiff(strip) as sat:
        def shared(i):
            tile = sat.read_world_window(*windows[i]).astype(np.float32)
            return geotiff.resample(tile[..., :3], size, size)

        rates["8_readers_one_handle"], emb_shared = run(shared, 8)
    with heatmap.tile_reader(strip, windows, size) as read_tile:
        rates["8_readers_dealt"], _ = run(dealt(read_tile), 8)
    with heatmap.tile_reader(strip, windows, size) as read_tile:
        rates["8_readers_runs"], emb = run(read_tile, 8)
    diff = max(float(np.abs(e - ref).max()) for e in (emb, emb_shared))
    out["embed_tiles_tiles_per_s"] = rates
    log(f"    c. embed_tiles, cold, tiles/s (host clock): one reader (witw_tpu's producer) "
        f"{rates['one_reader']:.2f}; 8 readers, one shared handle "
        f"{rates['8_readers_one_handle']:.2f}; 8 readers, a handle each, dealt round-robin "
        f"{rates['8_readers_dealt']:.2f}; 8 readers, a handle each, runs of neighbours (the "
        f"port) {rates['8_readers_runs']:.2f} ({card}); max |d emb| against one reader's "
        f"{diff:.3e}")

    # d. the device's busy share under the port's reader
    with heatmap.tile_reader(strip, windows, size) as read_tile, readers(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_index.embed_tiles(pipeline, overhead, read_tile, n_tiles, BATCH)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = merged_us(kernels)
    out["profiled_tiles_per_s"] = n_tiles / (wall_us / 1e6)
    out["device_busy_share"] = busy_us / wall_us
    log(f"    d. under torch.profiler, 8 readers, runs: {out['profiled_tiles_per_s']:.2f} tiles/s; "
        f"the device busy {busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms = "
        f"{100 * busy_us / wall_us:.1f}% ({len(kernels)} kernels) ({card})")
    return out


def default_workers() -> str:
    return inspect.signature(loader.PairLoader).parameters["worker_mode"].default


def loader_rates(pairs, surface_hw, overhead_hw, workers, mode, method=None):
    """(first batch s, the next batches' pairs/s, a second epoch's pairs/s)."""
    real = loader.START_METHOD
    if method:
        loader.START_METHOD = method
    pl = loader.PairLoader(pairs, BATCH, surface_hw, overhead_hw, num_workers=workers,
                           worker_mode=mode)
    try:
        t0 = time.perf_counter()
        it = iter(pl)
        next(it)
        first = time.perf_counter() - t0
        t1 = time.perf_counter()
        rest = sum(1 for _ in it)
        rate = rest * BATCH / (time.perf_counter() - t1)
        t2 = time.perf_counter()
        again = sum(1 for _ in pl)
        rate2 = again * BATCH / (time.perf_counter() - t2)
    finally:
        pl.close()
        loader.START_METHOD = real
    return first, rate, rate2


def phase_loader(card, csv_path):
    cfg = fov_experiment("cvusa", 360)
    surface_hw, overhead_hw = cli_common.host_geometry(cfg)
    pairs = read_pair_paths(cfg.data.dataset, csv_path)[:LOADER_BATCHES * BATCH]
    workers = cfg.data.num_workers
    log(f"[2] PairLoader: {len(pairs)} CVUSA pairs (surface {surface_hw}, overhead {overhead_hw}),"
        f" batch {BATCH}, {workers} workers; the port's default: {default_workers()!r}, "
        f"START_METHOD {loader.START_METHOD!r}")
    out = {}
    for name, mode, method in (("spawn", "process", "spawn"),
                               ("forkserver", "process", "forkserver"),
                               ("thread", "thread", None)):
        first, rate, rate2 = loader_rates(pairs, surface_hw, overhead_hw, workers, mode, method)
        steady = BATCH / rate
        out[name] = {"first_batch_s": first, "pool_start_s": first - steady,
                     "pairs_per_s": rate, "second_epoch_pairs_per_s": rate2}
        log(f"    {name}: first batch {first:.3f} s (pool start about {first - steady:.3f} s "
            f"above a steady batch's {steady:.3f} s); batches 2-{LOADER_BATCHES} {rate:.2f} "
            f"pairs/s; second epoch {rate2:.2f} pairs/s (host clock) ({card})")
    return out


def tree_env(tree: Path) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tree)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def run_cli(tree: Path, csv_path: str, work: Path):
    """The CLI from ``tree``'s package in a child process, in a fresh
    ``work`` directory: (seconds from start to exit, its metrics by tag)."""
    work.mkdir(parents=True)
    argv = [sys.executable, "-m", "witw_tpu_torch.cli.cvig_fov", "--mode", "train", "--epochs",
            "1", "--dataset", "cvusa", "--fov", "360", "--train-csv", csv_path, "--test-csv",
            csv_path]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=work, env=tree_env(tree), capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the CLI of {tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    records = [json.loads(line) for line in
               (work / "runs" / "fov_360_cvusa" / "train" / "metrics.jsonl").read_text()
               .splitlines()]
    return wall, {r["tag"]: r.get("value") for r in records}


def phase_cli(card, device, csv_path, against=None):
    cfg = fov_experiment("cvusa", 360)
    n_pairs = len(read_pair_paths(cfg.data.dataset, csv_path))
    log(f"[3] python -m witw_tpu_torch.cli.cvig_fov --mode train --epochs 1 --dataset cvusa "
        f"--fov 360 on {n_pairs} pairs ({cfg.train.val_quantity} to val, "
        f"{CLI_TRAIN_STEPS} train steps of {cfg.train.batch_size}); the loader's workers: "
        f"{default_workers()!r}")
    wall, tags = run_cli(ROOT, csv_path, WORK / "cli")
    cli_rate = tags["train pairs_per_sec"]
    turns = {"this": [], "against": []}
    if against:  # its kernels are built first, outside the turns
        subprocess.run([sys.executable, "-c", "from witw_tpu_torch.kernels.build import "
                        "build_libraries; build_libraries(['conv3x3_bf16', 'fused_match'])"],
                       cwd=against, env=tree_env(against), check=True, timeout=600)
        for k, name in enumerate(("against", "this", "this", "against")):
            turns[name].append(run_cli(ROOT if name == "this" else against, csv_path,
                                       WORK / f"cli_turn{k}"))

    # the same pairs' train step on staged device batches
    pipeline = FovPipeline(cfg, device)
    state = pipeline.init_state(torch.Generator().manual_seed(0))
    surface_hw, overhead_hw = cli_common.host_geometry(cfg)
    pl = loader.PairLoader(read_pair_paths(cfg.data.dataset, csv_path)[:4 * BATCH], BATCH,
                           surface_hw, overhead_hw, num_workers=cfg.data.num_workers)
    try:
        staged = [{k: torch.as_tensor(b[k], device=device) for k in ("surface", "overhead")}
                  for b in pl]
    finally:
        pl.close()
    step_of = itertools.count()
    gen = torch.Generator().manual_seed(14)
    t_step = cuda_ms(lambda: pipeline.train_step(state, staged[next(step_of) % 4], gen), 4, 5)
    staged_rate = BATCH * 1e3 / t_step
    out = {"wall_s": wall, "train_pairs_per_s": cli_rate,
           "train_step_p50_s": tags.get("train step_time_p50_s"),
           "staged_pairs_per_s": staged_rate}
    log(f"    the CLI: {wall:.2f} s from start to exit (host clock); train {cli_rate:.2f} pairs/s "
        f"(the loop's StepTimer, steps 3-{CLI_TRAIN_STEPS}), step p50 "
        f"{tags.get('train step_time_p50_s')} s; the train step on the same pairs staged on the "
        f"card {t_step:.3f} ms = {staged_rate:.2f} pairs/s (CUDA events) ({card})")
    if against:
        out["turns"] = {k: [{"wall_s": w, "train_pairs_per_s": t["train pairs_per_sec"]}
                            for w, t in v] for k, v in turns.items()}
        log(f"    in turns with {against}'s CLI (against, this, this, against): seconds from "
            f"start to exit {[round(w, 3) for w, _ in turns['against']]} against "
            f"{[round(w, 3) for w, _ in turns['this']]} here; train pairs/s "
            f"{[round(t['train pairs_per_sec'], 2) for _, t in turns['against']]} against "
            f"{[round(t['train pairs_per_sec'], 2) for _, t in turns['this']]} ({card})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=512)
    ap.add_argument("--out", default="chiprun_out/profile_host.json")
    ap.add_argument("--against", default=None,
                    help="another checkout of the repo whose CLI [3] also runs, in turns")
    args = ap.parse_args()

    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    build_libraries(["conv3x3_bf16", "fused_match"])
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    report = {"card": card}
    try:
        report["sweep"] = phase_sweep(card, device, args.tiles)
        (WORK / "03_paris.tif").unlink()
        cfg = fov_experiment("cvusa", 360)
        n_pairs = cfg.train.val_quantity + CLI_TRAIN_STEPS * cfg.train.batch_size
        t0 = time.perf_counter()
        csv_path = write_cli_dataset(WORK / "data", n_pairs, shards=8)
        log(f"    wrote {n_pairs} synthetic CVUSA pairs in {time.perf_counter() - t0:.2f} s")
        report["loader"] = phase_loader(card, csv_path)
        report["cli"] = phase_cli(card, device, csv_path,
                                  Path(args.against).resolve() if args.against else None)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
