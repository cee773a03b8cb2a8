"""Shared CLI runner: dataset loaders and the train / test drivers (port of
witw_tpu/cli/common.py; train and test modes run on a mesh of every GPU
when the host has more than one).

Reproduces the reference entry points' behaviour (reference
model/cvig_fov.py:580-601): ``--mode {train,test} --dataset {cvusa,witw}``
(and ``--fov`` for the fov and semantic models), reading the dataset CSVs
named by the config or by ``--train-csv`` / ``--test-csv``. Checkpoints go
to ``cfg.train.checkpoint_dir/<tag>`` and metrics to
``cfg.train.tensorboard_dir/<tag>/{train,test}``. The drivers run on the
card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

import torch

from witw_tpu_torch.configs.base import ExperimentConfig
from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.data.loader import PairLoader, split_train_val
from witw_tpu_torch.parallel.mesh import Mesh, make_mesh
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.metrics import MetricWriter
from witw_tpu_torch.train.pipeline import make_pipeline
from witw_tpu_torch.utils.profiling import trace_profile


def host_geometry(cfg: ExperimentConfig) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Canonical decode geometry shipped host -> device, (surface_hw,
    overhead_hw). The FOV and SAFA families: the whole panorama where the
    dataset has one, else the photo crop, and the tile at ``overhead_size``.
    The baseline family: CVUSA surfaces stay 224 x 1232 (their rows are
    repeated on the device, reference cvig_baseline.py:216-218), WITW
    surfaces are resized to 500 x 500 (cvig_baseline.py:219-221), and tiles
    stay at their native 750 x 750."""
    d = cfg.data
    if getattr(cfg.model, "kind", None) == "baseline":
        if d.dataset.name == "cvusa":
            return (224, 1232), (750, 750)
        return (500, 500), (750, 750)
    surface_w = d.surface_width_max if d.dataset.panorama else d.surface_width
    return (d.surface_height, surface_w), (d.overhead_size, d.overhead_size)


def build_loader(cfg: ExperimentConfig, pairs, shuffle, drop_last, batch_size=None) -> PairLoader:
    surface_hw, overhead_hw = host_geometry(cfg)
    return PairLoader(
        pairs,
        batch_size=batch_size or cfg.train.batch_size,
        surface_hw=surface_hw,
        overhead_hw=overhead_hw,
        channels=cfg.data.channels,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.data.num_workers,
        seed=cfg.train.seed,
        prefetch=cfg.data.prefetch,
    )


def _auto_mesh(batch_size: int) -> Optional[Mesh]:
    """A data mesh over every GPU when there is more than one and the batch
    divides over them; None otherwise (one GPU, no GPU, or an awkward
    batch size), as witw_tpu's."""
    n = torch.cuda.device_count()
    if n > 1 and batch_size % n == 0:
        return make_mesh(n_data=n)
    return None


def run_train(
    cfg: ExperimentConfig,
    tag: str,
    num_epochs: Optional[int] = None,
    profile_dir: Optional[str] = None,
    device=None,
):
    """Split the train CSV (``cfg.train.val_quantity`` pairs to val), train
    (resuming from ``latest``), checkpoint and log; ``profile_dir`` records
    a torch.profiler trace of the run. Returns the final TrainState.
    Without a ``device`` it trains data-parallel on a mesh of every GPU
    where there is more than one and ``cfg.train.batch_size`` divides over
    them (``_auto_mesh``), as witw_tpu does."""
    pairs = read_pair_paths(cfg.data.dataset, cfg.data.dataset.train_csv)
    train_pairs, val_pairs = split_train_val(pairs, cfg.train.val_quantity, cfg.train.seed)
    train_loader = build_loader(cfg, train_pairs, shuffle=True, drop_last=True)
    val_loader = build_loader(cfg, val_pairs, shuffle=False, drop_last=False)
    pipeline = make_pipeline(cfg, device)
    ckpt = Checkpointer(os.path.join(cfg.train.checkpoint_dir, tag), cfg.train.keep_checkpoints,
                        async_saves=cfg.train.async_checkpoints)
    writer = MetricWriter(os.path.join(cfg.train.tensorboard_dir, tag, "train"))
    try:
        with trace_profile(profile_dir):
            return loop.train(cfg, pipeline, train_loader, val_loader, num_epochs=num_epochs,
                              checkpointer=ckpt, writer=writer, handle_signals=True,
                              mesh=_auto_mesh(cfg.train.batch_size) if device is None else None)
    finally:
        try:
            ckpt.close()
        finally:
            writer.close()
            train_loader.close()
            val_loader.close()


def run_test(cfg: ExperimentConfig, tag: str, device=None):
    """Full-gallery retrieval eval of the test CSV with ``best``; returns
    the metrics. Without a ``device`` it runs on a mesh of every GPU where
    there is more than one and ``cfg.eval.batch_size`` divides over them
    (``_auto_mesh``), the gallery sharded with ``--shard-gallery``."""
    pairs = read_pair_paths(cfg.data.dataset, cfg.data.dataset.test_csv)
    test_loader = build_loader(cfg, pairs, shuffle=False, drop_last=False,
                               batch_size=cfg.eval.batch_size)
    pipeline = make_pipeline(cfg, device)
    ckpt = Checkpointer(os.path.join(cfg.train.checkpoint_dir, tag))
    writer = MetricWriter(os.path.join(cfg.train.tensorboard_dir, tag, "test"))
    try:
        mesh = _auto_mesh(cfg.eval.batch_size) if device is None else None
        return loop.test(cfg, pipeline, test_loader, checkpointer=ckpt, writer=writer, mesh=mesh)
    finally:
        writer.close()
        test_loader.close()


def base_parser(with_fov: bool) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--mode", default="train", choices=["train", "test"],
        help="Run mode. [Default = train]",
    )
    parser.add_argument(
        "--dataset", default="cvusa", choices=["cvusa", "witw"],
        help="Dataset to use. [Default = cvusa]",
    )
    if with_fov:
        parser.add_argument(
            "--fov", type=int, default=360, choices=range(6, 361), metavar="{6-360}",
            help="The field of view for cropping street level images. [Default = 360]",
        )
    parser.add_argument("--train-csv", default=None, help="Override train CSV path")
    parser.add_argument("--test-csv", default=None, help="Override test CSV path")
    parser.add_argument("--epochs", type=int, default=None, help="Epoch limit")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument(
        "--profile-dir", default=None,
        help="Write a torch.profiler trace of the run (TensorBoard-compatible)",
    )
    parser.add_argument(
        "--shard-gallery", action="store_true",
        help="Retrieval eval keeps the gallery resident, sharded over every mesh device "
             "(100k+-tile mode); default shards the query axis",
    )
    parser.add_argument(
        "--fast-eval", action="store_true",
        help="Rank sweep through the FFT path with bf16 frequency products (f32 "
             "accumulation) — approximate (near-tie ranks can flip); default is the "
             "exact fused-kernel path",
    )
    return parser


def apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    ds = cfg.data.dataset
    if args.train_csv or args.test_csv:
        ds = dataclasses.replace(
            ds,
            train_csv=args.train_csv or ds.train_csv,
            test_csv=args.test_csv or ds.test_csv,
        )
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset=ds))
    if args.batch_size:
        # --batch-size governs both modes: run_test's loader takes
        # eval.batch_size
        cfg = cfg.replace(
            train=dataclasses.replace(cfg.train, batch_size=args.batch_size),
            eval=dataclasses.replace(cfg.eval, batch_size=args.batch_size),
        )
    if getattr(args, "shard_gallery", False):
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, shard_gallery=True))
    if getattr(args, "fast_eval", False):
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, fast_matmul=True))
    return cfg


def run(cfg: ExperimentConfig, args, tag: str, device=None):
    """``--mode``'s driver: run_train's state or run_test's metrics."""
    if args.mode == "train":
        return run_train(cfg, tag, num_epochs=args.epochs, profile_dir=args.profile_dir,
                         device=device)
    return run_test(cfg, tag, device=device)
