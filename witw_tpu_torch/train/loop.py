"""Epoch-based train/val loop, embedding and full-gallery test (port of
witw_tpu/train/loop.py: run_phase, train, embed_all, test; the reference's
training script, cvig_fov.py:385-575).

The train/val contract is witw_tpu's: each epoch a train phase and a val
phase, a per-step loss log and epoch averages, a ``step_<N>``/``latest``
checkpoint after each epoch and ``best`` on a new best validation loss,
resume from ``latest``, and an optional SIGTERM/SIGINT handler that
checkpoints at the next phase boundary. Each epoch's draws come from
generators seeded by (seed, epoch, phase), so a resumed run sees epoch k's
draws. Loaders are iterables of dicts of numpy arrays ("surface",
"overhead", optionally "valid"). Not ported: the mesh and multi-host
branches, the metric writer and its embedding dump, ``device_prefetch``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from witw_tpu_torch.configs.base import ExperimentConfig
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, metrics_from_ranks
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import FovPipeline, Params, TrainState
from witw_tpu_torch.utils.profiling import StepTimer

PHASES = {"train": 0, "val": 1}


def phase_generator(seed: int, epoch: int, phase: str) -> torch.Generator:
    """The CPU generator of one phase of one epoch, seeded from (seed, epoch,
    phase) alone."""
    s = np.random.SeedSequence([seed, epoch, PHASES[phase]]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


def _count(batch) -> int:
    if "valid" in batch:
        return int(np.asarray(batch["valid"]).sum())
    return len(batch["surface"])


def run_phase(
    pipeline: FovPipeline,
    state: TrainState,
    loader: Iterable,
    generator: torch.Generator,
    train: bool,
    epoch: int,
    log_every: int = 1,
    verbose: bool = True,
    checkpointer: Optional[Checkpointer] = None,
    save_every_steps: int = 0,
) -> Tuple[TrainState, float, int]:
    """One pass over a loader; returns (state, avg_loss, count). Each loss is
    read one step late, so the host enqueues the next step first.
    ``save_every_steps`` > 0 writes mid-epoch step checkpoints (train)."""
    phase = "train" if train else "val"
    running_loss = 0.0
    running_count = 0
    pending = []
    timer = None

    def drain(loss, count, batch_i, tail):
        nonlocal running_loss, running_count
        loss_f = float(loss)
        running_loss += loss_f * count
        running_count += count
        if verbose and (tail or batch_i % log_every == 0):
            print(f"epoch = {epoch + 1} {phase}, iter = {batch_i}, "
                  f"count = {running_count}, loss = {loss_f:.4f}")

    for batch_i, batch in enumerate(loader):
        count = _count(batch)
        if timer is None:
            timer = StepTimer(items_per_step=count)
        timer.tick()
        if train:
            state, metrics = pipeline.train_step(state, batch, generator)
            if checkpointer is not None and save_every_steps > 0 \
                    and (batch_i + 1) % save_every_steps == 0:
                checkpointer.save_step(state, state.step, {"epoch": epoch})
        else:
            metrics = pipeline.eval_step(state, batch, generator)
        pending.append((metrics["loss"], count, batch_i))
        while len(pending) > 1:
            drain(*pending.pop(0), tail=False)
    for entry in pending:
        drain(*entry, tail=True)
    avg = running_loss / max(running_count, 1)
    if verbose:
        extra = ""
        if timer is not None and timer.summary().get("steps"):
            extra = f" ({timer.items_per_sec:.1f} pairs/s)"
        print(f"  {phase:>5}: avg loss = {avg:f}{extra}")
    return state, avg, running_count


def train(
    cfg: ExperimentConfig,
    pipeline: FovPipeline,
    train_loader: Iterable,
    val_loader: Iterable,
    num_epochs: Optional[int] = None,
    checkpointer: Optional[Checkpointer] = None,
    verbose: bool = True,
    handle_signals: bool = False,
) -> TrainState:
    """Train from fresh params (``cfg.train.seed``), or resume from the
    checkpointer's ``latest``, up to ``num_epochs`` (default
    ``cfg.train.num_epochs``). ``handle_signals=True`` installs a
    SIGTERM/SIGINT handler that finishes the current phase, checkpoints, and
    returns."""
    interrupted = {"flag": False}
    old_handlers = {}
    if handle_signals:
        import signal

        def on_signal(signum, frame):
            interrupted["flag"] = True
            if verbose:
                print(f"signal {signum}: checkpointing at next phase boundary")

        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, on_signal)

    state = pipeline.init_state(torch.Generator().manual_seed(cfg.train.seed))
    if checkpointer is None:
        checkpointer = Checkpointer(cfg.train.checkpoint_dir, keep=cfg.train.keep_checkpoints)
    start_epoch = 0
    if checkpointer.restore_latest(state) is not None:
        start_epoch = int((checkpointer.meta("latest") or {}).get("epoch", 0))
        if verbose:
            print(f"resumed from step {state.step} (epoch {start_epoch})")

    try:
        best_loss = checkpointer.best_val_loss()
        epochs = num_epochs if num_epochs is not None else cfg.train.num_epochs
        for epoch in range(start_epoch, epochs):
            if verbose:
                print(f"Epoch {epoch + 1}, {time.ctime()}")
            state, _, _ = run_phase(
                pipeline, state, train_loader, phase_generator(cfg.train.seed, epoch, "train"),
                True, epoch, cfg.train.log_every_steps, verbose,
                checkpointer=checkpointer, save_every_steps=cfg.train.save_every_steps,
            )
            if interrupted["flag"]:
                checkpointer.save_step(state, state.step, {"epoch": epoch})
                if verbose:
                    print("interrupted: state checkpointed (epoch incomplete)")
                return state
            _, val_loss, _ = run_phase(
                pipeline, state, val_loader, phase_generator(cfg.train.seed, epoch, "val"),
                False, epoch, cfg.train.log_every_steps, verbose,
            )
            checkpointer.save_step(state, state.step, {"epoch": epoch + 1})
            if best_loss is None or val_loss < best_loss:
                if verbose:
                    print("-------> new best")
                best_loss = val_loss
                checkpointer.save_best(state, val_loss, state.step)
            if interrupted["flag"]:
                return state
        return state
    finally:
        if handle_signals:
            import signal

            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)


def embed_all(
    pipeline: FovPipeline,
    params: Params,
    loader: Iterable,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed every batch of ``loader`` (dicts with numpy or tensor
    "surface" and "overhead"); returns (surface_embeds, overhead_embeds) on
    the pipeline's device, concatenated once. ``generator`` drives the
    eval-time random crop heading when the config asks for one."""
    surfaces, overheads = [], []
    for batch in loader:
        data = {"surface": batch["surface"], "overhead": batch["overhead"]}
        s_emb, o_emb = pipeline.embed_step(params, data, generator)
        surfaces.append(s_emb)
        overheads.append(o_emb)
    return torch.cat(surfaces), torch.cat(overheads)


def test_ranks(
    cfg: ExperimentConfig,
    pipeline: FovPipeline,
    test_loader: Iterable,
    params: Params,
    verbose: bool = True,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Full-gallery retrieval eval: embed, rank through the fused kernel's
    evaluator, and report the reference metric suite. Returns the metrics
    and the per-query ranks they were computed from."""
    generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    s_emb, o_emb = embed_all(pipeline, params, test_loader, generator)
    evaluator = FovGalleryEvaluator(
        query_block=cfg.eval.query_block,
        gallery_chunk=cfg.eval.gallery_chunk,
        use_fused=True,
    )
    ranks = evaluator.ranks(o_emb, s_emb)
    results = metrics_from_ranks(ranks)
    if verbose:
        print("Top  1: {:.2f}%".format(results["top_1"]))
        print("Top  5: {:.2f}%".format(results["top_5"]))
        print("Top 10: {:.2f}%".format(results["top_10"]))
        print("Top 1%: {:.2f}%".format(results["top_percent"]))
        print("Avg. Rank: {:.2f}".format(results["avg_rank"]))
        print("Med. Rank: {:.2f}".format(results["med_rank"]))
        print("Locations: {}".format(results["locations"]))
    return results, ranks


def test(
    cfg: ExperimentConfig,
    pipeline: FovPipeline,
    test_loader: Iterable,
    params: Params,
    verbose: bool = True,
) -> Dict[str, float]:
    """Full-gallery retrieval eval (:func:`test_ranks` without the ranks)."""
    return test_ranks(cfg, pipeline, test_loader, params, verbose)[0]
