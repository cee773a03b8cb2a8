"""Epoch-based train/val loop, embedding and full-gallery test (port of
witw_tpu/train/loop.py: device_prefetch, run_phase, train, embed_all,
dump_val_embeddings, test; the reference's training script,
cvig_fov.py:385-575).

The train/val contract is witw_tpu's: each epoch a train phase and a val
phase, a per-step loss log and epoch averages, a ``step_<N>``/``latest``
checkpoint after each epoch and ``best`` on a new best validation loss,
resume from ``latest``, and an optional SIGTERM/SIGINT handler that
checkpoints at the next phase boundary. Each epoch's draws come from
generators seeded by (seed, epoch, phase), so a resumed run sees epoch k's
draws. Loaders are iterables of dicts of numpy arrays ("surface",
"overhead", optionally "valid"), which ``device_prefetch`` moves to the
pipeline's device ahead of the step. A ``MetricWriter`` gets witw_tpu's
scalars and texts. Each function takes any family's pipeline
(``FovPipeline``, ``SafaPipeline`` or ``BaselinePipeline``); ``test`` ranks
the FOV family's maps by the orientation-aligned chord distance and the SAFA
and baseline families' vectors by Euclidean distance, with the eval-time
random draws (the FOV crop heading, the baseline's synced rotation) from a
generator seeded ``cfg.train.seed + 1``. Not ported: the mesh and
multi-host branches.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from witw_tpu_torch.configs.base import ExperimentConfig
from witw_tpu_torch.evaluation.gallery import (FovGalleryEvaluator, euclidean_ranks,
                                               metrics_from_ranks)
from witw_tpu_torch.match.distance import paired_chord_distance
from witw_tpu_torch.ops.image import denormalize_images
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.metrics import MetricWriter
from witw_tpu_torch.train.pipeline import FovPipeline, Params, Pipeline, TrainState
from witw_tpu_torch.utils.profiling import StepTimer

PHASES = {"train": 0, "val": 1, "dump": 2}
BATCH_KEYS = ("surface", "overhead", "valid")


def phase_generator(seed: int, epoch: int, phase: str) -> torch.Generator:
    """The CPU generator of one phase of one epoch, seeded from (seed, epoch,
    phase) alone."""
    s = np.random.SeedSequence([seed, epoch, PHASES[phase]]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


def _count(batch) -> int:
    if "valid" in batch:
        return int(np.asarray(batch["valid"]).sum())
    return len(batch["surface"])


def device_prefetch(loader: Iterable, device, depth: int = 2) -> Iterator[Tuple[Dict, int]]:
    """Move each batch's "surface", "overhead" (and "valid") to ``device``
    ``depth`` batches ahead of the step that consumes it. Yields (the
    batch's tensors, its count of real rows). On a CUDA device each batch is
    copied from pinned host memory on a side stream, and the step's stream
    waits on an event recorded after the copy, so the upload of batch k + 1
    overlaps step k; elsewhere the arrays become tensors in place."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    buf = collections.deque()

    def ready(item):
        data, n, event = item
        if cuda:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in data.values():
                t.record_stream(stream)  # allocated on the copy stream, used on this one
        return data, n

    for batch in loader:
        n = _count(batch)
        host = {k: torch.as_tensor(batch[k]) for k in BATCH_KEYS if k in batch}
        event = None
        if cuda:
            with torch.cuda.stream(copy_stream):
                data = {k: (v.pin_memory() if v.device.type == "cpu" else v).to(
                    device, non_blocking=True) for k, v in host.items()}
                event = torch.cuda.Event()
                event.record(copy_stream)
        else:
            data = {k: v.to(device) for k, v in host.items()}
        buf.append((data, n, event))
        if len(buf) >= depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())


def run_phase(
    pipeline: Pipeline,
    state: TrainState,
    loader: Iterable,
    generator: torch.Generator,
    train: bool,
    epoch: int,
    log_every: int = 1,
    verbose: bool = True,
    checkpointer: Optional[Checkpointer] = None,
    save_every_steps: int = 0,
    writer: Optional[MetricWriter] = None,
) -> Tuple[TrainState, float, int]:
    """One pass over a loader; returns (state, avg_loss, count). Each loss is
    read one step late, so the host enqueues the next step first.
    ``save_every_steps`` > 0 writes mid-epoch step checkpoints (train).
    ``writer`` gets the running loss at each global step (epoch x
    len(loader) + batch, the reference's axis) and the phase's pairs/s and
    median step time at the epoch."""
    phase = "train" if train else "val"
    running_loss = 0.0
    running_count = 0
    pending = []
    timer = None
    try:
        step_base = epoch * len(loader)
    except TypeError:
        step_base = 0

    def drain(loss, count, batch_i, tail):
        nonlocal running_loss, running_count
        loss_f = float(loss)
        running_loss += loss_f * count
        running_count += count
        if verbose and (tail or batch_i % log_every == 0):
            print(f"epoch = {epoch + 1} {phase}, iter = {batch_i}, "
                  f"count = {running_count}, loss = {loss_f:.4f}")
        if writer is not None:
            writer.scalar(f"{phase} loss", running_loss / running_count, step_base + batch_i)

    for batch_i, (batch, count) in enumerate(device_prefetch(loader, pipeline.device)):
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
    if timer is not None and writer is not None:
        stats = timer.summary()
        if stats.get("steps"):
            writer.scalar(f"{phase} pairs_per_sec", stats["items_per_sec"], epoch)
            writer.scalar(f"{phase} step_time_p50_s", stats["step_time_p50_s"], epoch)
    if verbose:
        extra = ""
        if timer is not None and timer.summary().get("steps"):
            extra = f" ({timer.items_per_sec:.1f} pairs/s)"
        print(f"  {phase:>5}: avg loss = {avg:f}{extra}")
    return state, avg, running_count


def train(
    cfg: ExperimentConfig,
    pipeline: Pipeline,
    train_loader: Iterable,
    val_loader: Iterable,
    num_epochs: Optional[int] = None,
    checkpointer: Optional[Checkpointer] = None,
    verbose: bool = True,
    handle_signals: bool = False,
    writer: Optional[MetricWriter] = None,
) -> TrainState:
    """Train from fresh params (``cfg.train.seed``), or resume from the
    checkpointer's ``latest``, up to ``num_epochs`` (default
    ``cfg.train.num_epochs``). ``handle_signals=True`` installs a
    SIGTERM/SIGINT handler that finishes the current phase, checkpoints, and
    returns. ``writer`` gets both phases' losses and rates, each epoch's
    embedding dump and the new-best texts."""
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
                writer=writer,
            )
            if interrupted["flag"]:
                checkpointer.save_step(state, state.step, {"epoch": epoch})
                if verbose:
                    print("interrupted: state checkpointed (epoch incomplete)")
                break
            _, val_loss, _ = run_phase(
                pipeline, state, val_loader, phase_generator(cfg.train.seed, epoch, "val"),
                False, epoch, cfg.train.log_every_steps, verbose, writer=writer,
            )
            if writer is not None:
                dump_val_embeddings(pipeline, state.params, val_loader, writer, epoch,
                                    phase_generator(cfg.train.seed, epoch, "dump"))
            checkpointer.save_step(state, state.step, {"epoch": epoch + 1})
            if best_loss is None or val_loss < best_loss:
                if verbose:
                    print("-------> new best")
                best_loss = val_loss
                checkpointer.save_best(state, val_loss, state.step)
                if writer is not None:
                    writer.text("best_loss", f"new best loss: {best_loss}, epoch: {epoch + 1}")
            if interrupted["flag"]:
                break
    finally:
        if handle_signals:
            import signal

            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
    checkpointer.wait()  # the last save is on disk when train returns
    return state


def embed_all(
    pipeline: Pipeline,
    params: Params,
    loader: Iterable,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed every batch of ``loader`` (dicts with numpy or tensor
    "surface" and "overhead"); returns (surface_embeds, overhead_embeds) on
    the pipeline's device, concatenated once. ``generator`` drives the
    eval-time random crop heading when the config asks for one, and the
    baseline family's synced rotation."""
    surfaces, overheads = [], []
    for data, _ in device_prefetch(loader, pipeline.device):
        s_emb, o_emb = pipeline.embed_step(params, data, generator)
        surfaces.append(s_emb)
        overheads.append(o_emb)
    return torch.cat(surfaces), torch.cat(overheads)


def _aligned_crop(o_emb: torch.Tensor, orientation: torch.Tensor, sw: int) -> torch.Tensor:
    """Each overhead map's sw columns starting at its orientation,
    circularly: [B, h, W, c] -> [B, h, sw, c]."""
    w = o_emb.shape[2]
    cols = (orientation.long()[:, None] + torch.arange(sw, device=o_emb.device)[None]) % w
    index = cols[:, None, :, None].expand(o_emb.shape[0], o_emb.shape[1], sw, o_emb.shape[3])
    return torch.gather(o_emb, 2, index)


@torch.no_grad()
def dump_val_embeddings(pipeline: Pipeline, params: Params, val_loader: Iterable,
                        writer: MetricWriter, epoch: int,
                        generator: Optional[torch.Generator] = None) -> None:
    """TensorBoard projector dump after the val phase (reference
    cvig_fov.py:475-479): the first val batch's surface embeddings and each
    overhead map's orientation-aligned crop for its own query, with the
    denormalized network inputs as thumbnails (the surface padded to the
    polar map's width, then both to squares, as the projector needs). The
    reference dumps embeddings only in the FOV and semantic scripts: other
    pipelines dump nothing."""
    if not isinstance(pipeline, FovPipeline):
        return
    batch = next(iter(val_loader), None)
    if batch is None:
        return
    surface, polar = pipeline.preprocess(batch, generator)
    s_emb, o_emb = pipeline._towers(params, surface, polar, False, None)
    s_emb, o_emb = s_emb.float(), o_emb.float()
    _, orient = paired_chord_distance(o_emb, s_emb)
    o_crop = _aligned_crop(o_emb, orient, s_emb.shape[2])
    b = s_emb.shape[0]
    vectors = torch.cat([s_emb.reshape(b, -1), o_crop.reshape(b, -1)]).cpu().numpy()
    d = pipeline.cfg.data
    s_img = denormalize_images(surface, d.img_mean, d.img_std).cpu().numpy()
    p_img = denormalize_images(polar, d.img_mean, d.img_std).cpu().numpy()
    pad_w = p_img.shape[2] - s_img.shape[2]
    if pad_w > 0:
        s_img = np.pad(s_img, ((0, 0), (0, 0), (0, pad_w), (0, 0)))
    label_imgs = np.clip(np.concatenate([s_img, p_img]), 0.0, 1.0)
    h, w = label_imgs.shape[1:3]
    if h != w:
        side = max(h, w)
        label_imgs = np.pad(label_imgs, ((0, 0), (0, side - h), (0, side - w), (0, 0)))
    writer.embedding("val_embedding", vectors, label_imgs[..., :3], step=epoch + 1)


def test_ranks(
    cfg: ExperimentConfig,
    pipeline: Pipeline,
    test_loader: Iterable,
    params: Optional[Params] = None,
    verbose: bool = True,
    checkpointer: Optional[Checkpointer] = None,
    writer: Optional[MetricWriter] = None,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Full-gallery retrieval eval: embed, rank, and report the reference
    metric suite. Returns the metrics and the per-query ranks they were
    computed from. ``params`` None restores the checkpointer's ``best``
    (``cfg.train.checkpoint_dir`` when no checkpointer is given). FOV ranks
    come from the fused match kernel, or with ``cfg.eval.fast_matmul``
    (``--fast-eval``) from the FFT sweep with bf16 frequency products; SAFA
    and baseline ranks from ``euclidean_ranks`` (f32, ``fast_matmul`` has no
    effect). The eval-time draws come from a generator seeded
    ``cfg.train.seed + 1``, as witw_tpu's (witw_tpu/train/loop.py:389-391).
    ``writer`` gets each metric as a text."""
    if params is None:
        if checkpointer is None:
            checkpointer = Checkpointer(cfg.train.checkpoint_dir)
        target = pipeline.init_state(torch.Generator().manual_seed(0))
        params = checkpointer.restore("best", target).params
    generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    s_emb, o_emb = embed_all(pipeline, params, test_loader, generator)
    if isinstance(pipeline, FovPipeline):
        evaluator = FovGalleryEvaluator(
            query_block=cfg.eval.query_block,
            gallery_chunk=cfg.eval.gallery_chunk,
            use_fused=not cfg.eval.fast_matmul,
            fast_matmul=cfg.eval.fast_matmul,
        )
        ranks = evaluator.ranks(o_emb, s_emb)
    else:
        ranks = euclidean_ranks(o_emb, s_emb)
    results = metrics_from_ranks(ranks)
    if verbose:
        print("Top  1: {:.2f}%".format(results["top_1"]))
        print("Top  5: {:.2f}%".format(results["top_5"]))
        print("Top 10: {:.2f}%".format(results["top_10"]))
        print("Top 1%: {:.2f}%".format(results["top_percent"]))
        print("Avg. Rank: {:.2f}".format(results["avg_rank"]))
        print("Med. Rank: {:.2f}".format(results["med_rank"]))
        print("Locations: {}".format(results["locations"]))
    if writer is not None:
        for key, val in results.items():
            writer.text(key, f"{key}: {val}")
    return results, ranks


def test(
    cfg: ExperimentConfig,
    pipeline: Pipeline,
    test_loader: Iterable,
    params: Optional[Params] = None,
    verbose: bool = True,
    checkpointer: Optional[Checkpointer] = None,
    writer: Optional[MetricWriter] = None,
) -> Dict[str, float]:
    """Full-gallery retrieval eval (:func:`test_ranks` without the ranks)."""
    return test_ranks(cfg, pipeline, test_loader, params, verbose, checkpointer, writer)[0]
