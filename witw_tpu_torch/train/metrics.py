"""Metric writer: TensorBoard events and a JSONL log (port of
witw_tpu/train/metrics.py).

TensorBoard events go through tensorboardX or torch.utils.tensorboard,
whichever imports first (witw_tpu's order); where neither does, a warning
says so and only the JSONL stream is written. The JSONL records are
witw_tpu's, field for field: ``{"t", "tag", "value", "step"}`` for a
scalar, ``{"t", "tag", "text", "step"}`` for a text and ``{"t", "tag",
"embedding_shape", "step"}`` for an embedding dump.
"""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np
import torch


def _summary_writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter  # type: ignore

        return SummaryWriter(logdir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except ImportError:
        warnings.warn(
            "Neither tensorboardX nor torch.utils.tensorboard is available; "
            "TensorBoard event files will NOT be written (JSONL metrics only).",
            stacklevel=3,
        )
        return None


class MetricWriter:
    def __init__(self, logdir: str, jsonl: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._tb = _summary_writer(logdir)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a") if jsonl else None

    def _record(self, **fields) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"t": time.time(), **fields}) + "\n")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._record(tag=tag, value=float(value), step=step)

    def text(self, tag: str, value: str, step: int = 0) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, value, step)
        self._record(tag=tag, text=value, step=step)

    def embedding(self, tag: str, vectors, label_imgs=None, step: int = 0) -> None:
        """TensorBoard projector dump of embedding vectors [N, D] with
        optional label images [N, H, W, C] in [0, 1] (NHWC, converted to the
        NCHW the projector expects; reference cvig_fov.py:475-479)."""
        vectors = np.asarray(vectors)
        if self._tb is not None:
            label_img = None
            if label_imgs is not None:
                label_img = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(np.asarray(label_imgs, np.float32),
                                                      (0, 3, 1, 2))))
            self._tb.add_embedding(vectors, label_img=label_img, tag=tag, global_step=step)
        self._record(tag=tag, embedding_shape=list(vectors.shape), step=step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
