"""The public names of witw_tpu_torch.train, as witw_tpu.train exports them."""

from witw_tpu_torch.train.pipeline import (
    TrainState,
    FovPipeline,
    BaselinePipeline,
    make_pipeline,
)
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.metrics import MetricWriter

__all__ = [
    "TrainState",
    "FovPipeline",
    "BaselinePipeline",
    "make_pipeline",
    "Checkpointer",
    "MetricWriter",
]
