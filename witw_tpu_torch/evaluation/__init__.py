"""The public names of witw_tpu_torch.evaluation, as witw_tpu.evaluation exports them."""

from witw_tpu_torch.evaluation.gallery import (
    FovGalleryEvaluator,
    euclidean_ranks,
    metrics_from_ranks,
)
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex

__all__ = [
    "FovGalleryEvaluator",
    "euclidean_ranks",
    "metrics_from_ranks",
    "GalleryIndex",
    "VectorIndex",
]
