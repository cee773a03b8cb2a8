"""Embedding and full-gallery test (port of witw_tpu/train/loop.py:embed_all
and test; the reference's test(), cvig_fov.py:490-575)."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from witw_tpu.configs.base import ExperimentConfig
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, metrics_from_ranks
from witw_tpu_torch.train.pipeline import FovPipeline, Params


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
