"""Sample4Geo's encoder (Deuser, Habel, Oswald, Sample4Geo: Hard Negative
Sampling For Cross-View Geo-Localisation, ICCV 2023): one ConvNeXt
(``models.backbones.convnext``) with shared weights embeds the ground
panorama and the aerial tile alike; the embedding is the pooled, LayerNormed
last stage, L2-normalized. ``logit_scale`` is the InfoNCE loss's learnable
temperature (the train step reads it from the params).

Parameter names are Sample4Geo's checkpoint's: ``model.<timm convnext
name>`` and ``logit_scale``. The port's own family: witw_tpu has none.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from witw_tpu_torch.configs.base import Sample4GeoModelConfig
from witw_tpu_torch.models.backbones.convnext import ConvNeXt


class Sample4Geo(nn.Module):
    """NCHW image (any size whose stem output is at least 8 x 8) -> [B,
    dims[-1]] f32 unit vectors."""

    def __init__(self, cfg: Sample4GeoModelConfig):
        super().__init__()
        self.model = ConvNeXt(cfg.depths, cfg.dims, cfg.in_channels, cfg.kernel_size,
                              cfg.mlp_ratio, cfg.ln_eps, getattr(torch, cfg.compute_dtype))
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.logit_scale_init = cfg.logit_scale_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.model.reset_parameters(generator)
        with torch.no_grad():
            self.logit_scale.fill_(self.logit_scale_init)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` and ``generator`` are the twin pipelines' arguments; this
        encoder draws nothing."""
        return F.normalize(self.model(x), dim=-1)


def symmetric_infonce(s_emb: torch.Tensor, o_emb: torch.Tensor, logit_scale: torch.Tensor,
                      label_smoothing: float) -> torch.Tensor:
    """Sample4Geo's loss on unit embeddings: cross-entropy with label
    smoothing over ``exp(logit_scale) * s_emb @ o_emb.T`` (row i's positive
    is column i), ground to aerial and aerial to ground, averaged."""
    logits = logit_scale.exp() * s_emb @ o_emb.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
                  + F.cross_entropy(logits.T, labels, label_smoothing=label_smoothing))
