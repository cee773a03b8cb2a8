"""Metric-learning losses (port of witw_tpu/match/losses.py:
``dsm_triplet_loss``, reference model/cvig_fov.py:366-382, and
``pairwise_sq_distances``, the SAFA family's in-batch distance matrix)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dsm_triplet_loss(distances: torch.Tensor, alpha: float = 10.0,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-margin triplet loss on a [B, B] distance matrix whose diagonal
    holds the matching pairs: both query->gallery and gallery->query
    directions, normalized by 2B(B-1); the diagonal contributes the same
    constant 2B log 2 as the reference. ``softplus`` stays finite where
    log(1 + exp(x)) overflows.

    ``valid``: optional bool [B] marking real rows in a padded batch; the pair
    sums and the normalizer restrict to valid x valid pairs, which makes the
    result exactly the unpadded batch's loss."""
    matching = torch.diagonal(distances)
    d_s2o = matching[None, :] - distances
    d_o2s = matching[:, None] - distances
    if valid is None:
        b = distances.shape[0]
        loss = F.softplus(alpha * d_s2o).sum() + F.softplus(alpha * d_o2s).sum()
        return loss / (2.0 * b * (b - 1))
    v = torch.as_tensor(valid, device=distances.device).to(torch.float32)
    pair = v[:, None] * v[None, :]
    nv = v.sum()
    loss = (F.softplus(alpha * d_s2o) * pair).sum() + (F.softplus(alpha * d_o2s) * pair).sum()
    return loss / torch.clamp(2.0 * nv * (nv - 1.0), min=1.0)


def pairwise_sq_distances(embed1: torch.Tensor, embed2: torch.Tensor) -> torch.Tensor:
    """D2[i, j] = ||embed1[i] - embed2[j]||^2 in f32 through one GEMM,
    clamped at 0."""
    e1 = embed1.to(torch.float32)
    e2 = embed2.to(torch.float32)
    sq1 = (e1 * e1).sum(dim=-1)
    sq2 = (e2 * e2).sum(dim=-1)
    d2 = sq1[:, None] + sq2[None, :] - 2.0 * (e1 @ e2.T)
    return d2.clamp_min(0.0)
