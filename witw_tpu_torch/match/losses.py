"""Metric-learning losses (port of witw_tpu/match/losses.py:
``dsm_triplet_loss``, reference model/cvig_fov.py:366-382;
``pairwise_sq_distances``, the SAFA and baseline families' in-batch distance
matrix; ``exhaustive_minibatch_triplet_loss``, the baseline family's,
reference model/cvig_baseline.py:286-315)."""

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


def exhaustive_minibatch_triplet_loss(embed1: torch.Tensor, embed2: torch.Tensor,
                                      soft_margin: bool = False, alpha: float = 10.0,
                                      margin: float = 1.0,
                                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every (anchor, positive, negative) triplet of a minibatch of paired
    embeddings on squared Euclidean distances (arXiv:1608.00161 sec. 5.3).
    With D2 the pairwise matrix and d_i = D2[i, i], the reference's two roll
    orderings sum f(d_i - D2[i, j]) + f(d_i - D2[j, i]) over i != j,
    normalized by 2B(B-1); f is ``softplus(alpha x)`` with ``soft_margin``
    (stable where log(1 + exp(x)) overflows), else ``relu(x + margin)``.
    ``valid``: optional bool [B]; the pair terms and the normalizer restrict
    to valid x valid pairs, as :func:`dsm_triplet_loss`."""
    b = embed1.shape[0]
    d2 = pairwise_sq_distances(embed1, embed2)
    diag = torch.diagonal(d2)
    delta_rows = diag[:, None] - d2
    delta_cols = diag[:, None] - d2.T
    if soft_margin:
        f_rows = F.softplus(alpha * delta_rows)
        f_cols = F.softplus(alpha * delta_cols)
    else:
        f_rows = F.relu(delta_rows + margin)
        f_cols = F.relu(delta_cols + margin)
    mask = 1.0 - torch.eye(b, device=d2.device)
    if valid is None:
        return ((f_rows + f_cols) * mask).sum() / (2.0 * b * (b - 1))
    v = torch.as_tensor(valid, device=d2.device).to(torch.float32)
    mask = mask * (v[:, None] * v[None, :])
    nv = v.sum()
    return ((f_rows + f_cols) * mask).sum() / torch.clamp(2.0 * nv * (nv - 1.0), min=1.0)
