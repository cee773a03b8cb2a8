"""Distances, ranks and the rank check, in float64.

FOV-DSM (cvig_fov.py:297-363): the circular correlation of a gallery map o
[h, W, c] with a query map s [h, sw, c] over the W shifts,

    corr[i] = sum_{h, k < sw, c} o[h, (i + k) mod W, c] * s[h, k, c],

the orientation i* = argmax corr, and the chord distance
2 (1 - corr[i*] / (|o's window at i*| |s|)). SAFA: the squared Euclidean
distance of the unit embeddings. The rank of a query is 1 + the number of
other gallery items at or under its true match's distance.
"""

from __future__ import annotations

import numpy as np
import torch


def chord_distances(gallery: torch.Tensor, queries: torch.Tensor, block: int = 256) -> torch.Tensor:
    """[G, h, W, c] gallery maps against [Q, h, sw, c] queries -> [G, Q]."""
    g_all = gallery.to(torch.float64)
    q = queries.to(torch.float64)
    n_g, h, w, c = g_all.shape
    n_q, _, sw, _ = q.shape
    idx = (torch.arange(w, device=q.device)[:, None] + torch.arange(sw, device=q.device)) % w
    q_flat = q.permute(0, 2, 1, 3).reshape(n_q, sw * h * c)  # [Q, (k, h, c)]
    q_norm = q_flat.norm(dim=1)
    out = []
    for b0 in range(0, n_g, block):
        g = g_all[b0:b0 + block].permute(0, 2, 1, 3)  # [Gb, W, h, c]
        windows = g[:, idx].reshape(g.shape[0], w, sw * h * c)  # [Gb, shift, (k, h, c)]
        corr = windows @ q_flat.T  # [Gb, W, Q]
        best, orient = corr.max(dim=1)  # [Gb, Q]
        win_sq = (windows * windows).sum(dim=2)  # [Gb, W]
        crop = win_sq.gather(1, orient).sqrt()
        out.append(2.0 * (1.0 - best / (crop * q_norm[None, :]).clamp_min(1e-300)))
    return torch.cat(out)


def euclidean_sq_distances(gallery: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """[G, D] against [Q, D] -> [G, Q] squared Euclidean distances."""
    g = gallery.to(torch.float64)
    q = queries.to(torch.float64)
    return ((g * g).sum(1)[:, None] + (q * q).sum(1)[None, :] - 2.0 * g @ q.T).clamp_min(0.0)


def ranks(distances: torch.Tensor, true_match: torch.Tensor) -> np.ndarray:
    """Rank of each query's true match (ties count): 1 + the other gallery
    items at or under its distance. distances [G, Q]; true_match [Q]."""
    d = distances
    cols = torch.arange(d.shape[1], device=d.device)
    d_true = d[true_match, cols]
    le = d <= d_true[None, :]
    le[true_match, cols] = False
    return (le.sum(0) + 1).cpu().numpy()


def rank_gap(distances: torch.Tensor, true_match: torch.Tensor, program_ranks) -> float:
    """The widest error in distance that the program's ranks imply.

    For query q let delta_g = D[g, q] - D[tm(q), q] over the other gallery
    items, sorted s_1 <= ... <= s_{G-1}, and k = rank - 1 the items the
    program counted. If each distance the program compared may be off by t,
    it must count every item with delta <= -t and may count those with
    delta <= t; the least such t is max(0, s_k, -s_{k+1}). Returns the
    largest over the queries (0 where every rank is exact)."""
    d = distances.to(torch.float64)
    n_g, n_q = d.shape
    cols = torch.arange(n_q, device=d.device)
    delta = d - d[true_match, cols][None, :]
    delta[true_match, cols] = float("inf")  # the true match sorts last, never counted
    s = delta.sort(dim=0).values[: n_g - 1]  # [G-1, Q]
    k = torch.as_tensor(np.asarray(program_ranks), dtype=torch.int64, device=d.device) - 1
    if bool((k < 0).any()) or bool((k > n_g - 1).any()):
        return float("inf")
    neg_inf = torch.full((n_q,), float("-inf"), dtype=torch.float64, device=d.device)
    low = torch.where(k >= 1, s.gather(0, (k - 1).clamp_min(0)[None])[0], neg_inf)
    high = torch.where(k <= n_g - 2, -s.gather(0, k.clamp_max(n_g - 2)[None])[0], neg_inf)
    return float(torch.stack([low, high, torch.zeros_like(low)]).amax(dim=0).max())


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-row |got - want| / |want| (rows: the first axis)."""
    g = got.reshape(got.shape[0], -1).to(torch.float64)
    w = want.reshape(want.shape[0], -1).to(torch.float64)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-300)).max())
