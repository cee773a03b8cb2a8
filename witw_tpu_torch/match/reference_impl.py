"""Materialized alignment + distance, the reference's crop-then-normalize
pipeline (port of witw_tpu/match/reference_impl.py; reference
model/cvig_fov.py:318-363). The correctness oracle for the streaming form
of :mod:`witw_tpu_torch.match.distance` and the fused match kernel, and the
crop of the embedding dump; it materializes the O(Bo Bs h sw c) tensor that
those avoid.
"""

from __future__ import annotations

import torch

from witw_tpu_torch.utils.device import full_precision_matmul


def crop_overhead_materialized(
    overhead_embed: torch.Tensor, orientation: torch.Tensor, surface_width: int
) -> torch.Tensor:
    """Roll every overhead map to each query's estimated orientation and crop
    to the surface width (reference cvig_fov.py:318-343).

    overhead_embed: [Bo, h, W, c]; orientation: [Bo, Bs].
    Returns [Bo, Bs, h, surface_width, c].
    """
    bo, h, w, c = overhead_embed.shape
    bs = orientation.shape[1]
    ar = torch.arange(surface_width, device=overhead_embed.device)
    cols = (ar[None, None, :] + orientation.to(overhead_embed.device, torch.int64)[:, :, None]) % w
    tiled = overhead_embed[:, None].expand(bo, bs, h, w, c)
    index = cols[:, :, None, :, None].expand(bo, bs, h, surface_width, c)
    return torch.gather(tiled, 3, index)


def chord_distance_materialized(
    overhead_cropped: torch.Tensor, surface_embed: torch.Tensor
) -> torch.Tensor:
    """L2-normalize both flattened embeddings, chord distance = 2 (1 - cos)
    (reference cvig_fov.py:346-363), the product in f32 with TF32 off.

    overhead_cropped: [Bo, Bs, h, sw, c]; surface_embed: [Bs, h, sw, c].
    Returns [Bo, Bs].
    """
    bo, bs = overhead_cropped.shape[:2]
    o = overhead_cropped.to(torch.float32).reshape(bo, bs, -1)
    o = o / torch.linalg.vector_norm(o, dim=-1, keepdim=True)
    s = surface_embed.to(torch.float32).reshape(bs, -1)
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    with full_precision_matmul():
        cos = torch.einsum("abd,bd->ab", o, s)
    return 2.0 * (1.0 - cos)
