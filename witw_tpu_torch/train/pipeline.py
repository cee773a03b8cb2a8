"""The inference half of the FOV-DSM pipeline (port of
witw_tpu/train/pipeline.py:FovPipeline).

Raw uint8-scale batches go in; FOV crop, normalization and the polar
transform run on the pipeline's device, then the twin towers, then the
fused correlation + chord-distance match. Params are
``{"surface": state_dict, "overhead": state_dict}`` (float32, on the
pipeline's device), the layout ``models.convert_jax`` produces from flax
params; the towers run on them through ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from witw_tpu.configs.base import ExperimentConfig, FovDsmModelConfig
from witw_tpu_torch.models.fov_dsm import FovDsm
from witw_tpu_torch.ops.fov import fov_crop, random_fov_starts
from witw_tpu_torch.ops.fused_match import fused_chord_distance_nhwc
from witw_tpu_torch.ops.image import normalize_images, normalize_images_masked_bias
from witw_tpu_torch.ops.polar import grid_tensors, polar_transform

Params = Dict[str, Dict[str, torch.Tensor]]


class FovPipeline:
    """cvig_fov / cvig_semantic inference pipeline (reference
    cvig_fov.py:385-575) on ``device`` (default CPU)."""

    def __init__(self, cfg: ExperimentConfig, device=None):
        if not isinstance(cfg.model, FovDsmModelConfig):
            raise TypeError(f"FovPipeline needs a FovDsmModelConfig, got {type(cfg.model)}")
        self.cfg = cfg
        self.device = torch.device(device if device is not None else "cpu")
        self.surface_model = FovDsm(cfg.model, circ_padding=False).to(self.device).eval()
        # The overhead tower convolves the polar pseudo-panorama, which wraps
        # horizontally -> circular padding (reference cvig_fov.py:407).
        self.overhead_model = FovDsm(cfg.model, circ_padding=True).to(self.device).eval()

    def init(self, generator: torch.Generator) -> Params:
        """Fresh params from the flax init distributions, drawn from a CPU
        ``generator`` (surface tower first) and placed on the device."""
        params = {}
        for tower, circ in (("surface", False), ("overhead", True)):
            model = FovDsm(self.cfg.model, circ_padding=circ)
            model.reset_parameters(generator)
            params[tower] = {k: v.to(self.device) for k, v in model.state_dict().items()}
        return params

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def preprocess(
        self, batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw {"surface": [B, H, W_max, C], "overhead": [B, S, S, C]} ->
        (normalized surface crop [B, H, sw, C], normalized polar
        [B, H, W_max, C]). With ``random_orientation`` the crop origins come
        from ``generator`` (a CPU generator seeded 0 when None)."""
        d = self.cfg.data
        surface = self._input(batch["surface"])
        overhead = self._input(batch["overhead"])
        if d.dataset.panorama:
            sw = d.surface_width
            if d.random_orientation:
                if generator is None:
                    generator = torch.Generator().manual_seed(0)
                starts = random_fov_starts(
                    generator, surface.shape[0], d.surface_width_max, self.device
                )
            else:
                starts = torch.zeros(surface.shape[0], dtype=torch.int64, device=self.device)
            if sw < d.surface_width_max:
                surface = fov_crop(surface, starts, sw)
            elif d.random_orientation:
                # Full panorama: the crop degenerates to a circular roll.
                surface = fov_crop(surface, starts, d.surface_width_max)
        scale_ch = 3 if d.dataset.semantic else None
        surface = normalize_images(surface, d.img_mean, d.img_std, scale_ch)
        # Polar-transform the raw tile with a bf16 gather, then normalize with
        # the bias masked at the exact-boundary samples (witw_tpu's order,
        # equal to the reference's normalize-then-polar).
        polar = polar_transform(
            overhead, d.surface_height, d.surface_width_max, gather_dtype=torch.bfloat16
        )
        _, _, wsum = grid_tensors(
            d.surface_height, d.surface_width_max, overhead.shape[1], self.device
        )
        polar = normalize_images_masked_bias(polar, d.img_mean, d.img_std, wsum, scale_ch)
        return surface, polar

    @torch.no_grad()
    def embed_step(
        self, params: Params, batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed a batch: (surface maps [B, h, sw', 16], overhead maps
        [B, h, W', 16]), float32 NHWC."""
        surface, polar = self.preprocess(batch, generator)
        s_emb = functional_call(self.surface_model, params["surface"], (surface,), strict=True)
        o_emb = functional_call(self.overhead_model, params["overhead"], (polar,), strict=True)
        return s_emb, o_emb

    @torch.no_grad()
    def forward_distance(
        self, params: Params, batch, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Raw batch -> orientation-aligned chord-distance matrix [Bo, Bs]
        (the embed+match forward of witw_tpu's ``__graft_entry__.entry``).
        The match runs in the fused CUDA kernel on a GPU and in its plain
        version on the CPU."""
        s_emb, o_emb = self.embed_step(params, batch, generator)
        d, _ = fused_chord_distance_nhwc(o_emb, s_emb)
        return d
