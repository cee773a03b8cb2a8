"""The FOV-DSM, SAFA and baseline pipelines: train, eval and embed steps
(port of witw_tpu/train/pipeline.py: FovPipeline, SafaPipeline,
BaselinePipeline, make_pipeline).

Raw uint8-scale batches go in; FOV crop, normalization and the polar
transform run on the pipeline's device, then the twin towers, then the
match: the fused correlation + chord-distance kernel for inference, and the
matmul correlation + ``chord_distance`` + DSM triplet loss for training.
Params are ``{"surface": state_dict, "overhead": state_dict}`` (float32, on
the pipeline's device), the layout ``models.convert_jax`` produces from
flax params; the towers run on them through ``torch.func.functional_call``.
A train step is Adam over the trainable params only (VGG blocks 1-3 frozen,
as ``fov_dsm_trainable_mask`` says); the frozen ones never get a gradient.

Random draws come from an explicit CPU ``torch.Generator`` per step, in
this order: the crop origins (with ``random_orientation``), the surface
tower's three dropout masks, the overhead tower's.

``SafaPipeline`` shares the preprocessing and the steps; its towers
(``models.safa.VggSafa``, no dropout) emit unit vectors, and its loss is the
same soft-margin triplet loss on the in-batch squared Euclidean distances.

``BaselinePipeline`` preprocesses otherwise: raw pixels, a synced random
rotation drawn from the step's generator, CVUSA rows repeated, optional
orientation-map channels, no polar transform and no normalization. Its
towers (``models.baseline.BaselineEncoder``) hold BatchNorm running
statistics as buffers in ``params[tower]`` beside the weights; a train step
updates them in place, the eval and embed steps read them, and Adam leaves
them out. Its loss is the exhaustive minibatch triplet loss.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.func import functional_call

from witw_tpu_torch.configs.base import ExperimentConfig
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.match.distance import chord_distance
from witw_tpu_torch.match.losses import (dsm_triplet_loss, exhaustive_minibatch_triplet_loss,
                                         pairwise_sq_distances)
from witw_tpu_torch.models.baseline import BaselineEncoder, baseline_trainable_mask
from witw_tpu_torch.models.fov_dsm import FovDsm, fov_dsm_trainable_mask
from witw_tpu_torch.models.safa import VggSafa, safa_trainable_mask
from witw_tpu_torch.ops.fov import fov_crop, random_fov_starts
from witw_tpu_torch.ops.fused_match import fused_chord_distance_nhwc
from witw_tpu_torch.ops import rotation
from witw_tpu_torch.ops.image import normalize_images, normalize_images_masked_bias, repeat_rows
from witw_tpu_torch.ops.orientation_maps import append_orientation_maps
from witw_tpu_torch.ops.polar import grid_tensors, polar_transform
from witw_tpu_torch.utils.device import require_cuda

Params = Dict[str, Dict[str, torch.Tensor]]
TOWERS = ("surface", "overhead")


@dataclasses.dataclass
class TrainState:
    """Step count, params, and the Adam optimizer that holds the trainable
    params and their moments (``optimizer.state_dict()`` is the optimizer
    state)."""

    step: int
    params: Params
    optimizer: torch.optim.Optimizer


class _TwinPipeline:
    """What the families share: params, Adam on the trainable names, the
    preprocessing (crop, normalization, polar transform; the baseline family
    gives its own) and the steps. A family gives ``_tower(circ)``,
    ``trainable_names`` and ``_forward_loss``."""

    kind = None

    def __init__(self, cfg: ExperimentConfig, device=None):
        if getattr(cfg.model, "kind", None) != self.kind:
            raise TypeError(f"{type(self).__name__} needs a model config of kind {self.kind!r}, "
                            f"got {type(cfg.model)}")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else require_cuda()
        self.surface_model = self._tower(False).to(self.device).eval()
        # The overhead tower convolves the polar pseudo-panorama, which wraps
        # horizontally -> circular padding (reference cvig_fov.py:407).
        self.overhead_model = self._tower(True).to(self.device).eval()

    def _tower(self, circ: bool) -> torch.nn.Module:
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> Params:
        """Fresh params from the flax init distributions, drawn from a CPU
        ``generator`` (surface tower first) and placed on the device."""
        params = {}
        for tower, circ in (("surface", False), ("overhead", True)):
            model = self._tower(circ)
            model.reset_parameters(generator)
            params[tower] = {k: v.to(self.device) for k, v in model.state_dict().items()}
        return params

    def trainable_names(self, tower_params: Dict[str, torch.Tensor]) -> List[str]:
        raise NotImplementedError

    def optimizer(self, params: Params) -> torch.optim.Adam:
        """Adam (lr, b1, b2, eps from ``cfg.train.optim``) over the trainable
        params, which it marks ``requires_grad``; the frozen ones are
        marked not to need a gradient."""
        o = self.cfg.train.optim
        trainable = []
        for tower in TOWERS:
            names = set(self.trainable_names(params[tower]))
            for name, p in params[tower].items():
                p.requires_grad_(name in names)
                if name in names:
                    trainable.append(p)
        return torch.optim.Adam(trainable, lr=o.learning_rate, betas=(o.b1, o.b2), eps=o.eps)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Fresh params (:meth:`init`) and a fresh optimizer, at step 0."""
        params = self.init(generator)
        return TrainState(step=0, params=params, optimizer=self.optimizer(params))

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def on_device(self, device) -> "_TwinPipeline":
        """This pipeline on ``device`` (itself when already there): the same
        config and towers, for a data shard's embeds there. The towers run
        through ``functional_call`` on params the caller puts on
        ``device``."""
        device = torch.device(device)
        if device == self.device:
            return self
        other = copy.copy(self)
        other.device = device
        return other

    def draw(self, generator: Optional[torch.Generator], b: int) -> Optional[torch.Tensor]:
        """The per-sample random draw :meth:`preprocess` makes for a batch of
        ``b`` (on the generator's device), or None when it makes none: the
        FOV crop origins with ``random_orientation`` on a panorama dataset,
        from ``generator`` (a CPU generator seeded 0 when None)."""
        d = self.cfg.data
        if not (d.dataset.panorama and d.random_orientation):
            return None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return random_fov_starts(generator, b, d.surface_width_max)

    def preprocess(
        self, batch, generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw {"surface": [B, H, W_max, C], "overhead": [B, S, S, C]} ->
        (normalized surface crop [B, H, sw, C], normalized polar
        [B, H, W_max, C]). With ``random_orientation`` the crop origins are
        ``draws`` when the caller made them, else :meth:`draw`'s from
        ``generator``."""
        d = self.cfg.data
        surface = self._input(batch["surface"])
        overhead = self._input(batch["overhead"])
        if d.dataset.panorama:
            sw = d.surface_width
            if d.random_orientation:
                if draws is None:
                    draws = self.draw(generator, surface.shape[0])
                starts = draws.to(self.device)
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

    def _towers(self, params: Params, surface, polar, train: bool,
                generator: Optional[torch.Generator]):
        s_emb = functional_call(self.surface_model, params["surface"], (surface,),
                                {"train": train, "generator": generator}, strict=True)
        o_emb = functional_call(self.overhead_model, params["overhead"], (polar,),
                                {"train": train, "generator": generator}, strict=True)
        return s_emb, o_emb

    def train_step(self, state: TrainState, batch,
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One Adam step on ``batch`` (train-mode dropout); updates ``state``
        in place and returns it with {"loss": the step's loss}."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = self._forward_loss(state.params, batch, generator, train=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        loss, _ = self._forward_loss(state.params, batch, generator, train=False)
        return {"loss": loss}

    @torch.no_grad()
    def embed_step(
        self, params: Params, batch, generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed a batch: (surface embeddings, overhead embeddings), float32:
        FOV maps [B, h, sw', 16] and [B, h, W', 16] NHWC, SAFA vectors
        [B, M·512], baseline vectors [B, 1536]. ``draws``: the batch's
        random draw (:meth:`draw`), made by the caller, in place of one from
        ``generator``."""
        surface, polar = self.preprocess(batch, generator, draws)
        return self._towers(params, surface, polar, False, None)


class FovPipeline(_TwinPipeline):
    """cvig_fov / cvig_semantic pipeline (reference cvig_fov.py:385-575) on
    ``device``: the CUDA device when None (RuntimeError without one); the
    CPU only when asked for."""

    kind = "fov_dsm"

    def _tower(self, circ: bool) -> FovDsm:
        return FovDsm(self.cfg.model, circ_padding=circ)

    def trainable_names(self, tower_params: Dict[str, torch.Tensor]) -> List[str]:
        return fov_dsm_trainable_mask(tower_params, self.cfg.model)

    def _forward_loss(self, params: Params, batch, generator: Optional[torch.Generator],
                      train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Preprocess, both towers, matmul correlation, chord distance, DSM
        triplet loss (with ``batch["valid"]``, when given, masking padded
        rows)."""
        surface, polar = self.preprocess(batch, generator)
        s_emb, o_emb = self._towers(params, surface, polar, train, generator)
        corr = circular_correlation(o_emb, s_emb, method="matmul")
        distance, orientation = chord_distance(o_emb, s_emb, corr)
        valid = batch.get("valid")
        if valid is not None:
            valid = torch.as_tensor(valid, device=self.device)
        loss = dsm_triplet_loss(distance, alpha=self.cfg.match.alpha, valid=valid)
        return loss, {"distance": distance, "orientation": orientation}

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


class SafaPipeline(_TwinPipeline):
    """VGG16+SAFA global-embedding pipeline on ``device`` (the CUDA device
    when None): FOV-style preprocessing, twin SAFA towers emitting unit
    vectors, the soft-margin triplet loss on the in-batch squared Euclidean
    distance matrix; plain Euclidean retrieval eval
    (``evaluation.gallery.euclidean_ranks``)."""

    kind = "vgg_safa"

    def _tower(self, circ: bool) -> VggSafa:
        d = self.cfg.data
        width = d.surface_width_max if circ else d.surface_width
        return VggSafa(self.cfg.model, (d.surface_height, width), circ_padding=circ)

    def trainable_names(self, tower_params: Dict[str, torch.Tensor]) -> List[str]:
        return safa_trainable_mask(tower_params, self.cfg.model)

    def _forward_loss(self, params: Params, batch, generator: Optional[torch.Generator],
                      train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Preprocess, both towers, squared Euclidean distances [B_o, B_s],
        DSM triplet loss (``batch["valid"]`` masking padded rows)."""
        surface, polar = self.preprocess(batch, generator)
        s_emb, o_emb = self._towers(params, surface, polar, train, generator)
        d2 = pairwise_sq_distances(o_emb, s_emb)
        valid = batch.get("valid")
        if valid is not None:
            valid = torch.as_tensor(valid, device=self.device)
        loss = dsm_triplet_loss(d2, alpha=self.cfg.match.alpha, valid=valid)
        return loss, {"distance": d2}


class BaselinePipeline(_TwinPipeline):
    """cvig_baseline pipeline (reference cvig_baseline.py:318-402) on
    ``device`` (the CUDA device when None): synced rotation, twin
    ``BaselineEncoder`` towers with BatchNorm, the exhaustive minibatch
    triplet loss; Euclidean retrieval eval (``euclidean_ranks``)."""

    kind = "baseline"

    def __init__(self, cfg: ExperimentConfig, device=None):
        super().__init__(cfg, device)
        # CVUSA surfaces get their rows repeated x2 on the device (reference
        # cvig_baseline.py:216-218); WITW surfaces arrive 500 x 500.
        self.repeat_surface_rows = cfg.data.dataset.name == "cvusa"

    def _tower(self, circ: bool) -> BaselineEncoder:
        return BaselineEncoder(self.cfg.model)

    def trainable_names(self, tower_params: Dict[str, torch.Tensor]) -> List[str]:
        return baseline_trainable_mask(tower_params)

    def draw(self, generator: Optional[torch.Generator], b: int) -> torch.Tensor:
        """The synced rotation's angles for a batch of ``b``
        (``rotation.rotation_degrees``), from ``generator`` (a CPU generator
        seeded 0 when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return rotation.rotation_degrees(generator, b)

    def preprocess(
        self, batch, generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw {"surface": [B, H, W, C], "overhead": [B, S, S, C]} -> the
        towers' raw-pixel inputs: a synced rotation per sample (``draws``
        when the caller made them, else :meth:`draw`'s from ``generator``;
        the reference rotates at train and eval time,
        cvig_baseline.py:324-328,410-414), then CVUSA rows repeated, then the
        orientation maps when the config asks for them."""
        surface = self._input(batch["surface"])
        overhead = self._input(batch["overhead"])
        if draws is None:
            draws = self.draw(generator, surface.shape[0])
        surface, overhead = rotation.synced_rotation(
            None, surface, overhead, panorama=self.cfg.data.dataset.panorama, draw=draws)
        if self.repeat_surface_rows:
            surface = repeat_rows(surface, 2)
        if self.cfg.model.orientation_maps:
            surface, overhead = append_orientation_maps(surface, overhead)
        return surface, overhead

    def _towers(self, params: Params, surface, overhead, train: bool,
                generator: Optional[torch.Generator], valid=None):
        kwargs = {"train": train, "valid": valid}
        s_emb = functional_call(self.surface_model, params["surface"], (surface,), kwargs,
                                strict=True)
        o_emb = functional_call(self.overhead_model, params["overhead"], (overhead,), kwargs,
                                strict=True)
        return s_emb, o_emb

    def _forward_loss(self, params: Params, batch, generator: Optional[torch.Generator],
                      train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Preprocess, both towers (train mode: BatchNorm on the batch's
        statistics over ``batch["valid"]`` rows, the running buffers in
        ``params`` updated), exhaustive minibatch triplet loss."""
        surface, overhead = self.preprocess(batch, generator)
        valid = batch.get("valid")
        if valid is not None:
            valid = torch.as_tensor(valid, device=self.device)
        s_emb, o_emb = self._towers(params, surface, overhead, train, None, valid)
        m = self.cfg.match
        loss = exhaustive_minibatch_triplet_loss(s_emb, o_emb, soft_margin=m.soft_margin,
                                                 alpha=m.alpha, margin=m.margin, valid=valid)
        return loss, {"surface": s_emb, "overhead": o_emb}


Pipeline = Union[FovPipeline, SafaPipeline, BaselinePipeline]


def make_pipeline(cfg: ExperimentConfig, device=None) -> Pipeline:
    """The pipeline of ``cfg.model``'s family on ``device`` (the card when
    None)."""
    kind = getattr(cfg.model, "kind", None)
    if kind == "fov_dsm":
        return FovPipeline(cfg, device)
    if kind == "vgg_safa":
        return SafaPipeline(cfg, device)
    if kind == "baseline":
        return BaselinePipeline(cfg, device)
    raise TypeError(f"unknown model config: {type(cfg.model)}")
