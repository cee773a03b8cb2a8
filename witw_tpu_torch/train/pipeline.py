"""The FOV-DSM, SAFA, baseline and Sample4Geo pipelines: train, eval and
embed steps (port of witw_tpu/train/pipeline.py: FovPipeline, SafaPipeline,
BaselinePipeline, make_pipeline; Sample4GeoPipeline is the port's own).

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

``Sample4GeoPipeline`` runs one ConvNeXt encoder, its weights held once,
on both views as they come (normalized, in bf16 channels_last; no crop,
polar map or draw), and the symmetric InfoNCE loss at the params' learnable
logit scale.

A ``parallel.GlobalBatch`` (``train.loop.device_prefetch`` with a mesh)
takes the data-parallel step of any family: the draws made for the global
batch, the towers per data shard on its device, the embeddings gathered
with autograd into the global batch, whose in-batch loss is the one a
single device computes (not a mean of per-shard losses), and across
processes one sum of the gradients before the Adam step. The baseline's
shards run in lockstep so that BatchNorm normalizes with the global
batch's statistics.
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
from witw_tpu_torch.models.backbones.vgg16 import DropoutMasks
from witw_tpu_torch.models.baseline import (BaselineEncoder, baseline_trainable_mask,
                                            forward_sharded)
from witw_tpu_torch.models.fov_dsm import FovDsm, fov_dsm_trainable_mask
from witw_tpu_torch.models.safa import VggSafa, safa_trainable_mask
from witw_tpu_torch.models.sample4geo import Sample4Geo, symmetric_infonce
from witw_tpu_torch.ops.fov import fov_crop, random_fov_starts
from witw_tpu_torch.ops.fused_match import fused_chord_distance_nhwc
from witw_tpu_torch.ops import rotation
from witw_tpu_torch.ops.image import normalize_images, normalize_images_masked_bias, repeat_rows
from witw_tpu_torch.ops.orientation_maps import append_orientation_maps
from witw_tpu_torch.ops.polar import grid_tensors, polar_transform
from witw_tpu_torch.parallel.collectives import (all_reduce_sum, gather_rows, process_count,
                                                 sum_across_processes)
from witw_tpu_torch.parallel.mesh import GlobalBatch
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.profiling import span, spanned

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

    def trainable_params(self) -> Params:
        return self.params


class _TwinPipeline:
    """What the families share: params, Adam on the trainable names, the
    preprocessing (crop, normalization, polar transform; the baseline family
    gives its own) and the steps, on one device or data-parallel over a
    mesh's shards. A family gives ``_tower(circ)``, ``trainable_names`` and
    ``_loss(s_emb, o_emb, valid, params)``."""

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
        trainable = {}  # by id: a tensor both towers share is stepped once
        for tower in TOWERS:
            names = set(self.trainable_names(params[tower]))
            for name, p in params[tower].items():
                p.requires_grad_(name in names)
                if name in names:
                    trainable.setdefault(id(p), p)
        return torch.optim.Adam(list(trainable.values()), lr=o.learning_rate, betas=(o.b1, o.b2),
                                eps=o.eps)

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
        with span("draw"):
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
        with span("tower.surface"):
            s_emb = functional_call(self.surface_model, params["surface"], (surface,),
                                    {"train": train, "generator": generator}, strict=True)
        with span("tower.overhead"):
            o_emb = functional_call(self.overhead_model, params["overhead"], (polar,),
                                    {"train": train, "generator": generator}, strict=True)
        return s_emb, o_emb

    @spanned("train.step")
    def train_step(self, state: TrainState, batch,
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One Adam step on ``batch`` (train-mode dropout); updates ``state``
        in place and returns it with {"loss": the step's loss}.

        ``batch`` may be a ``parallel.GlobalBatch`` (``loop.device_prefetch``
        with a mesh): the data-parallel step (:meth:`sharded_forward_loss`),
        its loss the global batch's, its gradients summed once over the
        processes before the one Adam step, so every process steps alike and
        the step equals one device's on the whole batch."""
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss = self._batch_loss(state.params, batch, generator, train=True)
        with span("train.backward"):
            loss.backward()
            if isinstance(batch, GlobalBatch):
                _sum_grads_across_processes(state.optimizer)
        with span("train.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The loss of ``batch`` in eval mode (a ``GlobalBatch`` too)."""
        return {"loss": self._batch_loss(state.params, batch, generator, train=False)}

    def _batch_loss(self, params: Params, batch, generator, train: bool) -> torch.Tensor:
        if isinstance(batch, GlobalBatch):
            return self.sharded_forward_loss(params, batch, generator, train)[0]
        return self._forward_loss(params, batch, generator, train)[0]

    def _valid(self, batch) -> Optional[torch.Tensor]:
        valid = batch.get("valid")
        return None if valid is None else torch.as_tensor(valid, device=self.device)

    def _forward_loss(self, params: Params, batch, generator: Optional[torch.Generator],
                      train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One device: the batch's embeddings (:meth:`_embed`), then the
        family's loss over ``batch["valid"]``'s rows (all when absent)."""
        s_emb, o_emb = self._embed(params, batch, generator, train)
        return self._loss(s_emb, o_emb, self._valid(batch), params)

    def _embed(self, params: Params, batch, generator: Optional[torch.Generator],
               train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("preprocess", stretch=True):
            surface, polar = self.preprocess(batch, generator)
        return self._towers(params, surface, polar, train, generator)

    def _draw_masks(self, generator: torch.Generator, b: int) -> List[torch.Tensor]:
        """Both towers' train-mode dropout masks for a batch of ``b``, in
        the order a train step draws them (surface tower first)."""
        return (self.surface_model.vgg.draw_masks(generator, b)
                + self.overhead_model.vgg.draw_masks(generator, b))

    def sharded_forward_loss(self, params: Params, batch: GlobalBatch,
                             generator: Optional[torch.Generator],
                             train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The data-parallel forward: the global batch's random draws (crop
        origins or rotations, then the dropout masks) made on ``generator``
        for its real rows, in a one-device step's order, and spread over the
        rows (padded rows get zeros, all-kept masks); each data shard's
        towers on its device, on a differentiable copy of ``params`` there;
        the embeddings gathered over the shards and processes with autograd
        (``collectives.gather_rows``) into the global batch on the
        pipeline's device; the family's loss over the global valid rows.
        The loss equals one device's on the real rows, whatever the mesh."""
        valid = batch.valid
        n_real = int(valid.sum())
        draws = self.draw(generator, n_real)
        if draws is not None:
            draws = spread_draws(draws, valid, 0)
        masks = [spread_draws(m, valid, True) for m in self._draw_masks(generator, n_real)] \
            if train else []
        per = len(batch[0]["surface"])
        rows = [slice(batch.start + i * per, batch.start + (i + 1) * per)
                for i in range(len(batch))]
        s_parts, o_parts = self._embed_shards(
            self._replicas(params, [shard["surface"].device for shard in batch]), batch,
            [None if draws is None else draws[r] for r in rows],
            [DropoutMasks([m[r] for m in masks]) if train else None for r in rows],
            train, params, n_real)
        home = self.device
        s_emb = gather_rows(torch.cat([x.to(home) for x in s_parts]), batch.start, batch.rows)
        o_emb = gather_rows(torch.cat([x.to(home) for x in o_parts]), batch.start, batch.rows)
        return self._loss(s_emb, o_emb, valid.to(home), params)

    def _replicas(self, params: Params, devices) -> Dict[torch.device, Tuple]:
        """(this pipeline on the device, ``params`` copied there with
        autograd: one backward sums every shard's gradient into ``params``)
        for each distinct device; the pipeline's own device keeps
        ``params`` itself."""
        out = {}
        for device in devices:
            if device not in out:
                out[device] = (self.on_device(device),
                               {tower: {k: v.to(device) for k, v in p.items()}
                                for tower, p in params.items()})
        return out

    def _embed_shards(self, replicas, shards, draws, masks, train, params, n_real):
        """Each shard's (surface, overhead) embeddings on its device."""
        s_parts, o_parts = [], []
        for shard, shard_draws, shard_masks in zip(shards, draws, masks):
            replica, replica_params = replicas[shard["surface"].device]
            surface, polar = replica.preprocess(shard, None, shard_draws)
            s_emb, o_emb = replica._towers(replica_params, surface, polar, train, shard_masks)
            s_parts.append(s_emb)
            o_parts.append(o_emb)
        return s_parts, o_parts

    @torch.no_grad()
    @spanned("embed")
    def embed_step(
        self, params: Params, batch, generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed a batch: (surface embeddings, overhead embeddings), float32:
        FOV maps [B, h, sw', 16] and [B, h, W', 16] NHWC, SAFA vectors
        [B, M·512], baseline vectors [B, 1536], Sample4Geo vectors
        [B, dims[-1]]. ``draws``: the batch's random draw (:meth:`draw`),
        made by the caller, in place of one from ``generator``."""
        with span("preprocess", stretch=True):
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

    def _loss(self, s_emb: torch.Tensor, o_emb: torch.Tensor, valid: Optional[torch.Tensor],
              params: Params) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Matmul correlation, chord distance, DSM triplet loss (``valid``
        masking padded rows)."""
        corr = circular_correlation(o_emb, s_emb, method="matmul")
        distance, orientation = chord_distance(o_emb, s_emb, corr)
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

    def _loss(self, s_emb: torch.Tensor, o_emb: torch.Tensor, valid: Optional[torch.Tensor],
              params: Params) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Squared Euclidean distances [B_o, B_s], DSM triplet loss
        (``valid`` masking padded rows)."""
        d2 = pairwise_sq_distances(o_emb, s_emb)
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
        with span("draw"):
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
        with span("tower.surface"):
            s_emb = functional_call(self.surface_model, params["surface"], (surface,), kwargs,
                                    strict=True)
        with span("tower.overhead"):
            o_emb = functional_call(self.overhead_model, params["overhead"], (overhead,),
                                    kwargs, strict=True)
        return s_emb, o_emb

    def _embed(self, params: Params, batch, generator: Optional[torch.Generator],
               train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Preprocess, both towers (train mode: BatchNorm on the batch's
        statistics over ``batch["valid"]`` rows, the running buffers in
        ``params`` updated)."""
        with span("preprocess", stretch=True):
            surface, overhead = self.preprocess(batch, generator)
        return self._towers(params, surface, overhead, train, None, self._valid(batch))

    def _draw_masks(self, generator: torch.Generator, b: int) -> List[torch.Tensor]:
        return []  # no dropout

    def _embed_shards(self, replicas, shards, draws, masks, train, params, n_real):
        """Both towers on every shard in lockstep (``forward_sharded``):
        train-mode BatchNorm takes the global batch's statistics from every
        row's moments, gathered on the pipeline's device in row order and,
        across processes, in one sum of a zero buffer holding this
        process's rows at their global place (``sum_across_processes``:
        its backward sums the statistics' gradient over the processes), and
        updates ``params``' running buffers once."""
        home = self.device
        inputs, tower_params = [], []
        for shard, shard_draws in zip(shards, draws):
            replica, replica_params = replicas[shard["surface"].device]
            inputs.append(replica.preprocess(shard, None, shard_draws))
            tower_params.append(replica_params)

        def gather(parts):
            own = torch.cat([p.to(home) for p in parts])
            if process_count() == 1:
                return own
            after = shards.rows - shards.start - len(own)
            return sum_across_processes(torch.cat([own.new_zeros((shards.start,) + own.shape[1:]),
                                                   own, own.new_zeros((after,) + own.shape[1:])]))

        towers = (self.surface_model, self.overhead_model)
        embs = forward_sharded(towers, [[p[t] for p in tower_params] for t in TOWERS],
                               [[x[k] for x in inputs] for k in range(len(TOWERS))], train,
                               shards.valid, n_real, gather, [params[t] for t in TOWERS])
        return tuple(embs)

    def _loss(self, s_emb: torch.Tensor, o_emb: torch.Tensor, valid: Optional[torch.Tensor],
              params: Params) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The exhaustive minibatch triplet loss (``valid`` masking padded
        rows)."""
        m = self.cfg.match
        loss = exhaustive_minibatch_triplet_loss(s_emb, o_emb, soft_margin=m.soft_margin,
                                                 alpha=m.alpha, margin=m.margin, valid=valid)
        return loss, {"surface": s_emb, "overhead": o_emb}


class Sample4GeoPipeline(_TwinPipeline):
    """Sample4Geo (Deuser et al., ICCV 2023) on ``device`` (the CUDA device
    when None): one ConvNeXt encoder (``models.sample4geo.Sample4Geo``)
    with its weights held once embeds both views, the panorama and the
    aerial tile as they come (normalized, no crop, polar map or heading
    draw), into unit vectors; the symmetric InfoNCE loss; Euclidean
    retrieval eval (``euclidean_ranks``: on unit vectors, cosine order).
    Params are ``{"surface": sd, "overhead": sd}`` with one state dict
    ``sd`` under both keys."""

    kind = "sample4geo"

    def __init__(self, cfg: ExperimentConfig, device=None):
        self._encoder = None
        super().__init__(cfg, device)

    def _tower(self, circ: bool) -> Sample4Geo:
        """The one encoder, for either view."""
        if self._encoder is None:
            self._encoder = Sample4Geo(self.cfg.model)
        return self._encoder

    def init(self, generator: torch.Generator) -> Params:
        """Fresh params (timm's init, the logit scale at its init), drawn
        from a CPU ``generator``, one state dict under both towers."""
        model = Sample4Geo(self.cfg.model)
        model.reset_parameters(generator)
        shared = {k: v.to(self.device) for k, v in model.state_dict().items()}
        return {"surface": shared, "overhead": shared}

    def trainable_names(self, tower_params: Dict[str, torch.Tensor]) -> List[str]:
        return list(tower_params)

    def preprocess(
        self, batch, generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw {"surface": [B, H, W, C], "overhead": [B, S, S, C]} -> both
        normalized, in the compute dtype, as NCHW channels_last views.
        Nothing is drawn: ``generator`` and ``draws`` are unused."""
        d = self.cfg.data
        dtype = getattr(torch, self.cfg.model.compute_dtype)
        return tuple(normalize_images(self._input(batch[view]), d.img_mean, d.img_std)
                     .to(dtype).permute(0, 3, 1, 2) for view in TOWERS)

    def _draw_masks(self, generator: torch.Generator, b: int) -> List[torch.Tensor]:
        return []  # no dropout

    def _loss(self, s_emb: torch.Tensor, o_emb: torch.Tensor, valid: Optional[torch.Tensor],
              params: Params) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The symmetric InfoNCE loss over ``valid``'s rows (all when None),
        at the params' ``logit_scale``."""
        if valid is not None:
            keep = valid.to(device=s_emb.device, dtype=torch.bool)
            s_emb, o_emb = s_emb[keep], o_emb[keep]
        loss = symmetric_infonce(s_emb, o_emb, params["surface"]["logit_scale"],
                                 self.cfg.model.label_smoothing)
        return loss, {"surface": s_emb, "overhead": o_emb}


Pipeline = Union[FovPipeline, SafaPipeline, BaselinePipeline, Sample4GeoPipeline]


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
    if kind == "sample4geo":
        return Sample4GeoPipeline(cfg, device)
    raise TypeError(f"unknown model config: {type(cfg.model)}")


def spread_draws(draws: torch.Tensor, valid: torch.Tensor, fill) -> torch.Tensor:
    """Draws made for a batch's real rows, in row order, placed on the rows
    of ``valid`` (bool [rows], host) with ``fill`` on the others."""
    out = torch.full((valid.shape[0],) + tuple(draws.shape[1:]), fill, dtype=draws.dtype,
                     device=draws.device)
    out[valid.to(draws.device)] = draws
    return out


def _sum_grads_across_processes(optimizer: torch.optim.Optimizer) -> None:
    """Sum the trainable params' gradients over the processes in one
    collective (a missing gradient as zeros), so that every process takes
    the same Adam step: the global loss's gradient, not a mean."""
    if process_count() == 1:
        return
    params = [p for group in optimizer.param_groups for p in group["params"]]
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params])
    flat = all_reduce_sum(flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p).clone()
