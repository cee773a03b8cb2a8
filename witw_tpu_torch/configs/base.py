"""Typed configuration tree (the port's copy of witw_tpu/configs/base.py;
tests/test_torch_slice.py holds the two equal).

Replaces the reference's three config mechanisms (SURVEY.md §5.6): the
hard-coded ``class Globals`` in each model script (reference
model/cvig_fov.py:19-51), per-script argparse CLIs, and the scraper YAML —
with one dataclass tree that the CLIs build and override.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """One dataset's CSV locations and schema.

    Mirrors the information in ``Globals.dataset_paths`` /
    ``Globals.path_formats`` (reference model/cvig_fov.py:27-51): which CSV
    columns hold the surface/overhead paths, whether there is a header row,
    and whether surface photos are 360-degree panoramas.
    """

    name: str
    train_csv: str
    test_csv: str
    # Column indices in the CSV holding image paths.
    path_columns: Tuple[int, int] = (0, 1)
    # Names for those columns, aligned with path_columns.
    path_names: Tuple[str, str] = ("overhead", "surface")
    # Header row index, or None for headerless CSVs.
    header: Optional[int] = None
    # True if surface photos are full 360-degree panoramas (enables the
    # wraparound FOV crop and synced-rotation shift).
    panorama: bool = True
    # Semantic variant: read 4/5-band TIFFs with a road-mask channel
    # (reference cvig_semantic.py:86-123).
    semantic: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-loader + on-device transform settings."""

    dataset: DatasetConfig
    # Canonical on-device input geometry (reference cvig_fov.py:20-22).
    surface_height: int = 128
    surface_width_max: int = 512
    overhead_size: int = 256
    # Field of view in degrees; surface crop width = fov/360 * surface_width_max.
    fov: int = 360
    # Randomly rotate panorama before the FOV crop during training
    # (reference cvig_fov.py:121).
    random_orientation: bool = True
    # Per-channel normalization stats (ImageNet; reference cvig_fov.py:24-25;
    # 5-channel semantic variant cvig_semantic.py:25-26).
    img_mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    img_std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    # Number of image channels (3 RGB; 5 for semantic = RGB + mask channels).
    channels: int = 3
    # Host-side decode worker count (reference DataLoader num_workers,
    # cvig_fov.py:385).
    num_workers: int = 8
    # Device prefetch depth.
    prefetch: int = 2

    @property
    def surface_width(self) -> int:
        return int(self.fov / 360 * self.surface_width_max)


@dataclasses.dataclass(frozen=True)
class BaselineModelConfig:
    """7-conv GeM-pooled twin towers (reference cvig_baseline.py:228-283)."""

    kind: str = "baseline"
    bands: int = 3
    # Append Liu & Li CVPR'19 u-v orientation-map channels to both views
    # (live version of the reference's dead code, cvig_baseline.py:163-206).
    orientation_maps: bool = False
    gem_power: float = 3.0
    # LeakyReLU negative slope (reference cvig_baseline.py:236).
    leaky_slope: float = 0.2
    # BatchNorm momentum, torch convention (running = (1-m)*running + m*batch).
    bn_momentum: float = 0.1
    # Conv/BN init std (reference cvig_baseline.py:255-262).
    init_std: float = 0.02
    compute_dtype: str = "bfloat16"
    # Conv precision override (None = backend default). "highest" pins
    # exact-f32 convs on backends whose DEFAULT f32 lowering can be reduced
    # precision: XLA:CPU measured 8e-4 abs error vs an f64 oracle on a
    # standalone jitted conv (3e-8 under HIGHEST, ~1.16x runtime; the same
    # conv fused into the full tower graph read ~3e-5 — the lowering is
    # context-dependent, NOTES.md round 5). Matters for cross-framework
    # parity because train-mode BatchNorm amplifies input error by
    # rsqrt(var_batch + eps) per layer. On TPU compute_dtype governs.
    conv_precision: "str | None" = None


@dataclasses.dataclass(frozen=True)
class FovDsmModelConfig:
    """VGG16-based FOV-DSM towers (reference cvig_fov.py:248-294)."""

    kind: str = "fov_dsm"
    in_channels: int = 3  # 5 for the semantic variant (cvig_semantic.py:301-303)
    # Channel widths of the three head convs appended after VGG conv4_3.
    head_channels: Tuple[int, int, int] = (256, 64, 16)
    dropout_rate: float = 0.2
    # Freeze VGG blocks 1-3 (torch feature idx < 17, reference
    # cvig_fov.py:274-278). For the semantic variant conv1_1 stays trainable
    # (cvig_semantic.py:306-309).
    freeze_backbone: bool = True
    train_first_conv: bool = False
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class SafaModelConfig:
    """VGG16+SAFA global-embedding towers (Shi et al. NeurIPS 2019; the
    tower family BASELINE.json's benchmark configs name for the baseline
    model line)."""

    kind: str = "vgg_safa"
    in_channels: int = 3
    num_heads: int = 8
    reduction: int = 2
    freeze_backbone: bool = True
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class Sample4GeoModelConfig:
    """Sample4Geo's shared ConvNeXt encoder (Deuser, Habel, Oswald, ICCV 2023;
    ConvNeXt-B, Liu et al., CVPR 2022): one encoder with shared weights embeds
    both views into unit vectors; trained with the symmetric InfoNCE loss.
    The port's own family: witw_tpu has no counterpart."""

    kind: str = "sample4geo"
    in_channels: int = 3
    depths: Tuple[int, int, int, int] = (3, 3, 27, 3)
    dims: Tuple[int, int, int, int] = (128, 256, 512, 1024)
    kernel_size: int = 7  # the depthwise token mixer
    mlp_ratio: int = 4
    ln_eps: float = 1e-6
    compute_dtype: str = "bfloat16"
    # InfoNCE: logits exp(s) * f_g f_a^T, s learnable from log(1 / 0.07).
    logit_scale_init: float = math.log(1.0 / 0.07)
    label_smoothing: float = 0.1


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Orientation alignment + distance settings (reference cvig_fov.py:297-382)."""

    # Soft-margin triplet temperature alpha (reference cvig_fov.py:366).
    alpha: float = 10.0
    # Baseline loss variant: soft vs hard margin (reference cvig_baseline.py:286).
    soft_margin: bool = False
    margin: float = 1.0


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"
    # Reference LRs: Adam default 1e-3 for baseline (cvig_baseline.py:349),
    # 1e-5 for fov/semantic (cvig_fov.py:418).
    learning_rate: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    val_quantity: int = 1000
    num_epochs: int = 999_999
    seed: int = 0
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    # Checkpoint/metrics directories (reference ./weights + runs/,
    # cvig_fov.py:387-388).
    checkpoint_dir: str = "./weights"
    tensorboard_dir: str = "./runs"
    # Save every N steps in addition to best-val (reference saves best-val only,
    # cvig_fov.py:481-487; we add resumable periodic checkpoints).
    save_every_steps: int = 0
    keep_checkpoints: int = 3
    # Serialize+write step/latest checkpoints on a background thread so
    # training overlaps the disk write (the host fetch stays synchronous).
    async_checkpoints: bool = False
    log_every_steps: int = 1


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 64
    # Query block size for the blockwise query x gallery distance computation.
    query_block: int = 256
    topk: Tuple[int, ...] = (1, 5, 10)
    # Keep the gallery resident, physically sharded over every mesh device
    # (shard_map sweep with psum'd rank counts) instead of sharding the query
    # axis — the 100k+-tile scaling mode (SURVEY.md §5.7). Needs a mesh.
    shard_gallery: bool = False
    gallery_chunk: int = 1024
    # bf16 frequency-product in the rank sweep (opt-in approximation; the
    # exact HIGHEST-precision complex einsum stays the parity default —
    # see match/fft_matcher._freq_product and FovGalleryEvaluator).
    fast_matmul: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout.

    ``data`` shards the batch (training) and the query axis (eval);
    ``gallery`` shards the retrieval gallery axis (eval sweeps). The
    reference has no parallelism at all (SURVEY.md §2.4); these axes are the
    TPU-native scaling story.
    """

    data: int = -1  # -1 = all devices
    gallery: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        data = self.data if self.data > 0 else n_devices // max(self.gallery, 1)
        return data, max(self.gallery, 1)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig
    model: object  # BaselineModelConfig | FovDsmModelConfig
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
