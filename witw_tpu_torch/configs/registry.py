"""Dataset + experiment presets of the four tower families (the port's copy
of ``dataset_config``, ``baseline_experiment``, ``fov_experiment``,
``semantic_experiment`` and ``safa_experiment`` from
witw_tpu/configs/registry.py;
tests/test_torch_slice.py holds them equal), and the port's own
``sample4geo_experiment``.

CVUSA is a headerless CSV with [overhead, surface] in columns 0/1 and
panoramic surface photos; WITW has a 17-column CSV with header where columns
15/16 are [surface, overhead] and photos are ordinary (non-panoramic).
"""

from __future__ import annotations

import dataclasses

from witw_tpu_torch.configs.base import (
    BaselineModelConfig,
    DataConfig,
    DatasetConfig,
    EvalConfig,
    ExperimentConfig,
    FovDsmModelConfig,
    MatchConfig,
    OptimConfig,
    SafaModelConfig,
    Sample4GeoModelConfig,
    TrainConfig,
)

DATASETS = {
    "cvusa": DatasetConfig(
        name="cvusa",
        train_csv="./data/train-19zl.csv",
        test_csv="./data/val-19zl.csv",
        path_columns=(0, 1),
        path_names=("overhead", "surface"),
        header=None,
        panorama=True,
    ),
    "witw": DatasetConfig(
        name="witw",
        train_csv="./data2/train.csv",
        test_csv="./data2/test.csv",
        path_columns=(15, 16),
        path_names=("surface", "overhead"),
        header=0,
        panorama=False,
    ),
    # Semantic WITW variant reads scene CSVs under ./data4 and 4/5-band TIFFs
    # (reference cvig_semantic.py:33-37).
    "witw_semantic": DatasetConfig(
        name="witw",
        train_csv="./data4/train_scenes.csv",
        test_csv="./data4/test_scenes.csv",
        path_columns=(15, 16),
        path_names=("surface", "overhead"),
        header=0,
        panorama=False,
        semantic=True,
    ),
}


def dataset_config(name: str, semantic: bool = False) -> DatasetConfig:
    if semantic and name == "witw":
        return DATASETS["witw_semantic"]
    ds = DATASETS[name]
    if semantic:
        ds = dataclasses.replace(ds, semantic=True)
    return ds


def baseline_experiment(dataset: str = "cvusa", **overrides) -> ExperimentConfig:
    """cvig_baseline preset (reference cvig_baseline.py:318,349)."""
    data = DataConfig(dataset=dataset_config(dataset), fov=360)
    cfg = ExperimentConfig(
        data=data,
        model=BaselineModelConfig(),
        match=MatchConfig(soft_margin=False),
        train=TrainConfig(
            batch_size=16,
            optim=OptimConfig(learning_rate=1e-3),  # torch Adam default
        ),
        eval=EvalConfig(batch_size=16),
    )
    return cfg.replace(**overrides) if overrides else cfg


def fov_experiment(dataset: str = "cvusa", fov: int = 360, **overrides) -> ExperimentConfig:
    """cvig_fov preset (reference cvig_fov.py:385,418)."""
    data = DataConfig(dataset=dataset_config(dataset), fov=fov)
    cfg = ExperimentConfig(
        data=data,
        model=FovDsmModelConfig(),
        match=MatchConfig(alpha=10.0),
        train=TrainConfig(batch_size=64, optim=OptimConfig(learning_rate=1e-5)),
        eval=EvalConfig(batch_size=64),
    )
    return cfg.replace(**overrides) if overrides else cfg


def semantic_experiment(dataset: str = "witw", fov: int = 360, **overrides) -> ExperimentConfig:
    """cvig_semantic preset: 5-channel inputs with extended normalization stats
    (reference cvig_semantic.py:25-26) and trainable first conv
    (cvig_semantic.py:306-309); train batch 32 (cvig_semantic.py:416)."""
    data = DataConfig(
        dataset=dataset_config(dataset, semantic=True),
        fov=fov,
        channels=5,
        img_mean=(0.485, 0.456, 0.406, 0.45, 0.45),
        img_std=(0.229, 0.224, 0.225, 0.22, 0.22),
    )
    cfg = ExperimentConfig(
        data=data,
        model=FovDsmModelConfig(in_channels=5, train_first_conv=True),
        match=MatchConfig(alpha=10.0),
        train=TrainConfig(batch_size=32, optim=OptimConfig(learning_rate=1e-5)),
        eval=EvalConfig(batch_size=32),
    )
    return cfg.replace(**overrides) if overrides else cfg


def safa_experiment(dataset: str = "cvusa", fov: int = 360, **overrides) -> ExperimentConfig:
    """VGG16+SAFA preset (BASELINE.json config 1's tower family): global
    embeddings matched by Euclidean distance, polar-aligned aerial branch."""
    data = DataConfig(dataset=dataset_config(dataset), fov=fov)
    cfg = ExperimentConfig(
        data=data,
        model=SafaModelConfig(),
        match=MatchConfig(alpha=10.0),
        train=TrainConfig(batch_size=32, optim=OptimConfig(learning_rate=1e-5)),
        eval=EvalConfig(batch_size=32),
    )
    return cfg.replace(**overrides) if overrides else cfg


def sample4geo_experiment(dataset: str = "cvusa", **overrides) -> ExperimentConfig:
    """Sample4Geo's CVUSA setting (Deuser et al., ICCV 2023): a ConvNeXt-B
    encoder shared by both views; the panorama resized to 140 x 768
    (round(224 / 1232 * 768) = 140), the 384 x 384 aerial tile as it is, no
    polar transform and no heading draw, ImageNet statistics; train batch
    128 (AdamW at 1e-3 in the paper; the port's optimizer is Adam), eval
    batch 64."""
    data = DataConfig(dataset=dataset_config(dataset), surface_height=140,
                      surface_width_max=768, overhead_size=384, fov=360,
                      random_orientation=False)
    cfg = ExperimentConfig(
        data=data,
        model=Sample4GeoModelConfig(),
        train=TrainConfig(batch_size=128, optim=OptimConfig(learning_rate=1e-3)),
        eval=EvalConfig(batch_size=64),
    )
    return cfg.replace(**overrides) if overrides else cfg
