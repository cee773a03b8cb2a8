from witw_tpu_torch.configs.base import (
    DatasetConfig,
    DataConfig,
    BaselineModelConfig,
    FovDsmModelConfig,
    SafaModelConfig,
    MatchConfig,
    OptimConfig,
    TrainConfig,
    EvalConfig,
    MeshConfig,
    ExperimentConfig,
)
from witw_tpu_torch.configs.registry import (
    DATASETS,
    dataset_config,
    fov_experiment,
    safa_experiment,
    semantic_experiment,
)

__all__ = [
    "DatasetConfig",
    "DataConfig",
    "BaselineModelConfig",
    "FovDsmModelConfig",
    "SafaModelConfig",
    "MatchConfig",
    "OptimConfig",
    "TrainConfig",
    "EvalConfig",
    "MeshConfig",
    "ExperimentConfig",
    "DATASETS",
    "dataset_config",
    "fov_experiment",
    "safa_experiment",
    "semantic_experiment",
]
