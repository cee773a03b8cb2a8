"""The public names of witw_tpu_torch.data, as witw_tpu.data exports them."""

from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.data.loader import PairLoader, split_train_val
from witw_tpu_torch.data.synthetic import SyntheticPairs, write_synthetic_dataset

__all__ = [
    "read_pair_paths",
    "PairLoader",
    "split_train_val",
    "SyntheticPairs",
    "write_synthetic_dataset",
]
