"""The public names of witw_tpu_torch.match, as witw_tpu.match exports them."""

from witw_tpu_torch.match.correlation import circular_correlation, orientation_estimate
from witw_tpu_torch.match.distance import (
    window_sq_norms,
    chord_distance,
    paired_chord_distance,
    paired_chord_distance_fft,
    match_scores,
)
from witw_tpu_torch.match.reference_impl import (
    crop_overhead_materialized,
    chord_distance_materialized,
)
from witw_tpu_torch.match.losses import (
    dsm_triplet_loss,
    exhaustive_minibatch_triplet_loss,
)

__all__ = [
    "circular_correlation",
    "orientation_estimate",
    "window_sq_norms",
    "chord_distance",
    "paired_chord_distance",
    "paired_chord_distance_fft",
    "match_scores",
    "crop_overhead_materialized",
    "chord_distance_materialized",
    "dsm_triplet_loss",
    "exhaustive_minibatch_triplet_loss",
]
