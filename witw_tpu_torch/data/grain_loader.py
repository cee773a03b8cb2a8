"""A deterministic, per-process sharded pair loader (counterpart of
witw_tpu/data/grain_loader.py's ``GrainPairLoader``; module and class keep
its names).

It does not use Google Grain: numpy orders the pairs and the port's
``PairLoader`` decodes them, on threads. The contract is witw_tpu's:

- batches {"surface": [B, H, W, C], "overhead": [B, S, S, C], "idx": [B]}
  as :class:`witw_tpu_torch.data.loader.PairLoader` yields them;
- the epoch order is a pure function of (seed, epoch), the same in every
  instance and process, reshuffled each epoch (with ``shuffle``);
- process ``shard_index`` of ``shard_count`` reads ``order[shard_index::
  shard_count]`` of it: the shards are disjoint and together cover the
  epoch, and each composes with ``parallel.global_batch_from_local``;
- ``len`` is witw_tpu's count of this shard's batches.

The permutation is the port's own (numpy's ``Generator.permutation`` seeded
by the pair (seed, epoch)), not grain's: the two packages read the same
pairs per epoch in different orders.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from witw_tpu_torch.data.loader import PairLoader


class GrainPairLoader(PairLoader):
    """A :class:`PairLoader` (its batches, threads and prefetch) that reads
    this process's shard of each epoch's order."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], batch_size: int,
                 surface_hw: Tuple[int, int], overhead_hw: Tuple[int, int],
                 shard_index: int = 0, shard_count: int = 1, **kwargs):
        """``shard_index`` / ``shard_count``: this process's part of the
        epoch order (pass ``parallel.process_index()`` /
        ``process_count()``); ``kwargs``: :class:`PairLoader`'s."""
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        super().__init__(pairs, batch_size, surface_hw, overhead_hw, **kwargs)
        self.shard_index = shard_index
        self.shard_count = shard_count

    def __len__(self) -> int:
        # this shard's element count under [shard_index::shard_count] slicing
        n = len(range(self.shard_index, len(self.pairs), self.shard_count))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def order(self, epoch: int) -> np.ndarray:
        """The indices this shard reads in ``epoch``, in reading order."""
        order = np.arange(len(self.pairs))
        if self.shuffle:
            order = np.random.default_rng([self.seed, epoch]).permutation(len(self.pairs))
        return order[self.shard_index::self.shard_count]
