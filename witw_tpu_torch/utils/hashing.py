"""Weight fingerprints for index-staleness checks (port of
witw_tpu/utils/hashing.py).

``params_fingerprint`` hashes a tower in flax's layout (the tree that
``models.convert_jax.state_dict_to_tower`` builds): leaves in
``jax.tree_util.tree_flatten_with_path``'s order (dict keys sorted, depth
first), each with the same ``str(path)``, shape, dtype and bytes. So a
gallery index stamped by either package passes the other's check of the
serving towers.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from witw_tpu_torch.models.convert_jax import state_dict_to_tower


class _DictKey:
    """Prints as jax.tree_util.DictKey does, inside a path tuple."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __repr__(self) -> str:
        return f"DictKey(key={self.key!r})"


def _leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], path + (_DictKey(key),))
    else:
        yield path, tree


def params_fingerprint(tower: Dict[str, Any]) -> str:
    """Order-stable sha256 over one tower's parameters (paths, shapes,
    dtypes, raw bytes). ``tower``: a state dict of tensors (``vgg.conv_0.weight``
    ...), converted to flax's layout first, or a flax-layout tree of arrays."""
    if tower and all(isinstance(v, torch.Tensor) for v in tower.values()):
        tower = state_dict_to_tower(tower)
    h = hashlib.sha256()
    for path, leaf in _leaves_with_path(tower):
        arr = np.asarray(leaf)
        h.update(str(path).encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()
