"""Weight bridge between flax tower variables and the port's state dicts.

A flax tower tree ``{"vgg": {"conv_0": {"kernel": HWIO, "bias": [O]}, ...},
"conv_23": {...}, ...}`` maps to a torch state dict ``{"vgg.conv_0.weight":
OIHW, "vgg.conv_0.bias": [O], ..., "conv_23.weight": ...}``. The SAFA head's
node holds four bare arrays, ``{"safa": {"fc1": ..., "fc1_bias": ...,
"fc2": ..., "fc2_bias": ...}}``; they map to ``safa.fc1`` etc. unchanged.
A BatchNorm node of the baseline towers, ``{"bn1": {"scale", "bias"}}``,
maps to ``bn1.weight`` and ``bn1.bias``, and its ``batch_stats`` entry
``{"bn1": {"mean", "var"}}`` to the buffers ``bn1.running_mean`` and
``bn1.running_var``. The two-tower ``{"surface": ..., "overhead": ...}``
trees that witw_tpu's pipelines' ``init`` produce (as numpy arrays) map to
the port's params, ``{"surface": state_dict, "overhead": state_dict}``, the
buffers beside the weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

TOWERS = ("surface", "overhead")
# Bare arrays of a flax node, carried across as they are (the SAFA head's).
BARE_LEAVES = ("fc1", "fc1_bias", "fc2", "fc2_bias")
# flax batch_stats leaf -> torch buffer name (a BatchNorm node's).
STATS = {"mean": "running_mean", "var": "running_var"}


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32))


def tower_to_state_dict(tree: Dict[str, Any],
                        batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """One flax tower's params (and, for a baseline tower, its
    ``batch_stats``) -> a state dict of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if "kernel" in node:
            kernel = np.asarray(node["kernel"], np.float32)
            out[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))
            )
            out[prefix + "bias"] = _tensor(node["bias"])
            return
        if "scale" in node:  # a BatchNorm node
            out[prefix + "weight"] = _tensor(node["scale"])
            out[prefix + "bias"] = _tensor(node["bias"])
            return
        for key, child in node.items():
            if key in BARE_LEAVES:
                out[prefix + key] = _tensor(child)
            else:
                walk(child, prefix + key + ".")

    def walk_stats(node, prefix):
        for key, child in node.items():
            if key in STATS:
                out[prefix + STATS[key]] = _tensor(child)
            else:
                walk_stats(child, prefix + key + ".")

    walk(tree, "")
    if batch_stats:
        walk_stats(batch_stats, "")
    return out


def state_dict_to_tower(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A state dict -> the flax tower's params tree (numpy HWIO kernels;
    BatchNorm ``weight`` -> ``scale``). The running buffers are left out:
    they are :func:`state_dict_to_tower_stats`'s."""
    return _to_tree(state)[0]


def state_dict_to_tower_stats(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A state dict's BatchNorm buffers -> the flax tower's ``batch_stats``
    tree (``{}`` for a tower without BatchNorm)."""
    return _to_tree(state)[1]


def _to_tree(state: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    buffers = {v: k for k, v in STATS.items()}
    for name, value in state.items():
        *path, leaf = name.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        node = params if leaf not in buffers else stats
        for key in path:
            node = node.setdefault(key, {})
        if leaf in buffers:
            node[buffers[leaf]] = arr.copy()
        elif leaf == "weight" and arr.ndim == 4:
            node["kernel"] = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))
        elif leaf == "weight" and arr.ndim == 1:  # a BatchNorm scale
            node["scale"] = arr.copy()
        elif leaf == "bias" or leaf in BARE_LEAVES:
            node[leaf] = arr.copy()
        else:
            raise ValueError(f"unexpected parameter name {name!r}")
    return params, stats


def jax_params_to_state_dict(params: Dict[str, Any],
                             batch_stats: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Two-tower flax params (numpy leaves), with the two-tower
    ``batch_stats`` of the baseline family where given, -> ``{"surface": sd,
    "overhead": sd}`` with OIHW float32 weights on the CPU."""
    return {t: tower_to_state_dict(params[t], (batch_stats or {}).get(t)) for t in TOWERS}


def state_dict_to_jax_params(state: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """Inverse of :func:`jax_params_to_state_dict`'s params (numpy HWIO
    leaves; running buffers left out)."""
    return {t: state_dict_to_tower(state[t]) for t in TOWERS}


def state_dict_to_jax_variables(state: Dict[str, Dict[str, torch.Tensor]]
                                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The two-tower (params, batch_stats) of the port's params: the inverse
    of :func:`jax_params_to_state_dict` with batch_stats."""
    trees = {t: _to_tree(state[t]) for t in TOWERS}
    return {t: trees[t][0] for t in TOWERS}, {t: trees[t][1] for t in TOWERS}
