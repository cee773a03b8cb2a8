"""Weight bridge between flax tower params and the port's state dicts.

A flax tower tree ``{"vgg": {"conv_0": {"kernel": HWIO, "bias": [O]}, ...},
"conv_23": {...}, ...}`` maps to a torch state dict ``{"vgg.conv_0.weight":
OIHW, "vgg.conv_0.bias": [O], ..., "conv_23.weight": ...}``. The SAFA head's
node holds four bare arrays, ``{"safa": {"fc1": ..., "fc1_bias": ...,
"fc2": ..., "fc2_bias": ...}}``; they map to ``safa.fc1`` etc. unchanged.
The two-tower ``{"surface": ..., "overhead": ...}`` tree that witw_tpu's
``FovPipeline.init`` or ``SafaPipeline.init`` produces (as numpy arrays)
maps to the port's params, ``{"surface": state_dict, "overhead":
state_dict}``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

TOWERS = ("surface", "overhead")
# Bare arrays of a flax node, carried across as they are (the SAFA head's).
BARE_LEAVES = ("fc1", "fc1_bias", "fc2", "fc2_bias")


def tower_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if "kernel" in node:
            kernel = np.asarray(node["kernel"], np.float32)
            out[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))
            )
            out[prefix + "bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
            return
        for key, child in node.items():
            if key in BARE_LEAVES:
                out[prefix + key] = torch.from_numpy(np.array(child, np.float32))
            else:
                walk(child, prefix + key + ".")

    walk(tree, "")
    return out


def state_dict_to_tower(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))
        elif leaf == "bias" or leaf in BARE_LEAVES:
            node[leaf] = arr.copy()
        else:
            raise ValueError(f"unexpected parameter name {name!r}")
    return tree


def jax_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Two-tower flax params (numpy leaves) -> ``{"surface": sd, "overhead":
    sd}`` with OIHW float32 weights on the CPU."""
    return {t: tower_to_state_dict(params[t]) for t in TOWERS}


def state_dict_to_jax_params(state: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """Inverse of :func:`jax_params_to_state_dict` (numpy HWIO leaves)."""
    return {t: state_dict_to_tower(state[t]) for t in TOWERS}
