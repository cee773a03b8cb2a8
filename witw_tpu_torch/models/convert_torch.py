"""PyTorch ``.pth`` checkpoints -> the port's tower state dicts (port of
witw_tpu/models/convert_torch.py).

Two use cases:
1. Bootstrapping the FOV-DSM towers from torchvision's pretrained VGG16
   (the reference pulls it from torch.hub at runtime, model/cvig_fov.py:256;
   here the conversion runs offline on a ``vgg16-*.pth`` file).
2. Loading checkpoints of the reference's own training
   (./weights/fov_{fov}_{surface,overhead}_best.pth, cvig_fov.py:485-486;
   ./weights/{surface,overhead}_best.pth, cvig_baseline.py:399-402).

The functions return state dicts with the names the port's towers use (the
names ``models.convert_jax.tower_to_state_dict`` gives): ``vgg.conv_N`` and
``conv_23`` / ``conv_25`` / ``conv_27`` for a FOV-DSM tower, ``convN`` and
``bnN`` (with ``running_mean`` / ``running_var``) for a baseline tower;
CPU tensors, OIHW as torch stores them, float32 unless the caller keeps the
``.pth``'s dtype (``dtype=None``). Reference tower keys look
like ``model.features.17.layer.weight`` when wrapped by
HorizCircPadding / AddDropout (cvig_fov.py:212-245) and
``model.features.0.weight`` when bare; both are read.

The CLI, ``python -m witw_tpu_torch.models.convert_torch in.pth out.npz``,
writes witw_tpu's ``.npz`` layout ('/'-joined keys of the flax tree, HWIO
kernels, the ``.pth``'s dtype), so either package reads the other's file;
the port reads one with :func:`load_converted`, in float32.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from witw_tpu_torch.models.backbones.vgg16 import VGG16_CONVS
from witw_tpu_torch.models.convert_jax import (state_dict_to_tower, state_dict_to_tower_stats,
                                               tower_to_state_dict)
from witw_tpu_torch.models.fov_dsm import HEAD_CONVS

StateDict = Dict[str, torch.Tensor]

# Reference baseline keys: conv1..conv7 and bn1..bn7, maybe under DataParallel's ``module.``.
_BASELINE_KEY = re.compile(r"(?:module\.)?(conv|bn)(\d)\.(\w+)")
_BASELINE_FIELDS = {"conv": ("weight", "bias"),
                    "bn": ("weight", "bias", "running_mean", "running_var")}


def _tensor(v, dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return t.to(dtype or t.dtype).contiguous().clone()


def _strip_wrappers(key: str) -> str:
    """Normalize keys from HorizCircPadding/AddDropout-wrapped layers."""
    return key.replace(".layer.", ".").replace("model.features.", "features.")


def convert_fov_dsm_state_dict(state_dict: Mapping[str, Any],
                               dtype: Optional[torch.dtype] = torch.float32) -> StateDict:
    """A torchvision ``vgg16`` state dict (``features.N.{weight,bias}``) or
    a reference FOV-DSM tower checkpoint (``model.features.N[.layer].*``) ->
    the port's ``FovDsm`` state dict in ``dtype`` (None: the source's). The head convs live at torch feature
    indices 23 / 25 / 27; torchvision's VGG16 has none, so they are left
    out. KeyError where a VGG conv is missing."""
    flat = {_strip_wrappers(k): v for k, v in state_dict.items()}
    out: StateDict = {}
    for torch_idx, _ in VGG16_CONVS:
        w = flat.get(f"features.{torch_idx}.weight")
        if w is None:
            raise KeyError(f"missing features.{torch_idx}.weight in state dict")
        out[f"vgg.conv_{torch_idx}.weight"] = _tensor(w, dtype)
        out[f"vgg.conv_{torch_idx}.bias"] = _tensor(flat[f"features.{torch_idx}.bias"], dtype)
    for name, _, _, _ in HEAD_CONVS:
        torch_idx = int(name.split("_")[1])
        w = flat.get(f"features.{torch_idx}.weight")
        if w is None:
            continue  # plain torchvision VGG16 has no head convs
        out[f"{name}.weight"] = _tensor(w, dtype)
        out[f"{name}.bias"] = _tensor(flat[f"features.{torch_idx}.bias"], dtype)
    return out


def merge_pretrained_vgg(state_dict: StateDict, converted: StateDict) -> StateDict:
    """Overlay ``converted`` (from :func:`convert_fov_dsm_state_dict`) onto
    a freshly initialized tower's state dict; returns a new dict.

    Where the semantic tower's ``conv_0`` takes more input channels (5:
    RGB and the masks), the RGB weights go into its first input channels
    and the rest keep their fresh init (reference cvig_semantic.py:301-303).
    Any other shape mismatch, or a name the tower lacks, raises."""
    out = {k: v.clone() for k, v in state_dict.items()}
    for key, src in converted.items():
        if key not in out:
            raise KeyError(f"{key} is not a parameter of the tower")
        dst = out[key]
        if src.shape == dst.shape:
            out[key] = src.to(dst.dtype).clone()
        elif (key == "vgg.conv_0.weight" and src.shape[1] < dst.shape[1]
              and src.shape[:1] + src.shape[2:] == dst.shape[:1] + dst.shape[2:]):
            dst[:, :src.shape[1]] = src.to(dst.dtype)
        else:
            raise ValueError(f"shape mismatch for {key}: {tuple(src.shape)} vs "
                             f"{tuple(dst.shape)}")
    return out


def convert_baseline_state_dict(state_dict: Mapping[str, Any],
                                dtype: Optional[torch.dtype] = torch.float32) -> StateDict:
    """A reference baseline tower checkpoint (conv1..conv7, bn1..bn7,
    cvig_baseline.py:240-253; keys may start with ``module.``) -> the
    port's ``BaselineEncoder`` state dict in ``dtype`` (None: the
    source's), BatchNorm running statistics beside the weights. ``num_batches_tracked``, which the port does not
    keep, and keys of no tower layer are skipped."""
    out: StateDict = {}
    for key, val in state_dict.items():
        m = _BASELINE_KEY.fullmatch(key)
        if m and m.group(3) in _BASELINE_FIELDS[m.group(1)]:
            out[f"{m.group(1)}{m.group(2)}.{m.group(3)}"] = _tensor(val, dtype)
    return out


def load_torch_file(path: str) -> Mapping[str, Any]:
    """Load a ``.pth`` state dict onto the CPU (``weights_only``, as
    ``torch.load``'s default since torch 2.6: a pickled module is refused;
    save its ``state_dict()``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_full_module(checkpoint_path: str, device) -> torch.nn.Module:
    """A checkpoint pickled as a whole ``nn.Module`` (the reference's
    Places365 and CRESI checkpoints are), in eval mode on ``device``.
    ``weights_only=False``: unpickling runs code from the file, so load only
    checkpoints you trust. ValueError for a bare state_dict, which cannot
    run without its architecture."""
    model = torch.load(checkpoint_path, map_location=device, weights_only=False)
    if not isinstance(model, torch.nn.Module):
        raise ValueError(
            f"{checkpoint_path} does not contain a full nn.Module (got "
            f"{type(model).__name__}); a bare state_dict cannot be run without "
            "its architecture"
        )
    return model.eval()


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of the converter CLI's npz layout ('a/b/c' keys -> nested dict)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return out


def converted_tree(state_dict: StateDict, family: str) -> Dict[str, Any]:
    """A converted tower's state dict -> the flax tree the CLI writes: the
    params alone (``fov``), or ``{"params", "batch_stats"}``
    (``baseline``), as witw_tpu's converter builds them, in the state
    dict's dtype."""
    if family == "fov":
        return state_dict_to_tower(state_dict)
    return {"params": state_dict_to_tower(state_dict),
            "batch_stats": state_dict_to_tower_stats(state_dict)}


def load_converted(path: str) -> StateDict:
    """Read a converter ``.npz`` (either package's) into a tower state dict
    through the weight bridge; a baseline file's ``batch_stats`` become the
    BatchNorm buffers."""
    with np.load(path) as data:
        tree = unflatten({k: data[k] for k in data.files})
    if "params" in tree:
        return tower_to_state_dict(tree["params"], tree.get("batch_stats"))
    return tower_to_state_dict(tree)


def main(argv=None) -> None:
    """Offline converter CLI: ``python -m witw_tpu_torch.models.convert_torch in.pth out.npz``.

    Converts torchvision VGG16 / reference FOV-DSM tower checkpoints
    (``--family fov``, the default) or reference baseline tower checkpoints
    (``--family baseline``) into an npz with witw_tpu's keys (flax params,
    '/'-joined; read it with :func:`load_converted`, or np.load and
    :func:`unflatten`)."""
    import argparse

    p = argparse.ArgumentParser(description="torch .pth -> tower params .npz")
    p.add_argument("src", help="torch state-dict file (.pth)")
    p.add_argument("dst", help="output .npz")
    p.add_argument("--family", choices=["fov", "baseline"], default="fov")
    args = p.parse_args(argv)

    sd = load_torch_file(args.src)
    convert = convert_fov_dsm_state_dict if args.family == "fov" else convert_baseline_state_dict
    flat = _flatten(converted_tree(convert(sd, dtype=None), args.family))
    np.savez(args.dst, **flat)
    print(f"wrote {args.dst}: {len(flat)} arrays")


if __name__ == "__main__":
    main()
