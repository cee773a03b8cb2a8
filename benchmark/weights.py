"""The towers' weights, made from the seed on the device.

One ``torch.randn`` over every parameter of both towers, from a generator on
the run's device, then one scale per leaf: He-normal for the convs followed
by a ReLU, LeCun-normal for the last head conv and the SAFA MLPs, small
normal biases. Stored in float32, the type the port keeps its parameters in
(its towers cast to bfloat16 per call). The names and shapes are the
towers' checkpoint layout (``benchmark.reference.towers``), written here from
the configuration's widths; the harness checks them against the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import seeds
from benchmark.work import FOV_HEAD, VGG16_BLOCKS

Shapes = List[Tuple[str, Tuple[int, ...], float]]  # name, shape, std


def vgg_shapes(in_channels: int) -> Shapes:
    out, cin = [], in_channels
    for block in VGG16_BLOCKS:
        for name, co in block:
            out.append((f"vgg.{name}.weight", (co, cin, 3, 3), math.sqrt(2.0 / (9 * cin))))
            out.append((f"vgg.{name}.bias", (co,), 0.05))
            cin = co
    return out


def fov_dsm_shapes(in_channels: int, head_channels) -> Shapes:
    out, cin = vgg_shapes(in_channels), 512
    for (name, _, _, relu), co in zip(FOV_HEAD, head_channels):
        out.append((f"{name}.weight", (co, cin, 3, 3), math.sqrt((2.0 if relu else 1.0) / (9 * cin))))
        out.append((f"{name}.bias", (co,), 0.05))
        cin = co
    return out


def safa_shapes(in_channels: int, in_hw: Tuple[int, int], heads: int, reduction: int) -> Shapes:
    hw = (in_hw[0] // 8) * (in_hw[1] // 8)
    hid = hw // reduction
    return vgg_shapes(in_channels) + [
        ("safa.fc1", (hw, hid, heads), 1.0 / math.sqrt(hw)),
        ("safa.fc1_bias", (hid, heads), 0.1),
        ("safa.fc2", (hid, hw, heads), 1.0 / math.sqrt(hid)),
        ("safa.fc2_bias", (hw, heads), 0.1),
    ]


def tower_shapes(cfg) -> Dict[str, Shapes]:
    """{"surface": shapes, "overhead": shapes} of a FOV-DSM or SAFA config."""
    m, d = cfg.model, cfg.data
    if m.kind == "fov_dsm":
        s = fov_dsm_shapes(m.in_channels, m.head_channels)
        return {"surface": s, "overhead": s}
    if m.kind == "vgg_safa":
        return {"surface": safa_shapes(m.in_channels, (d.surface_height, d.surface_width),
                                       m.num_heads, m.reduction),
                "overhead": safa_shapes(m.in_channels, (d.surface_height, d.surface_width_max),
                                        m.num_heads, m.reduction)}
    raise ValueError(f"no weights for a model of kind {m.kind!r}")


def make(cfg, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Both towers' weights from ``seed``, on ``device``."""
    shapes = tower_shapes(cfg)
    sizes = [math.prod(shape) for tower in ("surface", "overhead") for _, shape, _ in shapes[tower]]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    params, offset = {}, 0
    for tower in ("surface", "overhead"):
        params[tower] = {}
        for name, shape, std in shapes[tower]:
            n = math.prod(shape)
            params[tower][name] = flat[offset:offset + n].view(shape) * std
            offset += n
    return params


def check_layout(params, program_state_dicts) -> None:
    """Raise unless every tower's names and shapes are the program's."""
    for tower, ours in params.items():
        theirs = {k: tuple(v.shape) for k, v in program_state_dicts[tower].items()}
        mine = {k: tuple(v.shape) for k, v in ours.items()}
        if mine != theirs:
            raise ValueError(f"the {tower} tower's weights do not fit the program's: "
                             f"{sorted(set(mine.items()) ^ set(theirs.items()))[:6]}")
