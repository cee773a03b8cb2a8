"""The port's int8 profiling harness: the counterparts of the root ``exp/``
scripts whose Pallas kernels were measuring tools, under the same module
names. Each module holds its CUDA kernels' wrappers, their plain PyTorch
versions and a ``launches`` count per kernel, and a ``run(device)`` that
prints the JAX script's report lines, timed on the card with CUDA events:

- ``int8_isolate``  — kernel A of the int8 towers (its s8 ``wgmma`` design)
                      with its input copies or its tap-shifted operand
                      removed (``csrc/conv_like.cu``), beside a cuBLAS s8
                      GEMM;
- ``int8_mm_probe`` — the s8 and bf16 rate that ``wgmma`` reaches with
                      resident operands (``csrc/mm_probe.cu``), beside
                      cuBLAS; bf16 also without its whole-dot pass;
- ``mosaic_caps``   — the fused block kernels' layout probes
                      (``csrc/caps.cu``; the s8 dot on ``csrc/mm_probe.cu``).

On the card: ``python3 -m witw_tpu_torch.exp.<module>``.
"""

from __future__ import annotations

from typing import Optional

import torch

from witw_tpu_torch.utils.device import require_cuda


def card(device: Optional[torch.device] = None) -> torch.device:
    """The device a probe runs on: the CUDA device by default
    (RuntimeError without one); ValueError for a device that is not CUDA,
    since the probes time the card."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes time the card; got device {device}")
    return device
