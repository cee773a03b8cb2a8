"""The plain reference the benchmark holds the port against.

Plain PyTorch, written from the published descriptions (Shi et al., CVPR 2020
and NeurIPS 2019; IQTLabs/WITW ``model/cvig_fov.py``), not from the port: it
imports neither JAX nor anything of ``witw_tpu`` or ``witw_tpu_torch``, and
takes from a run only the inputs and weights the benchmark made and the
outputs it judges. The towers run in float32 with TF32 off in cuDNN and
cuBLAS (``exact``), the match and the ranks in float64.

``quantize`` is the precision the operands of every conv and product are
rounded to: ``None`` for the reference, :func:`fp8_round` for the control
that stands one precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch

Quantize = Optional[Callable[[torch.Tensor], torch.Tensor]]
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one per-tensor scale (its abs-max to
    448), back in float32: the usual fp8 recipe for a tensor."""
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def apply(quantize: Quantize, x: torch.Tensor) -> torch.Tensor:
    return x if quantize is None else quantize(x)


@contextlib.contextmanager
def exact() -> Iterator[None]:
    """TF32 off in cuBLAS and cuDNN for the body, the flags restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
