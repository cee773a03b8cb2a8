"""The ConvNeXt block's token mixer: the 7x7 depthwise conv with its bias,
then the LayerNorm over channels, on NHWC.

    y = round(LN_c(conv7x7_dw(round(x), round(w)) + bias))

with ``round`` to the compute dtype (bf16: the input and the depthwise
weight as autocast's bf16 conv rounds them, and the output once), products,
sums, the bias and the LayerNorm (the mean, then the biased variance of the
deviations, eps, the affine) in f32, zero padding 3.

A CUDA C++ kernel for Hopper (``csrc/convnext_mixer.cu``, built by
``witw_tpu_torch.kernels.build``) computes it in one pass for bf16: it reads
the block input as stored (f32, or bf16 after a stage's downsample) and
writes the bf16 output, with the conv's f32 sums kept on chip until the
LayerNorm; a cluster of blocks shares a pixel tile, each block a slice of
the channels, and they add their LayerNorm sums through distributed shared
memory; the clusters are persistent, and each copies its next chunk of
input while it computes the one before. It replaces no TPU kernel (the JAX package has no ConvNeXt): it
fuses cuDNN's depthwise conv and ATen's LayerNorm and the casts around them.
The kernel picks its tiling from C, H and W; :func:`geometry` reports it.

:func:`convnext_mixer` computes the plain PyTorch version
(:func:`convnext_mixer_plain`) on CPU tensors and launches the kernel, or
raises, on CUDA tensors. It is differentiable: where a gradient is wanted,
an autograd Function runs the kernel forward and recomputes the plain
version under autograd for the backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

KERNEL = 7
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def convnext_mixer_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, C] in ``dtype``: the input and the
    depthwise weight [C, 1, k, k] rounded to ``dtype``, the conv (padding k
    // 2) in f32, its bias and the LayerNorm in f32, one rounding."""
    c = x.shape[-1]
    xr = x.to(dtype).float().permute(0, 3, 1, 2)
    w = weight.to(dtype).float()
    y = F.conv2d(xr, w, None, padding=w.shape[-1] // 2, groups=c)
    y = y.permute(0, 2, 3, 1) + bias.float()
    return F.layer_norm(y, (c,), ln_weight, ln_bias, eps).to(dtype)


def convnext_mixer_library(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float,
                           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The bf16 block's mixer before the kernel, as autocast ran it in
    PyTorch and cuDNN: the input cast, the depthwise conv with its output in
    ``dtype``, the bias into an f32 upcast, ``F.layer_norm``, the cast. The
    yardstick the kernel is timed against and the blocks' previous output in
    the tests; the port does not call it."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), weight.to(dtype), None,
                 padding=weight.shape[-1] // 2, groups=x.shape[-1])
    y = y.permute(0, 2, 3, 1) + bias
    return F.layer_norm(y, y.shape[-1:], ln_weight, ln_bias, eps).to(dtype)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("convnext_mixer")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_convnext_mixer.argtypes = [ptr, i32] + [ptr] * 5 + [i32] * 4 + [ctypes.c_float, ptr]
    lib.witw_convnext_mixer.restype = i32
    lib.witw_convnext_mixer_geometry.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.witw_convnext_mixer_geometry.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def geometry(c: int, h: int, w: int, dtype: torch.dtype = torch.float32) -> Dict:
    """The kernel's tiling for C channels on an H x W map and an input of
    ``dtype``, as the library chooses it: ``config`` (its tile's index),
    ``tile`` (a cluster's rows and columns of pixels), ``micro`` (a warp's),
    ``tiles`` (a map's, rows by columns), a cluster of ``ranks`` blocks, each
    ``slice`` channels, and a block's ``smem_bytes``. ValueError for an
    input the kernel does not take (C not split into at most 8 slices of 32,
    64 or 128 channels)."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"convnext_mixer takes f32 or bf16 input, got {dtype}")
    out = (ctypes.c_longlong * 8)()
    if _lib().witw_convnext_mixer_geometry(c, h, w, DTYPE_CODES[dtype], out):
        raise ValueError(f"convnext_mixer takes C split into at most 8 slices of 32, 64 or 128 "
                         f"channels, got C {c} ({h} x {w})")
    config, tr, tc, th, tw, ranks, cs, smem = out
    return {"config": config, "tile": (tr, tc), "micro": (th, tw),
            "tiles": (-(-h // tr), -(-w // tc)), "ranks": ranks, "slice": cs,
            "smem_bytes": smem}


def convnext_mixer_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """The kernel on CUDA tensors: x [B, H, W, C] f32 or bf16, the f32
    depthwise weight [C, 1, 7, 7], its bias and the LayerNorm's weight and
    bias [C] -> bf16 [B, H, W, C]. ValueError for an input it does not
    take."""
    global launches
    if x.dtype not in DTYPE_CODES or x.ndim != 4:
        raise ValueError(f"convnext_mixer takes f32 or bf16 [B, H, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    params = {"weight": weight, "bias": bias, "ln_weight": ln_weight, "ln_bias": ln_bias}
    shapes = {"weight": (c, 1, KERNEL, KERNEL), "bias": (c,), "ln_weight": (c,), "ln_bias": (c,)}
    for name, t in params.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shapes[name]:
            raise ValueError(f"convnext_mixer: {name} must be f32 {shapes[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    device = check_cuda_tensors("convnext_mixer", x=x, **params)
    geometry(c, h, w, x.dtype)  # ValueError for a C the kernel does not take
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_convnext_mixer(
            x.data_ptr(), DTYPE_CODES[x.dtype], weight.data_ptr(), bias.data_ptr(),
            ln_weight.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), b, h, w, c, float(eps),
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "convnext_mixer")
    launches += 1
    return out


class _ConvNeXtMixer(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version recomputed under
    autograd."""

    @staticmethod
    def forward(ctx, x, weight, bias, ln_weight, ln_bias, eps):
        ctx.save_for_backward(x, weight, bias, ln_weight, ln_bias)
        ctx.eps = eps
        return convnext_mixer_kernel(x, weight, bias, ln_weight, ln_bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = convnext_mixer_plain(*inputs, ctx.eps)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def convnext_mixer(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   ln_weight: torch.Tensor, ln_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The bf16 mixer of [B, H, W, C] ``x`` (f32 or bf16) -> bf16 [B, H, W,
    C], differentiable in every tensor. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise ValueError for an input it does
    not take."""
    if x.device.type == "cpu":
        return convnext_mixer_plain(x, weight, bias, ln_weight, ln_bias, eps)
    tensors = (x, weight, bias, ln_weight, ln_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ConvNeXtMixer.apply(*tensors, eps)
    return convnext_mixer_kernel(*tensors, eps)
