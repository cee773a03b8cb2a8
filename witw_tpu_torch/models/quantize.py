"""Int8 serving paths of the FOV-DSM, SAFA and baseline towers (port of
witw_tpu/models/quantize.py): static scales, and the FOV towers' dynamic
scales.

Activation scales are calibrated offline on the f32 tower; each conv then
runs as one int8 conv with an int32 accumulator and one fused per-channel
epilogue that requantizes into the next layer's int8 domain (ReLU folded
into the clip's lower bound); the last head conv dequantizes to f32. Raw
inputs are normalized and quantized first, and the FOV crop and the polar
transform's 4-corner gather run on int8 (``preprocess_static_int8``).

On CUDA tensors the towers run on three hand-written kernels: blocks 1, 3
and 4 and the head through ``ops.int8_conv`` (kernel A), pools 1 and 3
through ``ops.maxpool`` (kernel B), and VGG block 2 through
``ops.fused_block2`` (kernel C). On CPU tensors the same calls compute
their plain PyTorch versions, which the tests hold against witw_tpu.

Tables (``prepare_static_qparams``) keep witw_tpu's keys: per conv
``kernel_q`` (HWIO int8), ``bias_q`` (int32), ``requant_m``, ``dequant``,
``bias_f`` (f32), and ``input_scale``; plus ``kernel_packed``, the int8
[Co, 3, 3, Cin_p] form that the plain versions read, and ``kernel_wgmma``,
the table of kernels A and C (``ops.int8_conv.pack_weights_wgmma``).
A SAFA tower quantizes its VGG trunk the same way
(``include_head=False`` calibration): conv4_3 dequantizes its accumulator
to f32 on kernel A's dequant epilogue (ReLU in f32) and the SAFA head stays
f32 (``quantized_safa_forward_static``).
The baseline towers' seven 4x4 stride-2 VALID convs fit none of those
kernels and have no Pallas kernel in witw_tpu either: each runs as an
im2col of the int8 NHWC input (strided views) and ``torch._int_mm`` (exact
int32 accumulation; cuBLASLt on the card), then one f32 epilogue
(dequant, conv bias, LeakyReLU, the eval-mode BatchNorm affine, requant)
in torch ops (``quantized_baseline_forward_static``).
The dynamic-scale FOV path (``quantize_fov_params``,
``quantized_fov_forward``, ``quantize_pipeline``) quantizes each conv's
input per batch with a per-tensor scale abs-max / 127 computed on the
device (no host sync) and runs every conv, the stride-2 head convs
included, on kernel A's dequant epilogue with the per-batch vector
x_scale * w_scale; ReLU and the 2x2 pools after blocks 1-3 run in f32, as
witw_tpu runs them. Kernel C cannot serve it: conv2_1's output abs-max must
be known before conv2_2's input is quantized.
Not ported here: the TPU lowering variants (``first_conv_bf16``, ``first_conv_w2d``,
``first_conv_im2col``, ``split_block1``, ``block2_w2d``, ``pool_slices``,
``corner_major="p"``).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from witw_tpu_torch.configs.base import FovDsmModelConfig
from witw_tpu_torch.models.baseline import CHANNELS as BASELINE_CHANNELS
from witw_tpu_torch.models.baseline import GEM_FROM, scale_input
from witw_tpu_torch.models.backbones.vgg16 import VGG16_BLOCKS, wrap_pad_width
from witw_tpu_torch.models.convert_jax import state_dict_to_tower
from witw_tpu_torch.models.fov_dsm import HEAD_CONVS, FovDsm
from witw_tpu_torch.models.safa import HEAD_PARAMS, safa_head_apply
from witw_tpu_torch.ops.fov import fov_crop, random_fov_starts
from witw_tpu_torch.ops.fused_block2 import fused_block2
from witw_tpu_torch.ops.image import normalize_images
from witw_tpu_torch.ops.int8_conv import (conv3x3_int8, conv3x3_int8_dequant, pack_weights,
                                          pack_weights_wgmma)
from witw_tpu_torch.ops.maxpool import maxpool2x2
from witw_tpu_torch.ops.polar import grid_tensors

StateDict = Dict[str, torch.Tensor]

TRUNK_ORDER = tuple(f"conv_{i}" for blk in VGG16_BLOCKS for i, _ in blk)
CONV_ORDER = TRUNK_ORDER + tuple(name for name, _, _, _ in HEAD_CONVS)
_RELU = dict({name: True for name in TRUNK_ORDER},
             **{name: relu for name, _, _, relu in HEAD_CONVS})

# Warn when more than this fraction of requantized activations clip at
# +-127 on a held-out batch: the calibration sample did not span the input
# distribution.
SATURATION_WARN_FRACTION = 0.01


@contextlib.contextmanager
def _full_precision_convs():
    """cuDNN convs in full f32 (no TF32) inside the block, whatever the
    global flag says, so that calibrated scales do not depend on it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _module_name(name: str) -> str:
    return f"vgg.{name}" if name in TRUNK_ORDER else name


@torch.no_grad()
def calibrate_fov_activation_scales(state_dict: StateDict, batches: Iterable,
                                    circ_padding: bool = False,
                                    include_head: bool = True) -> Dict[str, float]:
    """Run the f32 tower (the port's ``FovDsm`` on ``state_dict``) over
    calibration batches of normalized NHWC floats, recording the abs-max of
    the input and of every conv's output after its ReLU (the head's last
    conv has none). Returns {'input': s0, 'conv_N': s, ...} with each scale
    max(abs-max, 1e-12) / 127: the scale under a conv's name is the next
    conv's input scale. ``include_head=False`` runs and calibrates the VGG
    trunk alone, from the state dict's ``vgg.*`` entries (the SAFA family:
    trunk int8, head f32). Runs on the state dict's device."""
    batches = list(batches)
    if not batches:
        raise ValueError(
            "calibration requires at least one batch: empty input would "
            "leave every activation scale at its 1e-12 floor and quantize "
            "all activations to +-127"
        )
    w0 = state_dict["vgg.conv_0.weight"]
    device = w0.device
    cfg = FovDsmModelConfig(in_channels=w0.shape[1], compute_dtype="float32")
    model = FovDsm(cfg, circ_padding=circ_padding).eval()
    order = CONV_ORDER if include_head else TRUNK_ORDER
    if include_head:
        run, params = model, state_dict
    else:  # the trunk alone: NHWC in, as the tower takes it
        run = model.vgg
        params = {k[len("vgg."):]: v for k, v in state_dict.items() if k.startswith("vgg.")}
    zero = torch.zeros((), dtype=torch.float32, device=device)
    maxes = {name: zero for name in order}

    def record(name):
        def hook(_module, _inputs, out):
            # abs-max after ReLU is max(max, 0): ReLU follows the conv.
            m = out.amax().clamp_min(0.0) if _RELU[name] else out.abs().amax()
            maxes[name] = torch.maximum(maxes[name], m)
        return hook

    handles = [model.get_submodule(_module_name(n)).register_forward_hook(record(n))
               for n in order]
    in_max = zero
    try:
        with _full_precision_convs():
            for x in batches:
                x = torch.as_tensor(x, dtype=torch.float32).to(device)
                in_max = torch.maximum(in_max, x.abs().amax())
                functional_call(run, params, (x if include_head else x.permute(0, 3, 1, 2),),
                                strict=True)
    finally:
        for h in handles:
            h.remove()
    scales = {"input": max(float(in_max), 1e-12) / 127.0}
    for name, v in maxes.items():
        scales[name] = max(float(v), 1e-12) / 127.0
    return scales


def prepare_static_qparams(state_dict: StateDict,
                           act_scales: Dict[str, float]) -> Dict[str, Any]:
    """Fold weights and calibrated scales into per-conv static tables, in
    numpy: kernel_q int8 [3,3,Ci,Co], bias_q int32 [Co] (the bias in the
    conv's int32 accumulator domain), requant_m f32 [Co] (accumulator ->
    next layer's int8 domain), dequant f32 [Co] (accumulator -> f32, for the
    final conv), bias_f f32 [Co], kernel_packed int8 [Co,3,3,Cin_p] (Cin
    zero-padded to a multiple of 4) for the plain versions, and
    kernel_wgmma (pack_weights_wgmma) for kernels A and C. The same arithmetic as
    witw_tpu's, so equal scales give equal tables."""
    params = state_dict_to_tower(state_dict)
    out: Dict[str, Any] = {"vgg": {}}
    s_in = act_scales["input"]
    prev = s_in
    for name in (k for k in CONV_ORDER if k in act_scales):
        in_vgg = name in params.get("vgg", {})
        kv = params["vgg"][name] if in_vgg else params[name]
        k = np.asarray(kv["kernel"], np.float32)
        nxt = act_scales[name]
        s_w = np.maximum(np.max(np.abs(k), axis=(0, 1, 2)) / 127.0, 1e-12)
        kq = np.clip(np.round(k / s_w), -127, 127).astype(np.int8)
        acc_scale = prev * s_w  # int32 accumulator unit -> f32
        bias_q = np.round(np.asarray(kv["bias"], np.float32) / acc_scale).astype(np.int32)
        (out["vgg"] if in_vgg else out)[name] = {
            "kernel_q": kq,
            "bias_q": bias_q,
            "requant_m": (acc_scale / nxt).astype(np.float32),
            "dequant": acc_scale.astype(np.float32),
            "bias_f": np.asarray(kv["bias"], np.float32),
            "kernel_packed": pack_weights(kq),
            "kernel_wgmma": pack_weights_wgmma(kq),
        }
        prev = nxt
    out["input_scale"] = np.float32(s_in)
    return out


def static_qparams_to_device(tables: Dict[str, Any], device) -> Dict[str, Any]:
    """Tables (numpy arrays or tensors, in dicts and lists) -> the same tree
    of tensors on ``device``."""
    if isinstance(tables, dict):
        return {k: static_qparams_to_device(v, device) for k, v in tables.items()}
    if isinstance(tables, (list, tuple)):
        return [static_qparams_to_device(v, device) for v in tables]
    if isinstance(tables, torch.Tensor):
        return tables.to(device)
    return torch.from_numpy(np.array(tables)).to(device)


def quantize_tower_static(state_dict: StateDict, calib_batches: Iterable,
                          circ_padding: bool) -> Dict[str, Any]:
    """Calibrate one tower on normalized NHWC batches and fold the static
    tables; returns them as tensors on the state dict's device, ready for
    ``quantized_fov_forward_static``."""
    scales = calibrate_fov_activation_scales(state_dict, calib_batches, circ_padding)
    device = state_dict["vgg.conv_0.weight"].device
    return static_qparams_to_device(prepare_static_qparams(state_dict, scales), device)


def quantize_pipeline_static(params: Dict[str, StateDict],
                             calib_batches: Iterable) -> Tuple[Dict, Dict]:
    """Calibrate and fold both towers of ``{"surface": sd, "overhead": sd}``
    params; returns (sq_surface, sq_overhead). ``calib_batches``: iterable
    of (surface_norm, polar_norm) f32 NHWC pairs (preprocessed). The surface
    tower is zero-padded and the overhead tower circular, as in the f32
    pipeline."""
    calib = list(calib_batches)  # a generator must survive both uses
    return (
        quantize_tower_static(params["surface"], [s for s, _ in calib], False),
        quantize_tower_static(params["overhead"], [p for _, p in calib], True),
    )


def quantize_input(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 -> symmetric int8 in the given activation-scale domain:
    clip(round(x / scale), -127, 127), rounding half to even. ``scale`` is a
    0-dim f32 tensor: a true division, also on the GPU (which turns division
    by a Python number into a multiply by its reciprocal)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# Dynamic-scale variant (witw_tpu/models/quantize.py:42-135): int8 weights
# with per-output-channel scales, and per-batch per-tensor activation scales.
# ---------------------------------------------------------------------------


def quantize_fov_params(state_dict: StateDict) -> Dict[str, Any]:
    """A FovDsm state dict -> per conv, in numpy: ``kernel_q`` (HWIO int8,
    per output channel scale = max|w| / 127, floored at 1e-12), ``scale``
    f32 [Co], ``bias`` f32 [Co] (witw_tpu's three), and kernel A's tables
    ``kernel_packed`` and ``kernel_wgmma``; VGG convs under ``vgg``."""
    params = state_dict_to_tower(state_dict)

    def quant(kv):
        k = np.asarray(kv["kernel"], np.float32)
        scale = np.max(np.abs(k), axis=(0, 1, 2)) / 127.0  # per out-channel
        scale = np.maximum(scale, 1e-12)
        q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
        return {"kernel_q": q, "scale": scale.astype(np.float32),
                "bias": np.asarray(kv["bias"], np.float32),
                "kernel_packed": pack_weights(q), "kernel_wgmma": pack_weights_wgmma(q)}

    out: Dict[str, Any] = {"vgg": {name: quant(params["vgg"][name]) for name in TRUNK_ORDER}}
    for name, _, _, _ in HEAD_CONVS:
        out[name] = quant(params[name])
    return out


def quantize_pipeline(params: Dict[str, StateDict]) -> Tuple[Dict, Dict]:
    """Quantize both towers of a FovPipeline's ``{"surface": sd,
    "overhead": sd}`` params; returns (q_surface, q_overhead) as tensors on
    each state dict's device, for :func:`quantized_fov_forward`."""
    return tuple(static_qparams_to_device(quantize_fov_params(params[t]),
                                          params[t]["vgg.conv_0.weight"].device)
                 for t in ("surface", "overhead"))


def _quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor quantization: scale = max(amax|x| /
    127, 1e-12), a 0-dim tensor on x's device (both divisions true ones:
    the card turns division by a host number into a reciprocal product),
    and clip(round(x / scale), -127, 127) as int8."""
    amax = x.abs().amax()
    scale = torch.clamp(amax / torch.full((), 127.0, device=x.device), min=1e-12)
    return quantize_input(x, scale), scale


def _qconv(x_q: torch.Tensor, x_scale: torch.Tensor, qkv: Dict[str, torch.Tensor],
           stride_h: int = 1, pad_w: int = 1) -> torch.Tensor:
    """int8 x int8 -> f32 conv = float(acc) * (x_scale * scale) + bias, on
    kernel A's dequant epilogue (its plain version on the CPU)."""
    dequant = x_scale * qkv["scale"]
    return conv3x3_int8_dequant(x_q, qkv["kernel_packed"], dequant, qkv["bias"], stride_h,
                                pad_w, qkv["kernel_wgmma"])


def _maxpool2x2_f32(h: torch.Tensor) -> torch.Tensor:
    """2 x 2 max pool of f32 NHWC (VALID: an odd last row or column is
    dropped); the result is NHWC and contiguous."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def quantized_fov_forward(qparams: Dict[str, Any], x: torch.Tensor,
                          circ_padding: bool = False) -> torch.Tensor:
    """Dynamic-scale int8 forward of one FOV-DSM tower (inference only).

    x: normalized NHWC floats. Returns the f32 [B, h, w, 16] embedding map,
    as ``FovDsm`` in eval mode. Each block's input (wrap-haloed by
    ``len(block)`` columns in the circular tower, whose convs run
    width-VALID) and each conv output that feeds a conv is quantized with
    its own per-batch scale; the pools after blocks 1-3 run on f32."""
    pad_w = 0 if circ_padding else 1
    h = x.to(torch.float32)
    for block_i, block in enumerate(VGG16_BLOCKS):
        if circ_padding:
            h = wrap_pad_width(h, len(block), dim=2)
        h_q, h_scale = _quantize_act(h)
        for j, (torch_idx, _) in enumerate(block):
            y = torch.relu(_qconv(h_q, h_scale, qparams["vgg"][f"conv_{torch_idx}"], 1, pad_w))
            if j + 1 < len(block):
                h_q, h_scale = _quantize_act(y)
        h = y
        if block_i < 3:
            h = _maxpool2x2_f32(h)
    if circ_padding:
        h = wrap_pad_width(h, len(HEAD_CONVS), dim=2)
    h_q, h_scale = _quantize_act(h)
    for i, (name, _, strides, relu_after) in enumerate(HEAD_CONVS):
        y = _qconv(h_q, h_scale, qparams[name], strides[0], pad_w)
        if relu_after:
            y = torch.relu(y)
        if i + 1 < len(HEAD_CONVS):
            h_q, h_scale = _quantize_act(y)
    return y


def quantized_fov_forward_static(sq: Dict[str, Any], x: torch.Tensor,
                                 circ_padding: bool = False, x_quantized: bool = False,
                                 saturation_out: Optional[List] = None) -> torch.Tensor:
    """Static-scale int8 forward of one FOV-DSM tower (inference only).

    x: normalized NHWC floats, or with ``x_quantized`` int8 already in the
    tower's input-scale domain (``preprocess_static_int8``). Returns the f32
    [B, h, w, 16] embedding map, as ``FovDsm`` in eval mode. The circular
    tower wraps each block's input by ``len(block)`` columns and runs its
    convs width-VALID; the head gets a 3-column halo.

    ``saturation_out``: an optional list; each requant appends (clip hits at
    +-127 as a 0-dim tensor, size). Counting needs every requantized output,
    so block 2 then runs as two plain-epilogue convs and a pool (kernels A,
    A, B) in place of kernel C, which never writes conv2_1's output; the
    results are the same."""
    pad_w = 0 if circ_padding else 1
    h, requant_conv = _int8_input(sq, x, x_quantized, pad_w, saturation_out)
    h = _int8_trunk(sq, h, circ_padding, requant_conv, fuse_block2=saturation_out is None)
    if circ_padding:
        h = wrap_pad_width(h, len(HEAD_CONVS), dim=2)
    for i, (name, _, strides, relu_after) in enumerate(HEAD_CONVS):
        entry = sq[name]
        if i + 1 < len(HEAD_CONVS):
            h = requant_conv(h, entry, strides[0], relu_after)
        else:
            # Final conv: dequantize the accumulator without bias_q and add
            # the float bias, for exactness.
            y = conv3x3_int8_dequant(h, entry["kernel_packed"], entry["dequant"],
                                     entry["bias_f"], strides[0], pad_w, entry["kernel_wgmma"])
            return torch.relu(y) if relu_after else y


def _int8_input(sq, x, x_quantized, pad_w, saturation_out):
    """(The tower's int8 input, its requant conv: kernel A with the tables
    of one conv, counting clip hits into ``saturation_out`` when given)."""
    if x_quantized:
        if x.dtype != torch.int8:
            raise ValueError(f"x_quantized needs an int8 input, got {x.dtype}")
        h = x
    else:
        h = quantize_input(x.to(torch.float32), sq["input_scale"])

    def requant_conv(h, entry, stride_h=1, relu=True):
        q = conv3x3_int8(h, entry["kernel_packed"], entry["bias_q"], entry["requant_m"],
                         stride_h, pad_w, relu, entry["kernel_wgmma"])
        if saturation_out is not None:
            saturation_out.append(((q == 127).sum() + (q == -127).sum(), q.numel()))
        return q

    return h, requant_conv


def _int8_trunk(sq, h, circ_padding, requant_conv, fuse_block2, dequant_last=False):
    """The VGG trunk of a static-int8 tower on int8 NHWC ``h``: block 2 on
    kernel C with ``fuse_block2`` (else kernels A, A, B, as counting
    saturation needs: kernel C never writes conv2_1's output), pools after
    blocks 1-3 on kernel B, the other convs on kernel A's requant; the
    circular tower wraps each block's input by ``len(block)`` columns and
    runs its convs width-VALID. Returns int8 conv4_3 outputs, or with
    ``dequant_last`` f32 ones: conv4_3's accumulator dequantized (without
    bias_q) plus the float bias, then ReLU in f32."""
    for block_i, block in enumerate(VGG16_BLOCKS):
        entries = [sq["vgg"][f"conv_{i}"] for i, _ in block]
        if block_i == 1 and fuse_block2:
            e1, e2 = entries
            h = fused_block2(h, e1["kernel_packed"], e1["bias_q"], e1["requant_m"],
                             e2["kernel_packed"], e2["bias_q"], e2["requant_m"],
                             circular=circ_padding, w1_wgmma=e1["kernel_wgmma"],
                             w2_wgmma=e2["kernel_wgmma"])
            continue
        if circ_padding:
            h = wrap_pad_width(h, len(block), dim=2)
        for j, entry in enumerate(entries):
            if dequant_last and block_i == len(VGG16_BLOCKS) - 1 and j == len(entries) - 1:
                y = conv3x3_int8_dequant(h, entry["kernel_packed"], entry["dequant"],
                                         entry["bias_f"], 1, 0 if circ_padding else 1,
                                         entry["kernel_wgmma"])
                return torch.relu(y)
            h = requant_conv(h, entry)
        if block_i < 3:
            h = maxpool2x2(h)
    return h


def quantized_safa_forward_static(sq: Dict[str, Any], head_params, x: torch.Tensor,
                                  circ_padding: bool = False, x_quantized: bool = False,
                                  saturation_out: Optional[List] = None) -> torch.Tensor:
    """Static-scale int8 forward of one SAFA tower (inference only): the
    int8 VGG trunk (as :func:`quantized_fov_forward_static`'s), conv4_3's
    accumulator dequantized to f32 on kernel A's dequant epilogue (without
    bias_q, plus the float bias, then ReLU in f32: the head takes
    full-precision features, not 127-level ones), then the f32 SAFA head ->
    unit embedding [B, M·C].

    ``sq``: trunk tables from :func:`quantize_safa_tower_static`;
    ``head_params``: its f32 head {fc1, fc1_bias, fc2, fc2_bias}. Same input
    and ``saturation_out`` contract as the FOV forward."""
    pad_w = 0 if circ_padding else 1
    h, requant_conv = _int8_input(sq, x, x_quantized, pad_w, saturation_out)
    feats = _int8_trunk(sq, h, circ_padding, requant_conv,
                        fuse_block2=saturation_out is None, dequant_last=True)
    return safa_head_apply(head_params, feats)


def quantize_safa_tower_static(state_dict: StateDict, calib_batches: Iterable,
                               circ_padding: bool) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Calibrate one SAFA tower's VGG trunk on normalized NHWC batches and
    fold its static tables; returns (the trunk's tables, the f32 head
    params), on the state dict's device, for
    :func:`quantized_safa_forward_static`."""
    scales = calibrate_fov_activation_scales(state_dict, calib_batches, circ_padding,
                                             include_head=False)
    device = state_dict["vgg.conv_0.weight"].device
    sq = static_qparams_to_device(prepare_static_qparams(state_dict, scales), device)
    head = {k: state_dict[f"safa.{k}"].detach().to(device, torch.float32) for k in HEAD_PARAMS}
    return sq, head


def quantize_safa_pipeline_static(params: Dict[str, StateDict], calib_batches: Iterable):
    """Calibrate and fold both SAFA towers; returns ((sq_s, head_s),
    (sq_o, head_o)). ``calib_batches``: iterable of (surface_norm,
    polar_norm) f32 NHWC pairs, as :func:`quantize_pipeline_static`."""
    calib = list(calib_batches)
    return (
        quantize_safa_tower_static(params["surface"], [s for s, _ in calib], False),
        quantize_safa_tower_static(params["overhead"], [p for _, p in calib], True),
    )


def polar_transform_static_int8(tile_q: torch.Tensor, surface_height: int,
                                surface_width: int) -> torch.Tensor:
    """Polar-map int8 normalized tiles [B, S, S, C] to int8 pseudo-panoramas
    [B, h_s, w_s, C]: the sampling grid of ``ops.polar.polar_grid``, the 4
    int8 corners gathered and blended in f32 (weights sum to 1 inside, 0 at
    boundary samples), then rounded back into the same int8 domain."""
    b, s, s2, c = tile_q.shape
    if s != s2 or tile_q.dtype != torch.int8:
        raise ValueError(f"expected square int8 tiles, got {tile_q.dtype} {tuple(tile_q.shape)}")
    idx, weight, _ = grid_tensors(surface_height, surface_width, s, tile_q.device)
    flat = tile_q.reshape(b, s * s, c)
    out = flat[:, idx[0], :].to(torch.float32) * weight[0, :, None]
    for k in range(1, 4):
        out = out + flat[:, idx[k], :].to(torch.float32) * weight[k, :, None]
    out = torch.clamp(torch.round(out), -127, 127).to(torch.int8)
    return out.reshape(b, surface_height, surface_width, c)


def preprocess_static_int8(data_cfg, sq_s: Dict[str, Any], sq_o: Dict[str, Any], batch,
                           generator: Optional[torch.Generator] = None):
    """The serving path's preprocess, as ``FovPipeline.preprocess`` in int8.

    batch: {'surface': [B, H, W_max, C], 'overhead': [B, S, S, C]} raw
    uint8-scale. Returns (surface_q, polar_q), int8 in each tower's
    input-scale domain, on the tables' device. With ``random_orientation``
    the crop origins come from ``generator`` (a CPU generator seeded 0 when
    None)."""
    d = data_cfg
    device = sq_s["input_scale"].device
    surface = torch.as_tensor(batch["surface"], dtype=torch.float32).to(device)
    overhead = torch.as_tensor(batch["overhead"], dtype=torch.float32).to(device)
    scale_ch = 3 if d.dataset.semantic else None

    surf_q = quantize_input(normalize_images(surface, d.img_mean, d.img_std, scale_ch),
                            sq_s["input_scale"])
    if d.dataset.panorama:
        sw = d.surface_width
        if d.random_orientation:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            starts = random_fov_starts(generator, surface.shape[0], d.surface_width_max, device)
        else:
            starts = torch.zeros(surface.shape[0], dtype=torch.int64, device=device)
        if sw < d.surface_width_max:
            surf_q = fov_crop(surf_q, starts, sw)
        elif d.random_orientation:
            surf_q = fov_crop(surf_q, starts, d.surface_width_max)

    # Plain normalize (no masked bias): the polar gather's weights vanish at
    # boundary samples, so the bias masking of the f32 path comes for free.
    tile_q = quantize_input(normalize_images(overhead, d.img_mean, d.img_std, scale_ch),
                            sq_o["input_scale"])
    polar_q = polar_transform_static_int8(tile_q, d.surface_height, d.surface_width_max)
    return surf_q, polar_q


def static_int8_saturation(sq: Dict[str, Any], x: torch.Tensor,
                           circ_padding: bool = False) -> float:
    """Fraction of requantized activations clipping at +-127 across every
    layer of one static-int8 forward of normalized inputs ``x``: the
    calibration-coverage guard. Near zero on the calibration data itself;
    rising values on held-out data mean the calibration sample did not span
    the input distribution."""
    sats: List = []
    quantized_fov_forward_static(sq, x, circ_padding, saturation_out=sats)
    return _clip_fraction(sats)


def static_int8_saturation_safa(sq_head, x: torch.Tensor, circ_padding: bool = False) -> float:
    """:func:`static_int8_saturation` for a SAFA tower's (sq, head) pair:
    the clip fraction over the int8 trunk's requantized activations."""
    sats: List = []
    quantized_safa_forward_static(sq_head[0], sq_head[1], x, circ_padding, saturation_out=sats)
    return _clip_fraction(sats)


def _clip_fraction(sats: List) -> float:
    hits = sum(int(h) for h, _ in sats)
    total = sum(t for _, t in sats)
    return hits / max(total, 1)


def calibrate_overhead_span(state_dict: StateDict, read_item: Callable[[int], np.ndarray],
                            n: int, sample_size: int,
                            preprocess: Callable[[torch.Tensor], torch.Tensor],
                            quantize_fn: Optional[Callable] = None):
    """Gallery-spanning static-int8 calibration of an overhead tower.

    Samples ``sample_size`` items evenly over [0, n) (witw_tpu's indices:
    np.linspace, cast to int, np.unique), reads each with ``read_item(i) ->
    HWC f32``, preprocesses them together on the tower's device
    (``preprocess``: normalize + polar) and calibrates with
    ``quantize_fn(state_dict, batches, circ_padding)``, the family's static
    folder (default :func:`quantize_tower_static`, the FOV towers'; the SAFA
    family passes :func:`quantize_safa_tower_static`, the baseline family
    its raw-pixel folder). Returns (the static
    tables, {sampled index: the array read}), so that an embed loop need not
    read the sampled items again."""
    calib_idx = np.unique(np.linspace(0, n - 1, min(n, sample_size)).astype(int))
    calib = np.stack([read_item(int(i)) for i in calib_idx])
    items = dict(zip(calib_idx.tolist(), calib))
    device = next(iter(state_dict.values())).device
    polar = preprocess(torch.from_numpy(calib).to(device))
    return (quantize_fn or quantize_tower_static)(state_dict, [polar], True), items


def check_saturation(sq, x: torch.Tensor, circ_padding: bool = True,
                     context: str = "input", saturation_fn: Optional[Callable] = None) -> float:
    """Measure the clip fraction on a held-out batch with ``saturation_fn``
    (default :func:`static_int8_saturation`; a SAFA tower's (sq, head) pair
    takes :func:`static_int8_saturation_safa`) and warn above
    SATURATION_WARN_FRACTION. Returns the fraction."""
    frac = (saturation_fn or static_int8_saturation)(sq, x, circ_padding)
    if frac > SATURATION_WARN_FRACTION:
        warnings.warn(
            f"int8 activation saturation {frac:.2%} exceeds "
            f"{SATURATION_WARN_FRACTION:.2%} — calibration sample may not "
            f"span the {context} distribution; scores may clip"
        )
    return frac


# --- the baseline family's static-int8 path ----------------------------------
# (witw_tpu/models/quantize.py:809-953; reference model/cvig_baseline.py:228-283)

BASELINE_LAYERS = len(BASELINE_CHANNELS)
_INT_MM_MIN_ROWS = 17  # torch._int_mm on the card takes more than 16 rows


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _baseline_bn_affine(state_dict: StateDict, i: int) -> Tuple[np.ndarray, np.ndarray]:
    """Eval-mode BatchNorm of layer ``i`` as a per-channel affine (g, b),
    numpy f32: y = x g + b, witw_tpu's arithmetic."""
    g = _np(state_dict[f"bn{i}.weight"]) / np.sqrt(_np(state_dict[f"bn{i}.running_var"]) + 1e-5)
    b = _np(state_dict[f"bn{i}.bias"]) - _np(state_dict[f"bn{i}.running_mean"]) * g
    return g, b


@torch.no_grad()
def calibrate_baseline_scales(state_dict: StateDict, batches: Iterable,
                              leaky_slope: float = 0.2) -> Dict[Any, float]:
    """The f32 eval-mode tower (convs with TF32 off, each BatchNorm as its
    affine) over raw 0-255 NHWC batches, recording the abs-max of the
    [-1, 1]-scaled input and of each BatchNorm output but the last (the next
    conv's int8 input scale; layer 7's output feeds only the f32 GeM pool).
    Returns {"input": s0, 1: s1, ..., 6: s6}, each max(abs-max, 1e-12) / 127."""
    batches = list(batches)
    if not batches:
        raise ValueError(
            "calibration requires at least one batch: empty input would "
            "leave every activation scale at its 1e-12 floor and quantize "
            "all activations to +-127"
        )
    device = state_dict["conv1.weight"].device
    affine = [tuple(torch.from_numpy(a).to(device)[:, None, None]
                    for a in _baseline_bn_affine(state_dict, i))
              for i in range(1, BASELINE_LAYERS + 1)]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    maxes = {i: zero for i in range(1, BASELINE_LAYERS)}
    in_max = zero
    with _full_precision_convs():
        for x in batches:
            h = scale_input(torch.as_tensor(x).to(device))
            in_max = torch.maximum(in_max, h.abs().amax())
            h = h.permute(0, 3, 1, 2)
            for i in range(1, BASELINE_LAYERS + 1):
                h = F.conv2d(h, state_dict[f"conv{i}.weight"].float(), stride=2) \
                    + state_dict[f"conv{i}.bias"].float()[:, None, None]
                h = torch.where(h >= 0, h, leaky_slope * h)
                g, b = affine[i - 1]
                h = h * g + b
                if i < BASELINE_LAYERS:
                    maxes[i] = torch.maximum(maxes[i], h.abs().amax())
    scales: Dict[Any, float] = {"input": max(float(in_max), 1e-12) / 127.0}
    for i, v in maxes.items():
        scales[i] = max(float(v), 1e-12) / 127.0
    return scales


def quantize_baseline_tower_static(state_dict: StateDict, calib_batches: Iterable,
                                   leaky_slope: float = 0.2) -> Dict[str, Any]:
    """Calibrate one baseline tower (its weights and BatchNorm buffers) on
    raw 0-255 NHWC batches and fold the static tables of
    :func:`quantized_baseline_forward_static`, as tensors on the state
    dict's device: ``input_scale`` and per layer ``kernel_q`` (HWIO int8),
    ``kernel_mm`` (int8 [Co, 16 Cin] in the im2col's (kh, kw, cin) order),
    ``dequant`` (accumulator -> f32), ``bias_f``, ``bn_g``, ``bn_b`` and, but
    for the last layer, ``inv_next`` (f32 -> the next layer's int8 domain).
    Equal scales give witw_tpu's tables."""
    scales = calibrate_baseline_scales(state_dict, calib_batches, leaky_slope)
    prev = scales["input"]
    layers = []
    for i in range(1, BASELINE_LAYERS + 1):
        k = np.ascontiguousarray(np.transpose(_np(state_dict[f"conv{i}.weight"]), (2, 3, 1, 0)))
        s_w = np.maximum(np.max(np.abs(k), axis=(0, 1, 2)) / 127.0, 1e-12)
        g, b = _baseline_bn_affine(state_dict, i)
        kernel_q = np.clip(np.round(k / s_w), -127, 127).astype(np.int8)
        entry = {
            "kernel_q": kernel_q,
            "kernel_mm": np.ascontiguousarray(kernel_q.reshape(-1, kernel_q.shape[3]).T),
            # the conv bias is added in f32 after the dequant: no bias rounding
            "dequant": (prev * s_w).astype(np.float32),
            "bias_f": _np(state_dict[f"conv{i}.bias"]),
            "bn_g": g.astype(np.float32),
            "bn_b": b.astype(np.float32),
        }
        if i < BASELINE_LAYERS:
            entry["inv_next"] = np.float32(1.0 / scales[i])
            prev = scales[i]
        layers.append(entry)
    device = state_dict["conv1.weight"].device
    return static_qparams_to_device({"input_scale": np.float32(scales["input"]),
                                     "layers": layers}, device)


def conv4x4s2_int8_acc(x: torch.Tensor, kernel_mm: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulator [B, Ho, Wo, Co] of a 4x4 stride-2 VALID conv
    of int8 NHWC ``x`` with ``kernel_mm`` (int8 [Co, 16 Cin]): the im2col of
    strided views, then ``torch._int_mm`` against the kernel's transpose
    (column-major, as cuBLASLt's int8 GEMM takes it). Rows are zero-padded to
    the 17 the card's GEMM needs and sliced off."""
    b, h, w, c = x.shape
    co, k = kernel_mm.shape
    if k != 16 * c or k % 8 or co % 8:
        raise ValueError(f"kernel [{co}, {k}] does not fit a 4x4 conv of {c} channels with K and "
                         f"Co multiples of 8")
    ho, wo = (h - 4) // 2 + 1, (w - 4) // 2 + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"a 4x4 stride-2 VALID conv needs an input of at least 4 x 4, got "
                         f"{h} x {w}")
    patches = x.unfold(1, 4, 2).unfold(2, 4, 2)  # [B, Ho, Wo, C, kh, kw]
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, k)
    m = patches.shape[0]
    if m < _INT_MM_MIN_ROWS:
        patches = torch.cat([patches, patches.new_zeros(_INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(patches, kernel_mm.t())[:m].reshape(b, ho, wo, co)


def quantized_baseline_forward_static(sq: Dict[str, Any], x: torch.Tensor,
                                      gem_power: float = 3.0, leaky_slope: float = 0.2,
                                      saturation_out: Optional[List] = None) -> torch.Tensor:
    """Static-scale int8 forward of one baseline tower (inference only).

    ``x``: raw 0-255 NHWC (the encoder's input); it is scaled to [-1, 1] and
    quantized. Each layer: :func:`conv4x4s2_int8_acc`, then one f32
    epilogue (dequant, conv bias, LeakyReLU, BatchNorm affine), GeM of
    layers 5-7, requant into the next layer's domain. Returns the f32
    [B, 1536] embedding f / ||f||^0.5, as ``BaselineEncoder`` in eval mode.
    ``saturation_out``: an optional list; each requant appends (clip hits at
    +-127 as a 0-dim tensor, size)."""
    h = quantize_input(scale_input(x), sq["input_scale"])
    feats = []
    n = len(sq["layers"])
    for i, entry in enumerate(sq["layers"], start=1):
        acc = conv4x4s2_int8_acc(h, entry["kernel_mm"])
        z = acc.to(torch.float32) * entry["dequant"] + entry["bias_f"]
        z = torch.where(z >= 0, z, leaky_slope * z)
        z = z * entry["bn_g"] + entry["bn_b"]
        if i >= GEM_FROM:
            feats.append(torch.relu(z).pow(gem_power).mean(dim=(1, 2)).pow(1.0 / gem_power))
        if i < n:
            q = torch.clamp(torch.round(z * entry["inv_next"]), -127, 127)
            h = q.to(torch.int8)
            if saturation_out is not None:
                saturation_out.append(((q == 127).sum() + (q == -127).sum(), q.numel()))
    f = torch.cat(feats, dim=1)
    # f / ||f||^0.5 without an epsilon, as the f32 tower
    return f / f.norm(dim=1, keepdim=True).sqrt()


def quantize_baseline_pipeline_static(params: Dict[str, StateDict], calib_batches: Iterable,
                                      leaky_slope: float = 0.2) -> Tuple[Dict, Dict]:
    """Calibrate and fold both baseline towers of ``{"surface": sd,
    "overhead": sd}``; returns (sq_surface, sq_overhead). ``calib_batches``:
    (surface_raw, overhead_raw) NHWC pairs in the encoder's raw-pixel domain,
    after the host geometry, the synced rotation and any orientation-map
    channels (``BaselinePipeline.preprocess``), before the [-1, 1] scaling."""
    calib = list(calib_batches)
    return (
        quantize_baseline_tower_static(params["surface"], [s for s, _ in calib], leaky_slope),
        quantize_baseline_tower_static(params["overhead"], [o for _, o in calib], leaky_slope),
    )


def static_int8_saturation_baseline(sq: Dict[str, Any], x: torch.Tensor,
                                    circ_padding: bool = False) -> float:
    """:func:`static_int8_saturation` for a baseline tower: the clip
    fraction over its requantized activations (``circ_padding`` unused: the
    baseline convs are unpadded, reference cvig_baseline.py:237-239)."""
    sats: List = []
    quantized_baseline_forward_static(sq, x, saturation_out=sats)
    return _clip_fraction(sats)
