"""bf16 3x3 stride-1 convolution + bias (+ReLU), the bf16 towers' conv.

Replaces the Pallas TPU kernels ``exp/pallas_conv3x3.py:conv3x3_bias_relu``
(NHWC) and ``exp/pallas_conv3x3.py:conv3x3_bias_relu_cw`` (the same function
in the TPU-lane layout [B, H, C, W]) with one CUDA C++ kernel for Hopper
(``csrc/conv3x3_bf16.cu``, built by ``witw_tpu_torch.kernels.build``):

    y = bf16(relu(conv(bf16(x), bf16(w)) + bias))    (f32 accumulation, one rounding)

x is NHWC [B, H, W, Cin]; the weight is torch's OIHW [Co, Cin, 3, 3] (the
towers' parameter layout); bias [Co] is added in f32. The height is
zero-padded by 1; the width zero-padded by 1, or wrapped (``circular``).

The kernel is an implicit GEMM on Hopper's warpgroup tensor cores
(``wgmma`` m64nNk16, bf16 in, f32 accumulate) over 256-pixel x N-channel
tiles (N 128, 64 or 16 by Co, :func:`tile_n`; the pixel tile's shape by the
layer's H and W, :func:`tile_shape`); the bias and ReLU that PyTorch runs as
two memory passes after cuDNN's conv are its epilogue. Cin is computed in
multiples of 16 (conv1_1's 3 or 5 channels as 16). :func:`pack_weights` lays
the weights out in the byte order that the kernel's shared memory and its
``wgmma`` descriptor read, and :func:`unpack_weights` is its inverse.

The public function :func:`conv3x3_bias_relu` is differentiable: its forward
computes the plain PyTorch version on CPU tensors and launches the kernel,
or raises, on CUDA tensors; its backward is plain PyTorch in the inputs'
dtype (``aten.convolution_backward``), as the JAX package has no backward
kernel for these convs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from witw_tpu_torch.kernels.build import load_library
from witw_tpu_torch.ops.launch import check_cuda_tensors, check_launch

# Kernel launches since the last reset (the card path's proof of use).
launches = 0

TILE_PIX = 256  # output pixels of one tile
STEP = 16  # input channels per kernel step


def padded_channels(c: int) -> int:
    """Cin rounded up to a multiple of 16 (one wgmma k-step)."""
    return (c + 15) // 16 * 16


def tile_n(co: int) -> int:
    """Output channels per tile: 128 for Co > 64, 64 for 16 < Co <= 64
    (conv1_x), 16 otherwise (conv_27)."""
    return 128 if co > 64 else 64 if co > 16 else 16


def tile_shape(h: int, w: int) -> tuple:
    """(rows, cols) of the 256-pixel output tile, cols in {8, 16, 32}: the
    fewest padded pixels at this H, W, ties to the smallest halo."""
    def cost(cols):
        rows = TILE_PIX // cols
        padded = -(-h // rows) * rows * (-(-w // cols) * cols)
        return padded, (rows + 2) * (cols + 2)
    cols = min((16, 8, 32), key=cost)
    return TILE_PIX // cols, cols


def pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Co, Cin, 3, 3] -> the kernel's bf16 [Co tiles, 9 Cin_p N]
    (N = :func:`tile_n`; Co zero-padded to a multiple of N, Cin to one of 16).
    Per channel tile and per 16-channel step, in the order the kernel copies
    into shared memory: [tap (dy, dx)][N / 8 groups][2 k halves][8 channels]
    [8 k], each 8 x 8 block one 128-byte core matrix of the no-swizzle
    K-major ``wgmma`` B descriptor."""
    co, cin = weight.shape[:2]
    n, cin_p = tile_n(co), padded_channels(cin)
    ct = -(-co // n)
    w = weight.detach().to(torch.bfloat16)
    w = F.pad(w, (0, 0, 0, 0, 0, cin_p - cin, 0, ct * n - co))
    w = w.reshape(ct, n // 8, 8, cin_p // STEP, 2, 8, 9)  # [ct, ng, r, step, kg, k, tap]
    return w.permute(0, 3, 6, 1, 4, 2, 5).reshape(ct, -1).contiguous()


def unpack_weights(packed: torch.Tensor, co: int, cin: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights`: bf16 OIHW [Co, Cin, 3, 3]."""
    n, cin_p = tile_n(co), padded_channels(cin)
    ct = packed.shape[0]
    w = packed.reshape(ct, cin_p // STEP, 9, n // 8, 2, 8, 8)  # [ct, step, tap, ng, kg, r, k]
    w = w.permute(0, 3, 5, 1, 4, 6, 2).reshape(ct * n, cin_p, 3, 3)
    return w[:co, :cin].contiguous()


def pad_width(x: torch.Tensor, circular: bool) -> torch.Tensor:
    """Pad the width of an NCHW tensor by 1 per side: wrapped or zeros."""
    if circular:
        return torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
    return F.pad(x, (1, 1))


def conv3x3_bias_relu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            circular: bool = False, relu: bool = True,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version (exp/pallas_conv3x3.py:conv3x3_reference):
    ``F.conv2d`` in f32 on the bf16-rounded inputs, the width padded (wrapped
    when ``circular``), then +bias, ReLU and one cast. NHWC in and out."""
    xc = x.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    wc = weight.to(torch.bfloat16).to(torch.float32)
    y = F.conv2d(pad_width(xc, circular), wc, padding=(1, 0))
    y = y + bias.to(torch.float32)[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = load_library("conv3x3_bf16")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.witw_conv3x3_bf16.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
    lib.witw_conv3x3_bf16.restype = i32
    return lib


def conv3x3_bias_relu_kernel(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
                             circular: bool = False, relu: bool = True) -> torch.Tensor:
    """Launch the kernel: x bf16 [B, H, W, Cin], w_packed bf16 from
    :func:`pack_weights`, bias f32 [Co] -> bf16 [B, H, W, Co]. ValueError for
    an input the kernel does not take."""
    global launches
    if x.dtype != torch.bfloat16 or w_packed.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise ValueError(f"x and w must be bfloat16 and bias float32, got {x.dtype}, "
                         f"{w_packed.dtype} and {bias.dtype}")
    if x.ndim != 4 or bias.ndim != 1:
        raise ValueError(f"expected x [B, H, W, Cin] and bias [Co], got {tuple(x.shape)} and "
                         f"{tuple(bias.shape)}")
    b, h, wd, c = x.shape
    co, cin_p = bias.shape[0], padded_channels(c)
    n = tile_n(co)
    if co % 8 != 0 or tuple(w_packed.shape) != (-(-co // n), 9 * cin_p * n):
        raise ValueError(f"w {tuple(w_packed.shape)} and bias {tuple(bias.shape)} do not fit x "
                         f"{tuple(x.shape)}: w must be pack_weights' [Co tiles, 9 Cin_p N], "
                         f"Co a multiple of 8")
    rows, cols = tile_shape(h, wd)
    if b * h * wd >= 2 ** 31 or -(-co // n) * -(-h // rows) * -(-wd // cols) * b >= 2 ** 31:
        raise ValueError(f"input {tuple(x.shape)} has too many pixels or tiles for the kernel")
    device = check_cuda_tensors("conv3x3_bf16", x=x, w=w_packed, bias=bias)
    out = torch.empty((b, h, wd, co), dtype=torch.bfloat16, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.witw_conv3x3_bf16(
            x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, c, cin_p, co, n, cols.bit_length() - 1, int(circular), int(relu),
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, err, "conv3x3_bf16")
    launches += 1
    return out


class _Conv3x3BiasReLU(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU tensors.
    Backward: plain PyTorch, in the dtype of x."""

    @staticmethod
    def forward(ctx, x, weight, bias, circular, relu, out_dtype):
        if x.device.type == "cpu":
            out = conv3x3_bias_relu_plain(x, weight, bias, circular, relu, out_dtype)
        else:
            if out_dtype != torch.bfloat16:
                raise ValueError(f"the kernel writes bfloat16, not {out_dtype}")
            out = conv3x3_bias_relu_kernel(x.contiguous(), pack_weights(weight),
                                           bias.detach().to(torch.float32).contiguous(),
                                           circular, relu)
        ctx.save_for_backward(x, weight, out if relu else None)
        ctx.circular = circular
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, out = ctx.saved_tensors
        dtype = x.dtype
        g = grad_out if out is None else grad_out * (out > 0)
        g = g.to(dtype).permute(0, 3, 1, 2)
        xp = pad_width(x.permute(0, 3, 1, 2), ctx.circular)
        gxp, gw, _ = torch.ops.aten.convolution_backward(
            g, xp, weight.to(dtype), None, [1, 1], [1, 0], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        gx = None
        if gxp is not None:
            gx = gxp[..., 1:-1].clone()
            if ctx.circular:  # the wrapped columns came from the far edges
                gx[..., -1] += gxp[..., 0]
                gx[..., 0] += gxp[..., -1]
            gx = gx.permute(0, 2, 3, 1)
        gw = None if gw is None else gw.to(weight.dtype)
        gb = g.sum(dim=(0, 2, 3), dtype=torch.float32).to(ctx.bias_dtype) \
            if ctx.needs_input_grad[2] else None
        return gx, gw, gb, None, None, None


def conv3x3_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      circular: bool = False, relu: bool = True,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NHWC [B, H, W, Cin] -> [B, H, W, Co] = round(relu(conv3x3(x, weight)
    + bias)), differentiable in x, weight (OIHW) and bias. CPU tensors take
    the plain version; CUDA tensors launch the kernel (bfloat16 out) or
    raise ValueError for an input it does not take."""
    return _Conv3x3BiasReLU.apply(x, weight, bias, circular, relu, out_dtype)
