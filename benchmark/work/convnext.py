"""Operations and bytes of a ConvNeXt encoder (``benchmark.reference.convnext``)
at a batch and input size, by layer: the yardstick of the Sample4Geo cell's
per-layer metrics.

- ``convnext_mixer``, a block's depthwise conv and LayerNorm: the conv's
  multiply-adds; bytes: the block's input read once (f32, or bf16 where a
  downsample conv made it), the bf16 output written once, the weights.
- ``convnext_mlp``, fc1, GELU, fc2, the layer scale and the residual add:
  the two products' multiply-adds; bytes: the mixer's bf16 output and the
  block's input read once, the f32 output written once, the weights (the
  hidden 4C activations need not leave the chip).
- ``convnext_other``: the stem, the downsamples and the head's pooling and
  LayerNorm, for the whole eval's ``mfu``.

Operations are 2 x multiply-adds at the bf16 peak, whatever runs them; the
LayerNorms', GELU's and adds' elementwise operations are not counted, as
published counts (15.35 G multiply-adds for ConvNeXt-B at 224^2) do not
count them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from benchmark.work import Work

F32, BF16 = 4, 2


def stage_sizes(h: int, w: int, n_stages: int) -> List[Tuple[int, int]]:
    """Each stage's (height, width): the stride-4 stem, then a 2x2 stride-2
    conv without padding before every later stage (sizes round down)."""
    sizes = [(h // 4, w // 4)]
    for _ in range(n_stages - 1):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    return sizes


def encoder_work(b: int, h: int, w: int, depths: Sequence[int], dims: Sequence[int],
                 in_channels: int = 3, kernel: int = 7, mlp_ratio: int = 4
                 ) -> Dict[str, List[Work]]:
    """{layer: one Work a call} of a batch of ``b`` [h, w] images."""
    out: Dict[str, List[Work]] = {"convnext_mixer": [], "convnext_mlp": [], "convnext_other": []}
    sizes = stage_sizes(h, w, len(depths))
    h0, w0 = sizes[0]
    c0 = dims[0]
    # stem: the bf16 image read, its conv's bf16 output read by the LayerNorm,
    # the LayerNorm's f32 output written
    out["convnext_other"].append(Work(
        2.0 * b * h0 * w0 * c0 * 16 * in_channels,
        BF16 * b * h * w * in_channels + (BF16 + F32) * b * h0 * w0 * c0
        + BF16 * c0 * (16 * in_channels + 1) + F32 * 2 * c0, "bf16"))
    for i, ((hi, wi), c, depth) in enumerate(zip(sizes, dims, depths)):
        px = b * hi * wi
        if i > 0:
            hp, wp = sizes[i - 1]
            cp = dims[i - 1]
            out["convnext_other"].append(Work(
                2.0 * px * c * 4 * cp,
                F32 * b * hp * wp * cp + BF16 * px * c + BF16 * c * (4 * cp + 1) + F32 * 2 * cp,
                "bf16"))
        hid = mlp_ratio * c
        for j in range(depth):
            x_bytes = BF16 if (i > 0 and j == 0) else F32
            out["convnext_mixer"].append(Work(
                2.0 * px * c * kernel * kernel,
                (x_bytes + BF16) * px * c + BF16 * c * (kernel * kernel + 1) + F32 * 2 * c,
                "bf16"))
            out["convnext_mlp"].append(Work(
                2.0 * px * 2 * c * hid,
                (BF16 + x_bytes + F32) * px * c + BF16 * (2 * c * hid + hid + c) + F32 * c,
                "bf16"))
    h3, w3 = sizes[-1]
    c3 = dims[-1]
    out["convnext_other"].append(Work(0.0, F32 * b * (h3 * w3 * c3 + c3) + F32 * 2 * c3, "bf16"))
    return out


def multiply_adds(h: int, w: int, depths: Sequence[int], dims: Sequence[int],
                  in_channels: int = 3, kernel: int = 7, mlp_ratio: int = 4) -> float:
    """One image's multiply-adds (convs and linears)."""
    works = encoder_work(1, h, w, depths, dims, in_channels, kernel, mlp_ratio)
    return sum(x.ops for ws in works.values() for x in ws) / 2.0
