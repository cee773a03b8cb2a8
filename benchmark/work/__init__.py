"""Operations and bytes from shapes: the yardstick of the per-layer metrics.

Counts are of the algorithm's work at the cell's shapes, whatever implements
it: a conv's multiply-adds over its real channels (conv1_1's 3, not the 16 a
kernel pads them to), the fused match's f32 correlation counted once (not the
three products of a 3xTF32 split), each input read once and each output
written once. The conv and bound arithmetic is a copy of ``chip_smoke.py``'s
``conv_work`` and ``bound``; the tower walk follows ``tower_calls`` there.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
PEAK_OPS = {
    "bf16": 989e12,
    "tf32": 494.7e12,
    "f32": 67e12,
    "int8": 1979e12,
}
PEAK_BYTES = 3.35e12

# VGG16 conv1_1 .. conv4_3: (name, out channels), 2x2 floor pools after the
# blocks' last convs.
VGG16_BLOCKS: Tuple[Tuple[Tuple[str, int], ...], ...] = (
    (("conv_0", 64), ("conv_2", 64)),
    (("conv_5", 128), ("conv_7", 128)),
    (("conv_10", 256), ("conv_12", 256), ("conv_14", 256)),
    (("conv_17", 512), ("conv_19", 512), ("conv_21", 512)),
)
# FOV-DSM head after conv4_3: (name, out channels, height stride, ReLU).
FOV_HEAD = (("conv_23", 256, 2, True), ("conv_25", 64, 2, True), ("conv_27", 16, 1, False))


class Work(NamedTuple):
    """One layer's work: operations, bytes, and the peak its operations run
    at (a key of PEAK_OPS)."""

    ops: float
    nbytes: float
    peak: str

    def least_s(self) -> float:
        """The least time on the chip: operations at the peak or bytes at
        the memory rate, whichever is longer."""
        return max(self.ops / PEAK_OPS[self.peak], self.nbytes / PEAK_BYTES)

    def ops_s(self) -> float:
        """The operations alone at the peak (the share a utilization counts)."""
        return self.ops / PEAK_OPS[self.peak]


def total(works: Iterable[Work]) -> Dict[str, float]:
    """Sums of a layer's calls: ops, bytes, the least time (each call's own
    bound, summed) and the operations' time at peak."""
    works = list(works)
    return {
        "ops": sum(w.ops for w in works),
        "bytes": sum(w.nbytes for w in works),
        "least_s": sum(w.least_s() for w in works),
        "ops_s": sum(w.ops_s() for w in works),
        "calls": len(works),
    }


def conv_work(b: int, h_out: int, w_out: int, cin: int, co: int, act_bytes: int = 2,
              weight_bytes: int = 2, peak: str = "bf16") -> Work:
    """One 3x3 conv producing [b, h_out, w_out, co] from cin channels:
    2 x multiply-adds; the input (taken at the output's pixels, as a stride-1
    conv's), the output and the weights in ``act_bytes`` / ``weight_bytes``,
    an f32 bias."""
    return Work(2.0 * b * h_out * w_out * co * 9 * cin,
                act_bytes * b * h_out * w_out * (cin + co) + weight_bytes * co * 9 * cin + 4.0 * co,
                peak)


def strided_conv_work(b: int, h_in: int, w_in: int, cin: int, co: int, stride_h: int,
                      act_bytes: int = 2) -> Work:
    """A 3x3 conv of height stride ``stride_h`` (padding 1): its output is
    ceil(h_in / stride_h) rows; the input is read whole once."""
    h_out = (h_in - 1) // stride_h + 1
    return Work(2.0 * b * h_out * w_in * co * 9 * cin,
                act_bytes * b * (h_in * w_in * cin + h_out * w_in * co) + 2.0 * co * 9 * cin
                + 4.0 * co, "bf16")


class TowerConv(NamedTuple):
    name: str
    b: int
    h_in: int
    w_in: int
    cin: int
    co: int
    stride_h: int

    def work(self) -> Work:
        if self.stride_h == 1:
            return conv_work(self.b, self.h_in, self.w_in, self.cin, self.co)
        return strided_conv_work(self.b, self.h_in, self.w_in, self.cin, self.co, self.stride_h)


def vgg_convs(b: int, h: int, w: int, cin: int = 3) -> Tuple[List[TowerConv], Tuple[int, int, int]]:
    """The trunk's ten convs on a [b, h, w, cin] input (the circular tower's
    wrap changes no shape), and its output (h, w, c)."""
    convs = []
    for block_i, block in enumerate(VGG16_BLOCKS):
        for name, co in block:
            convs.append(TowerConv(name, b, h, w, cin, co, 1))
            cin = co
        if block_i < 3:
            h, w = h // 2, w // 2
    return convs, (h, w, cin)


def fov_tower_convs(b: int, h: int, w: int, cin: int = 3) -> List[TowerConv]:
    """A FOV-DSM tower's 13 convs: the trunk, then the head."""
    convs, (h, w, c) = vgg_convs(b, h, w, cin)
    for name, co, stride_h, _ in FOV_HEAD:
        convs.append(TowerConv(name, b, h, w, c, co, stride_h))
        h, c = (h - 1) // stride_h + 1, co
    return convs


def fov_map_shape(h: int, w: int) -> Tuple[int, int, int]:
    """A FOV-DSM tower's output map (h, w, c) for an (h, w) input."""
    convs = fov_tower_convs(1, h, w)
    last = convs[-1]
    return last.h_in, last.w_in, last.co


def batches(n: int, batch: int) -> List[int]:
    """The batch sizes of n items taken ``batch`` at a time (the last ragged)."""
    return [min(batch, n - b0) for b0 in range(0, n, batch)]


def match_work(g: int, q: int, w: int, sw: int, hc: int) -> Work:
    """The fused match on g gallery maps [w, hc] against q queries [sw, hc]:
    the circular correlation's f32 multiply-adds counted once, at the TF32
    tensor peak (the yardstick does not follow the implementation's split);
    both inputs read once, the distance and orientation [g, q] written."""
    return Work(2.0 * g * q * w * sw * hc, 4.0 * (g * w * hc + q * sw * hc) + 8.0 * g * q, "tf32")


def sweep_work(n: int, query_block: int, gallery_chunk: int, w: int, sw: int,
               hc: int) -> List[Work]:
    """The gallery sweep's match calls: every query block against every
    gallery chunk of an n x n paired set."""
    return [match_work(g, q, w, sw, hc)
            for q in batches(n, query_block) for g in batches(n, gallery_chunk)]


def safa_head_work(b: int, hw: int, c: int, heads: int, reduction: int) -> Work:
    """The SAFA head's three products per image (hidden layer, masks,
    mask-weighted sums), at the bf16 peak."""
    hid = hw // reduction
    ops = 2.0 * b * (hw * hid * heads * 2 + hw * heads * c)
    nbytes = 4.0 * b * (hw * c + heads * c) + 4.0 * (2 * hw * hid * heads + hid * heads + hw * heads)
    return Work(ops, nbytes, "bf16")


def euclidean_work(g: int, q: int, d: int) -> Work:
    """The Euclidean rank sweep's product, g x q x d f32 multiply-adds at the
    TF32 peak, as the fused match's."""
    return Work(2.0 * g * q * d, 4.0 * (g + q) * d + 4.0 * g * q, "tf32")


def per_layer(works: Dict[str, Sequence[Work]], repeats: int = 1) -> Dict[str, Dict[str, float]]:
    """{layer: total(...)} with each figure multiplied by ``repeats`` (the
    evals or steps of a window)."""
    out = {}
    for layer, ws in works.items():
        t = total(ws)
        out[layer] = {k: v * repeats for k, v in t.items()}
    return out
