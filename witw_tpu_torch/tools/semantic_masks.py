"""Semantic road-mask precompute for the 4-channel overhead data path, on the
card (port of witw_tpu/tools/semantic_masks.py).

The reference's offline ``augment.py`` runs an external CRESI road-segmentation
checkpoint over every overhead tile, sigmoids + min-max normalizes the
prediction and writes RGB+mask 4-channel uint8 TIFFs into ``cresi_uint8/``
(reference model/augment.py:61-87), consumed by cvig_semantic
(cvig_semantic.py:111-117). The checkpoint is external and not redistributable
(SURVEY.md §2.5), so the segmenter is pluggable:

- any callable taking an (H, W, 3) float32 tensor on the device and giving
  an (H, W) float in [0, 1] (a tensor or an array) can be passed in, e.g.
  ``torch_segmenter`` over a torch road-segmentation checkpoint,
- the built-in fallback is a classical edge/brightness road-likelihood
  heuristic, witw_tpu's cv2 arithmetic in torch ops (8-bit HSV and gray in
  cv2's fixed point, Gaussian blurs with cv2's kernel sizes and
  BORDER_REFLECT_101), so the 4-channel data contract can be produced
  without external weights.

Tiles are read and written on the host; the masks run on ``device`` (the
card unless ``device="cpu"``).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from witw_tpu_torch.models.convert_torch import load_full_module
from witw_tpu_torch.tools.convert_8bit import as_tensor, numpy_percentiles, sorted_stats
from witw_tpu_torch.tools.geotiff import GeoTiff, background_writes
from witw_tpu_torch.utils.device import resolve_device

Segmenter = Callable[[torch.Tensor], object]

# cv2's 8-bit RGB2GRAY: Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
# (opencv-python 5.0's fixed-point coefficients).
_GRAY = (9798, 19235, 3735)
_GRAY_SHIFT = 15
_HSV_SHIFT = 12
# cv2's RGB2HSV saturation divisor table: round((255 << 12) / v).
_SDIV = torch.tensor([0] + [int(np.rint((255 << _HSV_SHIFT) / v)) for v in range(1, 256)])


def _like(result: torch.Tensor, source):
    return result if isinstance(source, torch.Tensor) else result.cpu().numpy()


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(x, (0, 0), sigma) of an [H, W] float32 image: a
    separable kernel of cv2's size for float input (round(8 sigma + 1) | 1),
    edges reflected without repeating the edge pixel (BORDER_REFLECT_101)."""
    k = int(round(sigma * 4 * 2 + 1)) | 1
    r = np.arange(k, dtype=np.float64) - (k - 1) / 2
    taps = np.exp(-(r * r) / (2 * sigma * sigma))
    taps = torch.from_numpy((taps / taps.sum()).astype(np.float32)).to(x.device)
    y = F.pad(x[None, None], (k // 2, k // 2, k // 2, k // 2), mode="reflect")
    y = F.conv2d(y, taps.view(1, 1, 1, k))
    return F.conv2d(y, taps.view(1, 1, k, 1))[0, 0]


def heuristic_road_mask(rgb, device=None):
    """Classical road-likelihood stand-in: low-saturation, mid-brightness,
    locally-smooth pixels score high. Returns float32 [0, 1], a tensor for a
    tensor (on its device), an array for an array (computed on
    ``device``, the card when None)."""
    t = as_tensor(rgb, device)
    rgb8 = t.to(torch.uint8).to(torch.int64)
    v = rgb8.amax(dim=-1)
    diff = v - rgb8.amin(dim=-1)
    s = (diff * _SDIV.to(t.device)[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    sat = s.to(torch.float32) / 255.0
    val = v.to(torch.float32) / 255.0
    gray = ((rgb8[..., 0] * _GRAY[0] + rgb8[..., 1] * _GRAY[1] + rgb8[..., 2] * _GRAY[2]
             + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).to(torch.float32)
    smooth = gaussian_blur(gray, 2.0)
    texture = torch.abs(gray - smooth) / 255.0
    texture = gaussian_blur(texture, 3.0)
    # gray-ish + not too dark/bright + low texture
    score = (1.0 - sat) * torch.exp(-(((val - 0.45) / 0.25) ** 2)) * torch.exp(-texture * 25.0)
    n, order_stats = sorted_stats(score)
    lo, hi = numpy_percentiles(n, (2, 98), np.float32, order_stats)
    mask = torch.clamp((score - float(lo)) / max(float(hi - lo), 1e-6), 0.0, 1.0)
    return _like(mask, rgb)


def normalize_prediction(pred, device=None):
    """Sigmoid + min-max normalize in f64 (reference augment.py:75-79)."""
    p = 1.0 / (1.0 + torch.exp(-as_tensor(pred, device).to(torch.float64)))
    lo, hi = p.min(), p.max()
    return _like((p - lo) / torch.clamp(hi - lo, min=1e-12), pred)


def minmax_normalize(pred, device=None):
    """Min-max normalize an already-activated prediction (the reference
    min-max-normalizes AFTER torch.sigmoid, augment.py:77). float32
    arithmetic like the reference so the subsequent uint8 truncation lands
    on identical integers."""
    p = as_tensor(pred, device).to(torch.float32)
    lo, hi = p.min(), p.max()
    return _like((p - lo) / torch.clamp(hi - lo, min=1e-12), pred)


def torch_segmenter(checkpoint_path: str, device=None) -> Segmenter:
    """Segmenter backed by a user-supplied torch segmentation checkpoint —
    the reference's CRESI path (``torch.load('../fold0_best.pth')``,
    augment.py:61) — on ``device`` (the card when None). The checkpoint must
    deserialize to a full nn.Module (see
    ``models.convert_torch.load_full_module``: ``weights_only=False``, so the file's
    pickled code runs); a bare state_dict raises ValueError.

    Math matches augment.py:72-79: input scaled /255, CHW batch of 1,
    ``torch.sigmoid(model(x))``. The min-max normalization is applied by the
    caller (``precompute_masks(..., minmax=True)``). Single-channel output is
    returned as (H, W) without the reference's latent transpose (for C=1 its
    ``squeeze()``+``moveaxis(0,-1)`` flips H/W on square tiles — a quirk not
    copied, see SURVEY.md §7 'quirks not to copy'); multi-channel output maps
    [C, H, W] -> channel 0.
    """
    device = resolve_device(device)
    model = load_full_module(checkpoint_path, device)

    @torch.no_grad()
    def segment(rgb) -> torch.Tensor:
        x = as_tensor(rgb, device).to(torch.float32) / 255.0
        pred = torch.sigmoid(model(x.permute(2, 0, 1)[None].contiguous()))
        pred = pred.reshape(pred.shape[-3:]) if pred.ndim == 4 else pred
        if pred.ndim == 3:  # [C, H, W]
            pred = pred[0]
        return pred.to(torch.float32)

    return segment


@torch.no_grad()
def precompute_masks(
    overhead_dir: str,
    out_dir: Optional[str] = None,
    segmenter: Optional[Segmenter] = None,
    logits: bool = False,
    minmax: bool = False,
    verbose: bool = True,
    device=None,
) -> int:
    """Write RGB+mask 4-channel uint8 TIFFs into ``<parent>/cresi_uint8/``
    (the directory name cvig_semantic reads, reference cvig_semantic.py:111).
    Each tile's RGB goes to ``device`` (the card when None) as float32 and
    its mask is computed there; the tiles are written on background
    threads.

    ``logits``: the segmenter returns raw logits -> sigmoid + min-max.
    ``minmax``: the segmenter returns probabilities -> min-max only (the
    reference order with a torch checkpoint: sigmoid inside the segmenter,
    then min-max, augment.py:75-79)."""
    device = resolve_device(device)
    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(overhead_dir.rstrip("/")), "cresi_uint8")
    os.makedirs(out_dir, exist_ok=True)
    segmenter = segmenter or heuristic_road_mask
    count = 0
    with background_writes() as write:
        for name in sorted(os.listdir(overhead_dir)):
            if not name.lower().endswith((".tif", ".tiff", ".png", ".jpg")):
                continue
            with GeoTiff(os.path.join(overhead_dir, name)) as tif:
                rgb = torch.from_numpy(tif.read()[..., :3].astype(np.uint8)).to(device)
                gt = tif.geotransform
                epsg = tif.epsg
            mask = torch.as_tensor(segmenter(rgb.to(torch.float32)), device=device)
            if logits:
                mask = normalize_prediction(mask)
            elif minmax:
                mask = minmax_normalize(mask)
            if minmax:
                # reference truncates: (pred*255).type(torch.uint8), augment.py:81-85
                mask8 = (torch.clamp(mask, 0, 1) * 255).to(torch.uint8)
            else:
                mask8 = torch.round(torch.clamp(mask, 0, 1) * 255).to(torch.uint8)
            out = torch.cat([rgb, mask8[..., None]], dim=-1).cpu().numpy()
            write(os.path.join(out_dir, os.path.splitext(name)[0] + ".tif"), out, gt, epsg)
            count += 1
            if verbose and count % 100 == 0:
                print(f"{count} masks written")
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description="Precompute 4-channel road-mask tiles")
    parser.add_argument("--overhead-dir", required=True)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument(
        "--torch-checkpoint", default=None,
        help="path to a torch segmentation checkpoint (full nn.Module, e.g. "
             "CRESI fold0_best.pth — reference augment.py:61; unpickled with "
             "weights_only=False); omit for the built-in heuristic mask",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)
    if args.torch_checkpoint:
        seg = torch_segmenter(args.torch_checkpoint, args.device)
        n = precompute_masks(args.overhead_dir, args.out_dir, segmenter=seg, minmax=True,
                             device=args.device)
    else:
        n = precompute_masks(args.overhead_dir, args.out_dir, device=args.device)
    print(f"wrote {n} masked tiles")


if __name__ == "__main__":
    main()
