"""Host-side image decode, resize and prefetch (port of the parts of
witw_tpu/data/loader.py that build_index and the serving daemon use).

The decoders are imported inside the functions, in witw_tpu's order (cv2,
then imageio, then PIL), so that importing this module needs only numpy.
``resize_host`` is cv2's INTER_LINEAR written out in numpy: bilinear with
half-pixel centres, clamped at the edges, no antialiasing.
"""

from __future__ import annotations

import io
import os
import queue as queue_mod
import threading
from typing import Iterator

import numpy as np


def _hwc_float(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr.astype(np.float32)


def _cv2_rgb(arr):
    import cv2

    if arr is not None and arr.ndim == 3 and arr.shape[2] == 3:
        return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    if arr is not None and arr.ndim == 3 and arr.shape[2] == 4:
        return cv2.cvtColor(arr, cv2.COLOR_BGRA2RGBA)
    return arr


def decode_image(path: str) -> np.ndarray:
    """Read an image file to HWC float32 (0-255 scale kept): cv2 for
    standard formats, imageio (then PIL) for TIFF and multiband files or
    where cv2 is missing."""
    arr = None
    if os.path.splitext(path)[1].lower() not in (".tif", ".tiff"):
        try:
            import cv2

            cv2.setNumThreads(1)
            arr = _cv2_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
        except Exception:
            arr = None
    if arr is None:
        try:
            import imageio.v3 as iio

            arr = np.asarray(iio.imread(path))
        except Exception:
            from PIL import Image

            with Image.open(path) as im:
                arr = np.asarray(im)
    return _hwc_float(arr)


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode an encoded photo (JPEG, PNG, ...) to HWC float32 RGB, 0-255:
    the serving daemon's request body. cv2, then imageio, then PIL."""
    arr = None
    try:
        import cv2

        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is not None:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    except Exception:
        arr = None
    if arr is None:
        try:
            import imageio.v3 as iio

            arr = np.asarray(iio.imread(data))
        except Exception:
            from PIL import Image

            with Image.open(io.BytesIO(data)) as im:
                arr = np.asarray(im.convert("RGB"))
    arr = _hwc_float(arr)
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    return arr[..., :3]


def _linear_taps(n_in: int, n_out: int):
    """cv2 INTER_LINEAR's source taps along one axis: sample x of the output
    reads input (x + 0.5) n_in / n_out - 0.5, between i0 = floor of it and
    i0 + 1 at weight frac; below 0 it takes pixel 0, at or past n_in - 1
    pixel n_in - 1 (weight 0)."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    frac[low | high] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def resize_host(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of an HWC image (any channel count) to
    [height, width, C] float32, as cv2.resize with INTER_LINEAR."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    x = np.asarray(img, np.float32)
    y0, y1, fy = _linear_taps(x.shape[0], height)
    x0, x1, fx = _linear_taps(x.shape[1], width)
    rows = x[y0] * (1.0 - fy)[:, None, None] + x[y1] * fy[:, None, None]
    out = rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.ascontiguousarray(out)  # C order, as cv2 returns it (the gather leaves another)


_DONE = object()


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Consume ``it`` in a daemon producer thread, yielding its items through
    a bounded queue so production overlaps consumption (file decode beside
    device work). ``depth`` bounds the produced-but-unconsumed items; an
    exception in the producer is raised in the consumer; ``depth=0`` returns
    ``it`` unchanged (the serial path)."""
    if depth <= 0:
        return it

    out_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                if stop.is_set():
                    return
                out_q.put(item)
        except BaseException as err:  # propagate to the consumer
            out_q.put(err)
            return
        out_q.put(_DONE)

    def consume():
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so a blocked producer can observe the stop flag.
            while not out_q.empty():
                out_q.get_nowait()

    return consume()
