"""Host-side input pipeline: decode, resize, batch and prefetch (port of
witw_tpu/data/loader.py).

The host does only what the device cannot: file decode and the resize to
the canonical geometry; crop, normalization and the polar transform run on
the device (``train.pipeline``). ``PairLoader`` decodes in a worker pool
(threads by default, or processes started with ``spawn``) and a producer
thread keeps ``prefetch`` batches ready. The decoders are imported inside
the functions, in witw_tpu's order (cv2, then imageio, then PIL), so that
importing this module needs only numpy. ``resize_host`` is cv2's
INTER_LINEAR written out in numpy: bilinear with half-pixel centres,
clamped at the edges, no antialiasing.
"""

from __future__ import annotations

import concurrent.futures as futures
import io
import multiprocessing
import os
import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# How the decode pool's processes start. Not "fork": the parent runs torch's
# and the prefetch threads, and a child forked while one of them holds a lock
# can deadlock.
START_METHOD = "spawn"


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


def _fix_channels(img: np.ndarray, channels: int) -> np.ndarray:
    c = img.shape[2]
    if c == channels:
        return img
    if c == 1:
        return np.repeat(img, channels, axis=2)
    if c > channels:
        return img[..., :channels]
    pad = np.zeros((*img.shape[:2], channels - c), img.dtype)
    return np.concatenate([img, pad], axis=2)


def _decode_pair(args):
    """Worker-side decode + resize of one pair. Module-level, so that the
    process pool pickles only this small tuple per item, not the loader."""
    pair, surface_hw, overhead_hw, channels, dtype, skip_errors = args
    try:
        surface = decode_image(pair[0])
        overhead = decode_image(pair[1])
    except Exception:
        if not skip_errors:
            raise
        surface = np.zeros((*surface_hw, channels), np.float32)
        overhead = np.zeros((*overhead_hw, channels), np.float32)
    surface = _fix_channels(resize_host(surface, *surface_hw), channels)
    overhead = _fix_channels(resize_host(overhead, *overhead_hw), channels)
    if dtype == np.uint8:
        surface = np.clip(np.round(surface), 0, 255).astype(np.uint8)
        overhead = np.clip(np.round(overhead), 0, 255).astype(np.uint8)
    else:
        surface = surface.astype(dtype)
        overhead = overhead.astype(dtype)
    return surface, overhead


class PairLoader:
    """Iterates host batches {"surface": [B, H, W, C], "overhead": [B, S, S,
    C], "idx": [B]} of (surface, overhead) path pairs.

    surface_hw / overhead_hw are the canonical decoded geometry shipped to
    the device. Epoch shuffles are seeded (``seed + epoch``, witw_tpu's
    draws); ``drop_last`` mirrors the reference's training loader
    (cvig_fov.py:402). ``dtype=uint8`` (default) quarters the host-to-device
    traffic; the device pipeline casts to f32. ``worker_mode``: "thread"
    (the default, unlike witw_tpu's processes: the decoders and the numpy
    resize release the interpreter lock, and on an 8-core H100 host 8
    threads started in 0.13 s and decoded 740 pairs/s at CVUSA geometry,
    against 10.0 s and 686 for spawned processes; profile_host.py [2]) or
    "process" (START_METHOD). ``skip_errors`` substitutes zero images for
    unreadable files. The worker pool is made once and kept across epochs;
    ``close()`` shuts it down.
    """

    def __init__(
        self,
        pairs: Sequence[Tuple[str, str]],
        batch_size: int,
        surface_hw: Tuple[int, int],
        overhead_hw: Tuple[int, int],
        channels: int = 3,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 2,
        dtype=np.uint8,
        worker_mode: str = "thread",
        skip_errors: bool = False,
    ):
        if worker_mode not in ("process", "thread"):
            raise ValueError(f"worker_mode must be 'process' or 'thread', got {worker_mode!r}")
        self.pairs = list(pairs)
        self.batch_size = batch_size
        self.surface_hw = surface_hw
        self.overhead_hw = overhead_hw
        self.channels = channels
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.dtype = dtype
        self.worker_mode = worker_mode
        self.skip_errors = skip_errors
        self.epoch = 0
        self._pool: Optional[futures.Executor] = None

    def __len__(self) -> int:
        n = len(self.pairs)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _get_pool(self) -> futures.Executor:
        if self._pool is None:
            if self.worker_mode == "process":
                self._pool = futures.ProcessPoolExecutor(
                    self.num_workers, mp_context=multiprocessing.get_context(START_METHOD))
            else:
                self._pool = futures.ThreadPoolExecutor(self.num_workers)
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def order(self, epoch: int) -> np.ndarray:
        """The pair indices of ``epoch``, in reading order."""
        order = np.arange(len(self.pairs))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _batches(self) -> List[List[int]]:
        order = self.order(self.epoch)
        self.epoch += 1
        batches = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                continue
            batches.append(list(idx))
        return batches

    def _decode_batch(self, pool: futures.Executor, batch_idx: List[int]) -> Dict[str, np.ndarray]:
        args = [(self.pairs[i], self.surface_hw, self.overhead_hw, self.channels, self.dtype,
                 self.skip_errors) for i in batch_idx]
        chunk = max(1, len(args) // self.num_workers) if self.worker_mode == "process" else 1
        items = list(pool.map(_decode_pair, args, chunksize=chunk))
        return {"surface": np.stack([s for s, _ in items]),
                "overhead": np.stack([o for _, o in items]),
                "idx": np.asarray(batch_idx, np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        pool = self._get_pool()

        def decoded():
            try:
                for batch_idx in batches:
                    yield self._decode_batch(pool, batch_idx)
            except futures.BrokenExecutor:
                # a dead worker breaks the pool for good: the next epoch
                # gets a fresh one
                self._pool = None
                raise

        return prefetch_iter(decoded(), depth=self.prefetch)


def split_train_val(
    pairs: Sequence[Tuple[str, str]], val_quantity: int, seed: int = 0
) -> Tuple[List, List]:
    """Seeded random train/val split (reference torch.utils.data.random_split,
    cvig_fov.py:401), witw_tpu's draws."""
    order = np.arange(len(pairs))
    np.random.default_rng(seed).shuffle(order)
    val_idx = set(order[:val_quantity].tolist())
    train = [p for i, p in enumerate(pairs) if i not in val_idx]
    val = [p for i, p in enumerate(pairs) if i in val_idx]
    return train, val
