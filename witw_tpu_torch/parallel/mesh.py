"""Device mesh and placement helpers for one process (port of the
single-process part of witw_tpu/parallel/mesh.py).

A mesh is an ordered grid of torch devices of shape (n_data, n_gallery).
Eval and serving repurpose the whole grid for the gallery axis: the gallery
is split into ``mesh.size`` contiguous, equal, zero-padded shards, shard d
on ``mesh.devices[d]``, while queries are replicated to every device. A
batch is split over the data axis, data shard i on the first device of row
i. A mesh may name one device more than once (``[cuda:0, cuda:0]``): shards
are counted by mesh position, never by distinct device, so such a mesh
still holds two shards, both on one card.

``torch.distributed.DeviceMesh`` is not used: it needs process groups, and
everything here runs in one process.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
GALLERY_AXIS = "gallery"


class Mesh:
    """An ordered grid of torch devices, ``n_data`` rows of ``n_gallery``.

    ``devices``: the devices flat, in mesh order (row-major); ``shape``:
    {DATA_AXIS: n_data, GALLERY_AXIS: n_gallery}; ``size``: their product.
    Two meshes are equal when they list the same devices in the same grid."""

    axis_names = (DATA_AXIS, GALLERY_AXIS)

    def __init__(self, devices: Sequence, n_data: int, n_gallery: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if n_data < 1 or n_gallery < 1 or n_data * n_gallery != len(self.devices):
            raise ValueError(f"a ({n_data}, {n_gallery}) mesh needs {n_data * n_gallery} "
                             f"devices, got {len(self.devices)}")
        self.shape = {DATA_AXIS: n_data, GALLERY_AXIS: n_gallery}
        self.size = len(self.devices)

    @property
    def data_devices(self) -> tuple:
        """The device of each data shard: the first of each mesh row."""
        step = self.shape[GALLERY_AXIS]
        return self.devices[::step]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.shape == other.shape)

    def __hash__(self) -> int:
        return hash((self.devices, tuple(self.shape.values())))

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"Mesh([{names}], {self.shape})"


def make_mesh(n_data: int = -1, n_gallery: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (n_data, n_gallery) mesh over ``devices`` (default: every CUDA
    device; RuntimeError when there is none). ``n_data`` <= 0 takes as many
    rows as the devices fill. The CPU is used only when the caller passes
    CPU devices; a list may repeat a device."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= to build a "
                               "mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_data <= 0:
        n_data = len(devices) // max(n_gallery, 1)
    n = n_data * n_gallery
    if n < 1 or n > len(devices):
        raise ValueError(f"a ({n_data}, {n_gallery}) mesh needs {n} devices, "
                         f"{len(devices)} given")
    return Mesh(devices[:n], n_data, n_gallery)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Shard(NamedTuple):
    """One device's part of a gallery: ``rows`` rows from global index
    ``start`` (zero rows past the gallery's end), ``valid`` of them real."""

    data: torch.Tensor  # [rows, ...] on the shard's device
    mask: Optional[torch.Tensor]  # bool [rows]: True for the real rows; None: all real
    start: int
    valid: int

    @property
    def device(self) -> torch.device:
        return self.data.device


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def gallery_shards(x, mesh: Mesh, rows: Optional[int] = None) -> List[Shard]:
    """Split the leading axis of ``x`` (numpy or a tensor) into
    ``mesh.size`` contiguous shards of ``rows`` rows each (default
    ceil(n / mesh.size)), zero-padded past the end, shard d put on
    ``mesh.devices[d]`` (witw_tpu's ``gallery_sharding`` and its
    ``device_put``)."""
    t = _host_tensor(x)
    n = t.shape[0]
    if rows is None:
        rows = -(-n // mesh.size)
    if rows * mesh.size < n:
        raise ValueError(f"{mesh.size} shards of {rows} rows cannot hold {n}")
    shards = []
    for d, device in enumerate(mesh.devices):
        start = d * rows
        part = t[start:start + rows].to(device)
        valid = part.shape[0]
        if valid < rows:
            pad = torch.zeros((rows - valid,) + tuple(t.shape[1:]), dtype=t.dtype, device=device)
            part = torch.cat([part, pad])
        mask = torch.arange(rows, device=device) < valid
        shards.append(Shard(part, mask, start, valid))
    return shards


def placement(shards: Sequence[Shard]) -> List[Dict]:
    """Where each shard lives: its device, first global row, rows held and
    real rows (what tests and logs read)."""
    return [{"device": s.device, "start": s.start, "rows": int(s.data.shape[0]),
             "valid": s.valid} for s in shards]


def replicate(x, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` on every mesh device, in mesh order (witw_tpu's
    ``replicated_sharding``). One copy per distinct device: positions that
    name the same device share it."""
    t = _host_tensor(x)
    copies: Dict[torch.device, torch.Tensor] = {}
    for device in mesh.devices:
        if device not in copies:
            copies[device] = t.to(device)
    return [copies[device] for device in mesh.devices]


def shard_batch(batch: Dict, mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """Split every array of a batch dict over the data axis: data shard i
    (rows [i b, (i + 1) b) for b = len / n_data) as tensors on
    ``mesh.data_devices[i]``. The batch length must divide by n_data (the
    caller pads a straggler). Host arrays bound for a CUDA device go through
    pinned memory, copied without blocking on the current stream."""
    n_data = mesh.shape[DATA_AXIS]
    host = {k: _host_tensor(v) for k, v in batch.items()}
    n = len(next(iter(host.values())))
    if n % n_data:
        raise ValueError(f"a batch of {n} does not split over {n_data} data shards")
    b = n // n_data
    shards = []
    for i, device in enumerate(mesh.data_devices):
        part = {}
        for k, v in host.items():
            v = v[i * b:(i + 1) * b]
            if device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory().to(device, non_blocking=True)
            else:
                v = v.to(device)
            part[k] = v
        shards.append(part)
    return shards
