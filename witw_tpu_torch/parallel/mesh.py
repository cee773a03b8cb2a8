"""Device mesh, placement helpers and the process layer (port of
witw_tpu/parallel/mesh.py: ``make_mesh``, ``shard_batch``,
``global_batch_from_local``, ``initialize_distributed``).

A mesh is an ordered grid of torch devices of shape (n_data, n_gallery).
Eval and serving repurpose the whole grid for the gallery axis: the gallery
is split into ``mesh.size`` contiguous, equal, zero-padded shards, shard d
on ``mesh.devices[d]``, while queries are replicated to every device. A
batch is split over the data axis, data shard i on the first device of row
i. A mesh may name one device more than once (``[cuda:0, cuda:0]``): shards
are counted by mesh position, never by distinct device, so such a mesh
still holds two shards, both on one card.

Across processes (``initialize_distributed``: a ``torch.distributed``
group), a mesh is every process's local devices in process order, each
process holding an equal, whole number of data rows; a process places,
computes and reads only its own positions (``local_positions``), and the
sharded paths combine the processes' parts through
``parallel.collectives``. ``torch.distributed.DeviceMesh`` is not used: a
mesh here may name one device several times in one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from witw_tpu_torch.parallel.collectives import allgather_object, process_count, process_index

DATA_AXIS = "data"
GALLERY_AXIS = "gallery"


class Mesh:
    """An ordered grid of torch devices, ``n_data`` rows of ``n_gallery``.

    ``devices``: the devices flat, in mesh order (row-major); ``shape``:
    {DATA_AXIS: n_data, GALLERY_AXIS: n_gallery}; ``size``: their product.
    ``processes``: how many processes the positions are dealt to, in equal
    runs of whole data rows in process order; ``process``: the one that
    built this mesh. Two meshes are equal when they list the same devices
    in the same grid over the same processes."""

    axis_names = (DATA_AXIS, GALLERY_AXIS)

    def __init__(self, devices: Sequence, n_data: int, n_gallery: int = 1,
                 processes: int = 1, process: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if n_data < 1 or n_gallery < 1 or n_data * n_gallery != len(self.devices):
            raise ValueError(f"a ({n_data}, {n_gallery}) mesh needs {n_data * n_gallery} "
                             f"devices, got {len(self.devices)}")
        if n_data % processes:
            raise ValueError(f"{n_data} data rows do not deal evenly to {processes} processes")
        self.shape = {DATA_AXIS: n_data, GALLERY_AXIS: n_gallery}
        self.size = len(self.devices)
        self.processes = processes
        self.process = process

    @property
    def local_positions(self) -> range:
        """The mesh positions this process holds."""
        per = self.size // self.processes
        return range(self.process * per, (self.process + 1) * per)

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[d] for d in self.local_positions)

    @property
    def local_data_devices(self) -> tuple:
        """The devices of this process's data shards: the first of each of
        its mesh rows."""
        return self.local_devices[::self.shape[GALLERY_AXIS]]

    @property
    def home(self) -> torch.device:
        """This process's first device: where its results are combined."""
        return self.devices[self.local_positions[0]]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.shape == other.shape and self.processes == other.processes)

    def __hash__(self) -> int:
        return hash((self.devices, tuple(self.shape.values()), self.processes))

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        over = f", {self.processes} processes" if self.processes > 1 else ""
        return f"Mesh([{names}], {self.shape}{over})"


def make_mesh(n_data: int = -1, n_gallery: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (n_data, n_gallery) mesh over ``devices``. In one process the
    default is every CUDA device; a list may repeat a device (the CPU only
    when the caller passes it) and ``n_data`` <= 0 takes as many rows as
    the devices fill. Across processes ``devices`` are this process's own
    (default: its current CUDA device, which ``initialize_distributed``
    sets for NCCL), every process passes as many, and the mesh is all of
    them in process order; every process must call this together (the
    device lists are gathered). RuntimeError without a CUDA device where
    none is passed."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= to build a "
                               "mesh of other devices")
        if process_count() > 1:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_indexed(torch.device(d)) for d in devices]
    processes = process_count()
    if processes > 1:
        devices = _every_process_devices(devices)
    if n_data <= 0:
        n_data = len(devices) // max(n_gallery, 1)
    n = n_data * n_gallery
    if n < 1 or n > len(devices) or (processes > 1 and n != len(devices)):
        raise ValueError(f"a ({n_data}, {n_gallery}) mesh needs {n} devices, "
                         f"{len(devices)} given" + (" (across processes: all of them)"
                                                    if processes > 1 else ""))
    return Mesh(devices[:n], n_data, n_gallery, processes, process_index())


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _every_process_devices(local: List[torch.device]) -> List[torch.device]:
    """Every process's device list, concatenated in process order."""
    every = allgather_object([str(d) for d in local])
    if len({len(names) for names in every}) != 1:
        raise ValueError(f"every process must bring as many devices to a mesh, got "
                         f"{[len(names) for names in every]}")
    return [torch.device(name) for names in every for name in names]


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
    ``device_put``). Returns this process's shards, in mesh order (all of
    them in one process)."""
    t = _host_tensor(x)
    n = t.shape[0]
    if rows is None:
        rows = -(-n // mesh.size)
    if rows * mesh.size < n:
        raise ValueError(f"{mesh.size} shards of {rows} rows cannot hold {n}")
    shards = []
    for d in mesh.local_positions:
        device = mesh.devices[d]
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
    """``x`` on every mesh device this process holds, in mesh order
    (witw_tpu's ``replicated_sharding``). One copy per distinct device:
    positions that name the same device share it."""
    t = _host_tensor(x)
    copies: Dict[torch.device, torch.Tensor] = {}
    for device in mesh.local_devices:
        if device not in copies:
            copies[device] = t.to(device)
    return [copies[device] for device in mesh.local_devices]


def shard_batch(batch: Dict, mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """Split every array of a batch dict over this process's data shards:
    shard i (rows [i b, (i + 1) b) for b = len / its shard count) as
    tensors on ``mesh.local_data_devices[i]`` (in one process, every data
    shard). The batch length must divide by the shard count (the caller
    pads a straggler). Host arrays bound for a CUDA device go through
    pinned memory, copied without blocking on the current stream."""
    devices = mesh.local_data_devices
    host = {k: _host_tensor(v) for k, v in batch.items()}
    n = len(next(iter(host.values())))
    if n % len(devices):
        raise ValueError(f"a batch of {n} does not split over {len(devices)} data shards")
    b = n // len(devices)
    shards = []
    for i, device in enumerate(devices):
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


class GlobalBatch(list):
    """This process's data shards of a global batch (a list of dicts of
    tensors, shard i on ``mesh.local_data_devices[i]``, each with its bool
    "valid" rows) and the global batch's layout: ``start``, the global row
    of this process's first row; ``rows``, the global row count (padding
    included); ``valid``, the global bool mask of real rows [rows] on the
    host. Shard i holds global rows [start + i b, start + (i + 1) b)."""

    def __init__(self, shards: Sequence[Dict[str, torch.Tensor]], start: int, rows: int,
                 valid: torch.Tensor):
        super().__init__(shards)
        self.start = start
        self.rows = rows
        self.valid = valid

    @property
    def count(self) -> int:
        """The global batch's real rows."""
        return int(self.valid.sum())


def global_batch_from_local(batch: Optional[Dict], mesh: Mesh) -> Optional[GlobalBatch]:
    """Multi-process batch assembly (witw_tpu's ``global_batch_from_local``):
    each process passes its own rows of the global batch (host arrays,
    optionally with a bool "valid"; the length must divide over its data
    shards), and gets them back split over its data shards
    (:func:`shard_batch`) with the global layout: its first global row
    (the processes' rows in process order), the global row count and the
    global valid mask. In one process this is :func:`shard_batch` of the
    whole batch, starting at row 0. Across processes every process must
    call it together, one collective carrying every process's row count,
    valid mask and shapes; a process whose loader has ended passes None
    and contributes one all-padding row per data shard, shaped and typed
    as a live process's rows. None, on every process, when no process has
    rows."""
    host = None
    if batch is not None:
        host = {k: _host_tensor(v) for k, v in batch.items()}
        n = len(host["surface"])
        host["valid"] = host.pop("valid", torch.ones(n, dtype=torch.bool)).to("cpu", torch.bool)
    if mesh.processes == 1:
        return None if host is None else GlobalBatch(shard_batch(host, mesh), 0, n, host["valid"])
    mine = None if host is None else (
        host["valid"].numpy(),
        {k: (tuple(v.shape[1:]), str(v.dtype)) for k, v in host.items() if k != "valid"})
    views = allgather_object(mine)
    live = [v for v in views if v is not None]
    if not live:
        return None
    rows = len(mesh.local_data_devices)  # as many on every process
    if host is None:
        host = {k: torch.zeros((rows, *shape), dtype=getattr(torch, dtype.split(".")[-1]))
                for k, (shape, dtype) in live[0][1].items()}
        host["valid"] = torch.zeros(rows, dtype=torch.bool)
    views = [(np.zeros(rows, bool), None) if v is None else v for v in views]
    counts = [len(v[0]) for v in views]
    valid = torch.from_numpy(np.concatenate([v[0] for v in views]))
    return GlobalBatch(shard_batch(host, mesh), sum(counts[:process_index()]), sum(counts), valid)


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None,
                           timeout: float = 600.0) -> None:
    """Join a ``torch.distributed`` group (witw_tpu's
    ``initialize_distributed``). With ``coordinator`` "host:port" the group
    meets there (``tcp://``), ``num_processes`` and ``process_id`` given;
    without one it reads the launcher's environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them).

    ``backend`` is never switched silently: "nccl" (the default where CUDA
    is available) needs a GPU of its own for each process of a host: the
    launcher's LOCAL_RANK names it (ValueError without LOCAL_RANK, or where
    that GPU is not visible: NCCL refuses two ranks on one GPU) and it
    becomes the current device, where every collective runs; "gloo" (the
    default on the CPU, or when asked for) runs every collective on host
    copies. ``timeout``: seconds a collective may wait."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        kwargs = dict(init_method=f"tcp://{coordinator}", world_size=num_processes,
                      rank=process_id)
    else:
        kwargs = dict(init_method="env://")
    if backend == "nccl":
        if "LOCAL_RANK" not in os.environ:
            raise ValueError("NCCL needs LOCAL_RANK, this process's GPU on its host (torchrun "
                             "sets it); pass backend='gloo' to run without one")
        local = int(os.environ["LOCAL_RANK"])
        if not 0 <= local < torch.cuda.device_count():
            raise ValueError(f"NCCL needs a GPU of its own for each process of a host: local "
                             f"rank {local}, {torch.cuda.device_count()} GPUs visible; pass "
                             "backend='gloo' to share a GPU")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout), **kwargs)
