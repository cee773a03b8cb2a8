"""Checkpoint save/restore with best-pointer and resume (port of
witw_tpu/train/checkpoint.py, single process).

The layout is witw_tpu's: ``step_<N>`` periodic checkpoints (the newest
``keep`` kept), ``latest`` (the resume point) and ``best`` (the best
validation loss, the reference's contract, cvig_fov.py:481-487), each with a
``.json`` meta beside it. A checkpoint is one ``torch.save`` file (``.pt``)
of the step, the params, the optimizer state and, when given, generator
states; files are written to a temporary name and renamed, so a reader never
sees half a file. Restoring copies the saved tensors into the state's own,
so on one device a resumed run continues bit for bit.

``restore`` also reads witw_tpu's own checkpoints, ``<name>.msgpack``
(flax.serialization, witw_tpu/train/checkpoint.py:76-77,123-126), where no
``.pt`` of that name exists: their step and params, with a baseline
checkpoint's ``batch_stats`` merged in as the BatchNorm buffers (through
``models.convert_jax``), so that the port serves towers trained by
witw_tpu. Their optax moments are not carried over; the optimizer keeps the
state it has. So ``exists`` and the training resume (``restore_latest``)
count only the port's ``.pt`` files: a run never resumes from a witw_tpu
checkpoint with fresh moments.

With ``async_saves`` (witw_tpu/train/checkpoint.py:47-150) ``save_step``
copies the state to the host synchronously, one consistent snapshot for
both files, then queues the two writes and the retention ``_gc`` on one
background thread,
so training overlaps the disk. ``wait()`` joins the queue and re-raises a
failed write (a failed future stays queued until then); ``restore``,
``load``, ``exists`` and ``meta`` wait first, ``save_best`` and ``save``
block, and ``train.loop.train`` waits before it returns, so its last save
is on disk. ``close()`` waits and stops the thread.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Dict, List, Optional

import torch

from witw_tpu_torch.models.convert_jax import jax_params_to_state_dict
from witw_tpu_torch.train.pipeline import TrainState
from witw_tpu_torch.utils.msgpack import restore_flax_state


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _host_copy(obj: Any) -> Any:
    """``obj`` with every tensor copied to the CPU (a copy also where it is
    on the CPU already: later steps update the state in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_saves: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_saves = async_saves
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def _submit(self, fn) -> None:
        """Queue ``fn`` on the writer thread, dropping finished futures but
        keeping failed ones for :meth:`wait` to raise."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="checkpoint-writer")
        self._pending = [f for f in self._pending if not f.done() or f.exception() is not None]
        self._pending.append(self._executor.submit(fn))

    def wait(self) -> None:
        """Block until every queued write has finished; re-raise the first
        that failed."""
        for f in self._pending:
            f.result()
        self._pending = []

    def close(self) -> None:
        """Wait for the queued writes, then stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown()
                self._executor = None

    def save(self, name: str, state: TrainState, meta: Optional[dict] = None,
             generators: Optional[Dict[str, torch.Generator]] = None) -> str:
        """Write ``name`` (the step, params, optimizer state and
        ``generators``' states) before returning."""
        return self._write(name, self._snapshot(state, generators), meta)

    @staticmethod
    def _snapshot(state: TrainState, generators=None) -> Dict[str, Any]:
        return _host_copy({
            "step": state.step,
            "params": state.params,
            "optimizer": state.optimizer.state_dict(),
            "generators": {k: g.get_state() for k, g in (generators or {}).items()},
        })

    def _write(self, name: str, payload: Dict[str, Any], meta: Optional[dict]) -> str:
        path = self._path(name)
        _write_atomic(path, lambda tmp: torch.save(payload, tmp))
        if meta is not None:
            def write_meta(tmp):
                with open(tmp, "w") as f:
                    json.dump(meta, f)

            _write_atomic(os.path.join(self.directory, f"{name}.json"), write_meta)
        return path

    def _flax_path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.msgpack")

    def load(self, name: str) -> Dict[str, Any]:
        """The raw payload of ``name`` (tensors on the CPU). A witw_tpu
        ``.msgpack`` checkpoint gives its step and params in the port's
        layout (its ``batch_stats`` as the BatchNorm buffers), and no
        optimizer state."""
        self.wait()
        if not os.path.exists(self._path(name)) and os.path.exists(self._flax_path(name)):
            with open(self._flax_path(name), "rb") as f:
                tree = restore_flax_state(f.read())
            return {"step": int(tree["step"]),
                    "params": jax_params_to_state_dict(tree["params"],
                                                       tree.get("batch_stats") or None)}
        return torch.load(self._path(name), map_location="cpu", weights_only=True)

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Copy ``name``'s step, params and optimizer state (a witw_tpu
        checkpoint has none) into ``state`` (which keeps its devices) and
        return it."""
        payload = self.load(name)
        with torch.no_grad():
            for tower, saved in payload["params"].items():
                own = state.params[tower]
                if set(saved) != set(own):
                    raise ValueError(f"checkpoint {name!r} does not fit the {tower} tower")
                for k, v in saved.items():
                    own[k].copy_(v)
        if "optimizer" in payload:
            state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def meta(self, name: str) -> Optional[dict]:
        self.wait()
        p = os.path.join(self.directory, f"{name}.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def exists(self, name: str) -> bool:
        """Whether the port's own ``<name>.pt`` exists."""
        self.wait()
        return os.path.exists(self._path(name))

    # ---- training protocol ----

    def save_step(self, state: TrainState, step: int, meta: Optional[dict] = None) -> None:
        meta = dict(meta or {}, step=step)
        payload = self._snapshot(state)  # one host copy for both files
        jobs = [lambda n=n: self._write(n, payload, meta) for n in (f"step_{step}", "latest")]
        for job in jobs + [self._gc]:
            if self.async_saves:
                self._submit(job)
            else:
                job()

    def save_best(self, state: TrainState, val_loss: float, step: int) -> None:
        """New best validation loss (reference contract, cvig_fov.py:481-487)."""
        self.save("best", state, {"val_loss": val_loss, "step": step})

    def best_val_loss(self) -> Optional[float]:
        m = self.meta("best")
        return None if m is None else m.get("val_loss")

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        """The resume point, or None when there is no ``latest``."""
        if not self.exists("latest"):
            return None
        return self.restore("latest", state)

    def _gc(self) -> None:
        steps = sorted(
            int(f[5:-3])
            for f in os.listdir(self.directory)
            if f.startswith("step_") and f.endswith(".pt")
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            for ext in (".pt", ".json"):
                p = os.path.join(self.directory, f"step_{s}{ext}")
                if os.path.exists(p):
                    os.remove(p)
