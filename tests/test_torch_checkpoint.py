"""The port's ``Checkpointer(async_saves=True)`` (witw_tpu_torch.train.checkpoint;
witw_tpu/train/checkpoint.py:47-150), on the CPU, in one process.

The background writes are held back by a gate in ``_write_atomic`` where a
test needs them in flight; every wait on the gate has a timeout. Checked:
``save_step`` returns while its writes are queued and they hold the state as
it was when saved, not as later steps change it in place; ``wait`` re-raises
a failed write (and so do ``restore`` and ``exists``); ``restore_latest``
sees the last queued save; the keep-N garbage collection holds; ``save_best``
blocks; ``loop.train`` with async saves leaves its last save on disk when it
returns and resumes bit for bit, and a write that fails in ``loop.train``
is raised after its signal handlers are put back; ``cli.common.run_train``
passes ``cfg.train.async_checkpoints`` on and closes its writer and loaders
when the checkpointer's ``close`` raises.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import shutil
import signal
import threading

import numpy as np
import pytest
import torch

from witw_tpu_torch.cli import common
from witw_tpu_torch.configs import (DataConfig, DatasetConfig, ExperimentConfig,
                                    FovDsmModelConfig, OptimConfig, TrainConfig)
from witw_tpu_torch.train import checkpoint as ckpt_mod
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import FovPipeline, TrainState

GATE_TIMEOUT = 30.0


def _cfg(**train):
    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    return ExperimentConfig(
        data=DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32,
                        fov=360, random_orientation=False),
        model=FovDsmModelConfig(compute_dtype="float32", dropout_rate=0.0),
        train=TrainConfig(batch_size=3, optim=OptimConfig(learning_rate=1e-5), **train),
    )


def _state(seed=0):
    """A small train state: two towers of two params, Adam over one."""
    gen = torch.Generator().manual_seed(seed)
    params = {t: {"vgg.conv_0.weight": torch.randn(8, 3, 3, 3, generator=gen),
                  "conv_27.bias": torch.randn(16, generator=gen)} for t in ("surface", "overhead")}
    opt = torch.optim.Adam([params["surface"]["conv_27.bias"]], lr=1e-3)
    params["surface"]["conv_27.bias"].grad = torch.ones(16)
    opt.step()  # the optimizer holds moments
    return TrainState(step=0, params=params, optimizer=opt)


def _bump(state, step):
    """A stand-in for a train step: every param changed in place."""
    with torch.no_grad():
        for p in state.params.values():
            for v in p.values():
                v.add_(1.0)
    state.step = step
    return state


def _first(state):
    return state.params["surface"]["vgg.conv_0.weight"]


@pytest.fixture
def gate(monkeypatch):
    """Hold every step_* / latest write until ``gate.set()``."""
    ev = threading.Event()
    real = ckpt_mod._write_atomic

    def gated(path, write):
        name = path.rsplit("/", 1)[-1]
        if name.startswith(("step_", "latest")):
            assert ev.wait(GATE_TIMEOUT), "the gate was never opened"
        real(path, write)

    monkeypatch.setattr(ckpt_mod, "_write_atomic", gated)
    yield ev
    ev.set()


def test_async_save_overlaps_and_snapshots(tmp_path, gate):
    ck = Checkpointer(str(tmp_path), keep=3, async_saves=True)
    state = _state()
    saved = _first(state).clone()
    ck.save_step(state, 1)  # returns with both writes held at the gate
    assert not (tmp_path / "step_1.pt").exists() and not (tmp_path / "latest.pt").exists()
    _bump(state, 2)  # the next step changes the params in place
    ck.save_best(state, 0.5, 2)  # a blocking save, beside the queued ones
    assert (tmp_path / "best.pt").exists() and (tmp_path / "best.json").exists()
    gate.set()
    ck.wait()
    assert torch.equal(ck.load("step_1")["params"]["surface"]["vgg.conv_0.weight"], saved)
    assert torch.equal(ck.load("best")["params"]["surface"]["vgg.conv_0.weight"], saved + 1)
    assert ck.meta("latest") == {"step": 1} and ck.best_val_loss() == 0.5
    ck.close()


def test_restore_latest_sees_the_last_queued_save_and_gc_keeps_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_saves=True)
    state = _state()
    for step in (1, 2, 3, 4):
        ck.save_step(_bump(state, step), step, {"epoch": step})
    want = _first(state).clone()
    fresh = _state(seed=1)
    assert ck.restore_latest(fresh) is fresh  # waits for the queue first
    assert fresh.step == 4 and torch.equal(_first(fresh), want)
    assert ck.meta("latest") == {"epoch": 4, "step": 4}
    assert sorted(f.name for f in tmp_path.glob("step_*")) == \
        ["step_3.json", "step_3.pt", "step_4.json", "step_4.pt"]
    ck.close()


def test_wait_reraises_a_failed_write(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), keep=3, async_saves=True)
    real = ckpt_mod._write_atomic

    def failing(path, write):
        if "step_2" in path:
            raise OSError("disk full")
        real(path, write)

    monkeypatch.setattr(ckpt_mod, "_write_atomic", failing)
    state = _state()
    ck.save_step(state, 1)
    ck.save_step(state, 2)  # queued: the failure shows on the writer thread only
    ck.save_step(state, 3)  # later saves prune finished futures, not the failed one
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    with pytest.raises(OSError, match="disk full"):
        ck.exists("latest")
    with pytest.raises(OSError, match="disk full"):
        ck.restore("latest", _state())
    with pytest.raises(OSError, match="disk full"):
        ck.close()
    assert ck._executor is None  # closed all the same


def _loaders(seed):
    rng = np.random.default_rng(seed)

    def batch():
        return {"surface": rng.uniform(0, 255, (3, 32, 64, 3)).astype(np.float32),
                "overhead": rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)}

    return [batch() for _ in range(2)], [batch()]


def test_train_with_async_saves_resumes_bitwise(tmp_path):
    """Two epochs straight (synchronous saves) against one epoch with async
    saves, a stop and a resume with async saves: equal params; after each
    ``train`` returns its ``latest`` is on disk without a ``wait``."""
    cfg = _cfg(seed=3)
    train_loader, val_loader = _loaders(0)
    straight = loop.train(cfg, FovPipeline(cfg, "cpu"), train_loader, val_loader, num_epochs=2,
                          checkpointer=Checkpointer(str(tmp_path / "straight"), keep=1),
                          verbose=False)
    for epochs in (1, 2):
        ck = Checkpointer(str(tmp_path / "async"), keep=1, async_saves=True)
        resumed = loop.train(cfg, FovPipeline(cfg, "cpu"), train_loader, val_loader,
                             num_epochs=epochs, checkpointer=ck, verbose=False)
        assert not ck._pending
        assert (tmp_path / "async" / f"step_{2 * epochs}.pt").exists()
        ck.close()
    assert resumed.step == straight.step == 4
    for tower, p in straight.params.items():
        for k, v in p.items():
            assert torch.equal(v, resumed.params[tower][k]), (tower, k)
    assert sorted(f.name for f in (tmp_path / "async").glob("step_*")) == \
        ["step_4.json", "step_4.pt"]
    shutil.rmtree(tmp_path)  # full-width checkpoints: leave none behind in the temp dir


def test_run_train_passes_async_checkpoints(tmp_path, monkeypatch):
    made = []

    class Recording(Checkpointer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(common, "Checkpointer", Recording)
    monkeypatch.setattr(common, "read_pair_paths", lambda ds, path: [("o", "s")] * 4)
    monkeypatch.setattr(common, "build_loader", lambda *a, **k: _Closable())
    monkeypatch.setattr(loop, "train", lambda cfg, *a, **k: "trained")
    for flag in (False, True):
        cfg = _cfg(async_checkpoints=flag, val_quantity=1, checkpoint_dir=str(tmp_path / "w"),
                   tensorboard_dir=str(tmp_path / "runs"))
        assert common.run_train(cfg, "tag", device="cpu") == "trained"
        assert made[-1].async_saves is flag and made[-1]._executor is None


class _Closable(list):
    closed = False

    def close(self):
        self.closed = True


def test_failed_write_in_train_raises_after_restoring_signal_handlers(tmp_path, monkeypatch):
    real = ckpt_mod._write_atomic

    def failing(path, write):
        if "step_2" in path:
            raise OSError("disk full")
        real(path, write)

    monkeypatch.setattr(ckpt_mod, "_write_atomic", failing)
    sigs = (signal.SIGTERM, signal.SIGINT)
    before = [signal.getsignal(s) for s in sigs]
    cfg = _cfg(seed=3)
    train_loader, val_loader = _loaders(0)
    ck = Checkpointer(str(tmp_path), keep=1, async_saves=True)
    with pytest.raises(OSError, match="disk full"):
        loop.train(cfg, FovPipeline(cfg, "cpu"), train_loader, val_loader, num_epochs=1,
                   checkpointer=ck, verbose=False, handle_signals=True)
    assert [signal.getsignal(s) for s in sigs] == before
    with pytest.raises(OSError, match="disk full"):
        ck.close()
    shutil.rmtree(tmp_path)


def test_run_train_closes_writer_and_loaders_when_close_raises(tmp_path, monkeypatch):
    loaders, writers = [], []

    class FailingClose(Checkpointer):
        def close(self):
            super().close()
            raise OSError("disk full")

    class Writer:
        def __init__(self, path):
            self.closed = False
            writers.append(self)

        def close(self):
            self.closed = True

    def build_loader(*args, **kwargs):
        loaders.append(_Closable())
        return loaders[-1]

    monkeypatch.setattr(common, "Checkpointer", FailingClose)
    monkeypatch.setattr(common, "MetricWriter", Writer)
    monkeypatch.setattr(common, "read_pair_paths", lambda ds, path: [("o", "s")] * 4)
    monkeypatch.setattr(common, "build_loader", build_loader)
    monkeypatch.setattr(loop, "train", lambda cfg, *a, **k: "trained")
    cfg = _cfg(async_checkpoints=True, val_quantity=1, checkpoint_dir=str(tmp_path / "w"),
               tensorboard_dir=str(tmp_path / "runs"))
    with pytest.raises(OSError, match="disk full"):
        common.run_train(cfg, "tag", device="cpu")
    assert len(loaders) == 2 and all(x.closed for x in loaders)
    assert len(writers) == 1 and writers[0].closed


def test_sync_saves_stay_synchronous(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1)
    state = _state()
    ck.save_step(state, 1)
    assert (tmp_path / "step_1.pt").exists() and ck._executor is None and not ck._pending
    ck.save_step(_bump(state, 2), 2)
    assert sorted(f.name for f in tmp_path.glob("step_*")) == ["step_2.json", "step_2.pt"]
