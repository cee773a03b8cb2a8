"""The port's multi-process runtime: two OS processes over Gloo on the CPU
against one process (the counterpart of tests/test_multiprocess.py).

The parent starts this file twice as ``python -m tests.test_torch_multiprocess
worker <rank> <count> <port> <dir>``, with a port from the OS and a timeout
of its own for each child (both are killed when one expires). Each worker
joins the group (``parallel.initialize_distributed``, Gloo), builds a mesh of
its two CPU shards (four over the group) and runs, at tests/mp_common.py's
size, tests/mp_worker.py's contract: ``global_batch_from_local`` of its 4
rows of the global 8; one data-parallel FOV train step (dropout on, the crop
heading drawn); one baseline step on a straggler of 3 (two rows on
one process, one on the other: BatchNorm's statistics cover the processes'
real rows) and one SAFA step; the gallery-resident and the query-split
``FovGalleryEvaluator`` ranks, ``euclidean_ranks`` and both indexes'
``search_sharded`` / ``score_all_sharded`` on planted data; ``loop.embed_all``
and ``test_ranks`` over per-process loaders; ``train(mesh=)`` where one
process's loader ends a step early; a checkpoint save and a
``restore_latest`` broadcast from per-process directories. Process 0 writes
the results the parent holds against the same calls in one process: the
losses within rtol 1e-5, the gradients as tests/test_torch_dp.py holds them
(and the baseline's running buffers),
ranks and top-k indices equal, every process's params and Adam state
bit-identical, both checkpoint checks at max |diff| 0.0.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds per child
N = 16  # gallery and query rows of the rank and index checks
CPU = torch.device("cpu")


def _cfg(batch=8, **train):
    from witw_tpu_torch.configs import (DataConfig, DatasetConfig, EvalConfig,
                                        ExperimentConfig, FovDsmModelConfig, OptimConfig,
                                        TrainConfig)

    ds = DatasetConfig(name="cvusa", train_csv="", test_csv="", panorama=True)
    return ExperimentConfig(
        data=DataConfig(dataset=ds, surface_height=32, surface_width_max=64, overhead_size=32),
        model=FovDsmModelConfig(compute_dtype="float32"),
        train=TrainConfig(batch_size=batch, optim=OptimConfig(learning_rate=1e-4), **train),
        eval=EvalConfig(batch_size=batch, query_block=4),
    )


def _family_cfg(family):
    """The baseline (384 x 416 surfaces and 384² tiles, its BatchNorm) and
    SAFA (the crop heading drawn) at the sizes of tests/test_torch_dp.py,
    f32."""
    import dataclasses

    from witw_tpu_torch.configs import OptimConfig, baseline_experiment, safa_experiment

    if family == "baseline":
        cfg = baseline_experiment("witw")
    else:
        cfg = safa_experiment("cvusa", 90)
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, surface_height=32, surface_width_max=64, overhead_size=32,
            random_orientation=True))
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                       train=dataclasses.replace(cfg.train, optim=OptimConfig(learning_rate=1e-4)))


# the global batch of each family's step: the baseline a straggler of 3 (rows
# 2 and 1 on the two processes, the second process's second shard all padding)
FAMILY_ROWS = {"baseline": (2, 1), "safa": (4, 4)}


def _family_batch(cfg):
    if cfg.model.kind == "baseline":
        s_hw, o_hw = (384, 416), (384, 384)
    else:
        s_hw = (cfg.data.surface_height, cfg.data.surface_width_max)
        o_hw = (cfg.data.overhead_size,) * 2
    rows = sum(FAMILY_ROWS["baseline" if cfg.model.kind == "baseline" else "safa"])
    rng = np.random.default_rng(13)
    return {"surface": rng.uniform(0, 255, (rows, *s_hw, 3)).astype(np.float32),
            "overhead": rng.uniform(0, 255, (rows, *o_hw, 3)).astype(np.float32)}


def _family_step(pipeline, batch):
    """One train step from the seed-0 init; returns (state, loss)."""
    state = pipeline.init_state(torch.Generator().manual_seed(0))
    state, metrics = pipeline.train_step(state, batch, torch.Generator().manual_seed(5))
    return state, float(metrics["loss"])


def _grads(state):
    return {t: {k: p.grad for k, p in state.params[t].items() if p.grad is not None}
            for t in state.params}


def _planted():
    """Gallery maps, queries that are windows of them under noise, lattice
    vectors (exact squared distances in f32) and their noisy queries."""
    rng = np.random.default_rng(7)
    o = rng.standard_normal((N, 1, 8, 16)).astype(np.float32)
    shifts = rng.integers(0, 8, N)
    s = np.stack([o[i][:, (shifts[i] + np.arange(8)) % 8] for i in range(N)])
    s = s + 0.1 * rng.standard_normal(s.shape).astype(np.float32)
    q = np.stack([o[i][:, (i + np.arange(5)) % 8] for i in range(N)])
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    g = rng.integers(-4, 5, (N, 12)).astype(np.float32)
    v = g + rng.integers(-1, 2, (N, 12)).astype(np.float32)
    return o, s, q, g, v


def _loaders(cfg):
    """Two global batches (8 rows, then a straggler of 6) as each of two
    processes reads them, and each process's own train loader: process 0
    has a batch more than process 1."""
    from tests.mp_common import tiny_global_batch

    rng = np.random.default_rng(11)
    eval_global = [tiny_global_batch(cfg)]
    eval_global.append({k: rng.uniform(0, 255, (6,) + v.shape[1:]).astype(np.float32)
                        for k, v in eval_global[0].items()})
    halves = [[{k: v[p * len(v) // 2:(p + 1) * len(v) // 2] for k, v in b.items()}
               for b in eval_global] for p in range(2)]
    train = [[halves[0][0], halves[0][1]], [halves[1][0]]]
    return eval_global, halves, train


def _digest(state) -> str:
    h = hashlib.sha256()
    for tower in sorted(state.params):
        for k in sorted(state.params[tower]):
            h.update(state.params[tower][k].detach().numpy().tobytes())
    for s in state.optimizer.state.values():
        for k in sorted(s):
            h.update(s[k].numpy().tobytes())
    return h.hexdigest()


def _max_diff(a, b) -> float:
    return max(float((a.params[t][k] - b.params[t][k]).abs().max())
               for t in a.params for k in a.params[t])


def worker(process_id: int, count: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from tests.mp_common import tiny_global_batch
    from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, euclidean_ranks
    from witw_tpu_torch.evaluation.index import GalleryIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.parallel import (global_batch_from_local, initialize_distributed,
                                         make_mesh, process_count, process_index)
    from witw_tpu_torch.train import loop
    from witw_tpu_torch.train.checkpoint import Checkpointer
    from witw_tpu_torch.train.pipeline import make_pipeline

    initialize_distributed(f"127.0.0.1:{port}", count, process_id, backend="gloo",
                           timeout=TIMEOUT)
    assert process_count() == count and process_index() == process_id
    assert dist.get_backend() == "gloo"
    mesh = make_mesh(devices=[CPU, CPU])
    assert mesh.size == 2 * count and list(mesh.local_positions) == [2 * process_id,
                                                                     2 * process_id + 1]
    cfg = _cfg()
    pipeline = make_pipeline(cfg, CPU)
    out = {"process_count": process_count()}

    # global batch from this process's rows, one data-parallel step
    batch = tiny_global_batch(cfg)
    rows = cfg.train.batch_size // count
    local = {k: v[process_id * rows:(process_id + 1) * rows] for k, v in batch.items()}
    gb = global_batch_from_local(local, mesh)
    assert (gb.start, gb.rows, gb.count, len(gb)) == (process_id * rows, 8, 8, 2)
    state = pipeline.init_state(torch.Generator().manual_seed(0))
    state, metrics = pipeline.train_step(state, gb, torch.Generator().manual_seed(1))
    out["loss"] = float(metrics["loss"])
    out[f"digest_{process_id}"] = _digest(state)
    if process_id == 0:
        torch.save({t: {k: p.grad for k, p in state.params[t].items() if p.grad is not None}
                    for t in state.params}, os.path.join(workdir, "grads.pt"))

    # the baseline (BatchNorm's statistics over the processes' rows) and SAFA
    for family in FAMILY_ROWS:
        fcfg = _family_cfg(family)
        fpipe = make_pipeline(fcfg, CPU)
        fbatch = _family_batch(fcfg)
        lo = sum(FAMILY_ROWS[family][:process_id])
        hi = lo + FAMILY_ROWS[family][process_id]
        (fgb, _), = list(loop.device_prefetch([{k: v[lo:hi] for k, v in fbatch.items()}], None,
                                              mesh=mesh))
        fstate, out[f"{family}_loss"] = _family_step(fpipe, fgb)
        out[f"{family}_digest_{process_id}"] = _digest(fstate)
        if process_id == 0:
            torch.save({"grads": _grads(fstate),
                        "running": {t: {k: v for k, v in p.items() if "running" in k}
                                    for t, p in fstate.params.items()}},
                       os.path.join(workdir, f"{family}.pt"))

    # ranks and indexes over the processes' shards
    o, s, q, g, v = _planted()
    out["ranks"] = FovGalleryEvaluator(mesh=mesh, query_block=N, gallery_chunk=2,
                                       shard_gallery=True).ranks(o, s).tolist()
    out["ranks_split"] = FovGalleryEvaluator(mesh=mesh, query_block=4,
                                             gallery_chunk=4).ranks(o, s).tolist()
    out["ranks_euclidean"] = euclidean_ranks(g, v, mesh=mesh, block=5).tolist()
    index = GalleryIndex(o, device=CPU)
    index.place_sharded(mesh, gallery_chunk=2, max_k=4)
    top_i, top_d, top_o = index.search_sharded(q, k=3)
    out.update(search_i=top_i.tolist(), search_d=top_d.tolist(), search_o=top_o.tolist(),
               score_all=index.score_all_sharded(q)[0].tolist())
    vindex = VectorIndex(g, device=CPU)
    vindex.place_sharded(mesh, gallery_chunk=3, max_k=4)
    vi, vd = vindex.search_sharded(v, k=3)
    out.update(vsearch_i=vi.tolist(), vsearch_d=vd.tolist(),
               vscore_all=vindex.score_all_sharded(v).tolist())

    # embed_all / test_ranks and train over per-process loaders
    _, halves, train_loaders = _loaders(cfg)
    params = pipeline.init(torch.Generator().manual_seed(3))
    s_emb, o_emb = loop.embed_all(pipeline, params, halves[process_id],
                                  torch.Generator().manual_seed(4), mesh=mesh)
    out["embed_s"], out["embed_o"] = s_emb.tolist(), o_emb.tolist()
    metrics, ranks = loop.test_ranks(cfg, pipeline, halves[process_id], params, verbose=False,
                                     mesh=mesh)
    out["test_ranks"], out["test_metrics"] = ranks.tolist(), metrics
    tcfg = _cfg(4, num_epochs=1)
    ckpt = Checkpointer(os.path.join(workdir, "train"))
    trained = loop.train(tcfg, pipeline, train_loaders[process_id], [halves[process_id][1]],
                         checkpointer=ckpt, verbose=False, mesh=mesh)
    out["train_step"] = trained.step
    out[f"train_digest_{process_id}"] = _digest(trained)
    if process_id == 0:
        torch.save(trained.params, os.path.join(workdir, "trained.pt"))

    # checkpoints: process 0 writes; restore_latest broadcasts its state
    best = Checkpointer(os.path.join(workdir, "ckpt"))
    written = best.save("best", state, {"val_loss": out["loss"], "step": 1})
    assert (written is None) == (process_id != 0)
    own = Checkpointer(os.path.join(workdir, f"ckpt_local_{process_id}"))
    own.save_step(state, 7, {"epoch": 3})
    own.wait()
    assert os.path.isdir(own.directory) == (process_id == 0)
    restored = own.restore_latest(pipeline.init_state(torch.Generator().manual_seed(9)))
    assert restored is not None and restored.step == 1, "restore_latest must find p0's file"
    out[f"restore_latest_max_{process_id}"] = _max_diff(state, restored)
    if process_id == 0:
        back = best.restore("best", pipeline.init_state(torch.Generator().manual_seed(9)))
        out["ckpt_roundtrip_max"] = _max_diff(state, back)

    # every process's view, then process 0 writes them all
    views = [None] * count
    dist.all_gather_object(views, out)
    if process_id == 0:
        merged = dict(views[0])
        for view in views[1:]:
            merged.update({k: val for k, val in view.items() if k not in merged})
        merged["same_on_every_process"] = all(
            view[k] == views[0][k] for view in views[1:] for k in views[0]
            if not k.startswith(("digest", "train_digest", "restore_latest_max",
                                 "ckpt_roundtrip", "baseline_digest", "safa_digest")))
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(merged, f)
    dist.destroy_process_group()
    print(f"WORKER_{process_id}_OK", flush=True)


# --- the parent -------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_workers(workdir, meanwhile, count=2):
    """Start the workers, call ``meanwhile()`` while they run, then wait for
    them (killing both at TIMEOUT); returns (process 0's results, what
    ``meanwhile`` returned)."""
    # The repository for `tests.*`, tests/ for torch_workers, which this file imports first.
    path = [REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    port = _free_port()
    deadline = time.monotonic() + TIMEOUT
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multiprocess", "worker", str(i), str(count),
         str(port), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for i in range(count)]
    outs = []
    try:
        done = meanwhile()
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_{i}_OK" in out, f"worker {i} failed:\n{out}"
    with open(os.path.join(workdir, "result.json")) as f:
        return json.load(f), done


def _reference(workdir):
    """The same calls in this process, on one device and without a group."""
    from tests.mp_common import tiny_global_batch
    from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, euclidean_ranks
    from witw_tpu_torch.evaluation.index import GalleryIndex
    from witw_tpu_torch.evaluation.vector_index import VectorIndex
    from witw_tpu_torch.train import loop
    from witw_tpu_torch.train.checkpoint import Checkpointer
    from witw_tpu_torch.train.pipeline import make_pipeline

    cfg = _cfg()
    pipeline = make_pipeline(cfg, CPU)
    state = pipeline.init_state(torch.Generator().manual_seed(0))
    state, metrics = pipeline.train_step(state, tiny_global_batch(cfg),
                                         torch.Generator().manual_seed(1))
    o, s, q, g, v = _planted()
    index, vindex = GalleryIndex(o, device=CPU), VectorIndex(g, device=CPU)
    top_i, top_d, top_o = index.search(q, k=3)
    vi, vd = vindex.search(v, k=3)
    eval_global, halves, train_loaders = _loaders(cfg)
    params = pipeline.init(torch.Generator().manual_seed(3))
    s_emb, o_emb = loop.embed_all(pipeline, params, eval_global,
                                  torch.Generator().manual_seed(4))
    test_metrics, test_ranks = loop.test_ranks(cfg, pipeline, eval_global, params,
                                               verbose=False)
    joined = [{k: np.concatenate([a[k], b[k]]) for k in a}
              for a, b in zip(train_loaders[0], train_loaders[1])] + train_loaders[0][1:]
    val = [{k: np.concatenate([halves[0][1][k], halves[1][1][k]]) for k in halves[0][1]}]
    trained = loop.train(_cfg(4, num_epochs=1), pipeline, joined, val,
                         checkpointer=Checkpointer(os.path.join(workdir, "ref_train")),
                         verbose=False)
    families = {}
    for family in FAMILY_ROWS:
        fcfg = _family_cfg(family)
        families[family] = _family_step(make_pipeline(fcfg, CPU), _family_batch(fcfg))
    return dict(
        loss=float(metrics["loss"]), state=state, families=families,
        ranks=FovGalleryEvaluator(query_block=4, gallery_chunk=4, device=CPU).ranks(o, s),
        ranks_euclidean=euclidean_ranks(g, v, device=CPU), search=(top_i, top_d, top_o),
        score_all=index.score_all(q)[0], vsearch=(vi, vd), vscore_all=vindex.score_all(v),
        embed=(s_emb, o_emb), test=(test_metrics, test_ranks), trained=trained)


def test_two_processes_match_one(tmp_path):
    # The workers run at this process's thread count: they import
    # torch_workers and inherit this process's environment.
    got, ref = _run_workers(tmp_path, lambda: _reference(tmp_path))
    assert got["process_count"] == 2 and got["same_on_every_process"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    grads = torch.load(tmp_path / "grads.pt")
    for tower, gs in grads.items():
        want = {k: p.grad for k, p in ref["state"].params[tower].items() if p.grad is not None}
        assert set(gs) == set(want)
        gmax = max(float(w.abs().max()) for w in want.values())
        for k, w in want.items():
            assert abs(float(gs[k].norm() / w.norm()) - 1.0) <= 1e-4, (tower, k)
            assert float(((gs[k] - w).abs() - 1e-4 * w.abs()).max()) <= 1e-5 * gmax, (tower, k)
    for family, (want_state, want_loss) in ref["families"].items():
        np.testing.assert_allclose(got[f"{family}_loss"], want_loss, rtol=1e-5)
        assert got[f"{family}_digest_0"] == got[f"{family}_digest_1"], family
        saved = torch.load(tmp_path / f"{family}.pt")
        want = _grads(want_state)
        for tower, gs in saved["grads"].items():
            gmax = max(float(w.abs().max()) for w in want[tower].values())
            atol = (3e-5 if family == "baseline" else 1e-5) * gmax
            assert set(gs) == set(want[tower]), (family, tower)
            for k, w in want[tower].items():
                assert abs(float(gs[k].norm() / w.norm()) - 1.0) <= 1e-4, (family, tower, k)
                assert float(((gs[k] - w).abs() - 1e-4 * w.abs()).max()) <= atol, (
                    family, tower, k)
            for k, w in want_state.params[tower].items():
                if "running" in k:  # BatchNorm's buffers from the global statistics
                    got_buf = saved["running"][tower][k]
                    excess = float(((got_buf - w).abs() - 1e-5 * w.abs()).max())
                    assert excess <= 1e-5 * float(w.abs().max()), (family, tower, k)
    assert got["digest_0"] == got["digest_1"]  # bit-identical params and Adam moments
    assert got["train_digest_0"] == got["train_digest_1"]
    for key in ("ranks", "ranks_split"):
        np.testing.assert_array_equal(got[key], ref["ranks"])
    np.testing.assert_array_equal(got["ranks_euclidean"], ref["ranks_euclidean"])
    assert len(set(ref["ranks"].tolist())) > 1 or ref["ranks"].max() == 1
    np.testing.assert_array_equal(got["search_i"], ref["search"][0])
    np.testing.assert_allclose(got["search_d"], ref["search"][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["search_o"], ref["search"][2])
    np.testing.assert_allclose(got["score_all"], ref["score_all"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["vsearch_i"], ref["vsearch"][0])
    np.testing.assert_allclose(got["vsearch_d"], ref["vsearch"][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["vscore_all"], ref["vscore_all"], rtol=1e-5, atol=1e-6)
    for key, want in zip(("embed_s", "embed_o"), ref["embed"]):
        np.testing.assert_allclose(np.asarray(got[key]), want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["test_ranks"], ref["test"][1])
    assert got["test_metrics"] == ref["test"][0]
    assert got["train_step"] == ref["trained"].step == 2
    trained = torch.load(tmp_path / "trained.pt")
    for tower, params in ref["trained"].params.items():
        for k, w in params.items():
            np.testing.assert_allclose(trained[tower][k].detach().numpy(), w.detach().numpy(),
                                       rtol=1e-3, atol=2 * 2.5e-4, err_msg=k)
    assert got["ckpt_roundtrip_max"] == 0.0
    assert got["restore_latest_max_0"] == got["restore_latest_max_1"] == 0.0
    assert (tmp_path / "ckpt" / "best.pt").exists()
    assert not (tmp_path / "ckpt_local_1").exists()
    shutil.rmtree(tmp_path)  # about 1.5 GB of checkpoints of the full-width VGG16 towers


if __name__ == "__main__" and len(sys.argv) == 6 and sys.argv[1] == "worker":
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
