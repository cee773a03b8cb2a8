"""The port's recall-parity harness (witw_tpu_torch.tools.parity) against
witw_tpu's run_parity on the same fake reference .pth towers (the key
format of tests/test_pipeline_e2e.py) and the same CSV, on the CPU in f32:
the metrics within 1e-6 and the gate's verdict equal, on pairs whose ranks
spread from 1 to the gallery's size. Also the port's materialized-crop
oracle (witw_tpu_torch/match/reference_impl.py), which the embedding dump
uses, held bit-equal to witw_tpu's."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from witw_tpu.configs import fov_experiment as j_fov_experiment
from witw_tpu.match.reference_impl import crop_overhead_materialized
from witw_tpu.tools import parity as jparity
from witw_tpu_torch.configs import fov_experiment
from witw_tpu_torch.match.reference_impl import (
    crop_overhead_materialized as t_crop_overhead_materialized)
from witw_tpu_torch.models.backbones.vgg16 import VGG16_CONVS
from witw_tpu_torch.models.fov_dsm import HEAD_CONVS
from witw_tpu_torch.tools import parity as tparity
from witw_tpu_torch.train import loop

N_PAIRS = 16
N_CONFUSED = 10


def _fake_tower(path, seed):
    """A reference FOV-DSM tower checkpoint: model.features.N.layer.* for the
    VGG convs, model.features.N.* for the head convs (OIHW)."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for idx, cout in VGG16_CONVS:
        sd[f"model.features.{idx}.layer.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * 0.05
        sd[f"model.features.{idx}.layer.bias"] = torch.randn((cout,), generator=g) * 0.01
        cin = cout
    for name, cout, _, _ in HEAD_CONVS:
        idx = int(name.split("_")[1])
        sd[f"model.features.{idx}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * 0.05
        sd[f"model.features.{idx}.bias"] = torch.randn((cout,), generator=g) * 0.01
        cin = cout
    torch.save(sd, path)


def _pair_colors():
    """(overhead, surface) colour of each pair. Each overhead has a colour
    of its own; the first N_CONFUSED surfaces take the next confused pair's
    overhead colour (planted confusions), the rest their own. With tied
    towers a confused pair's rank is the number of overheads at least as
    near the colour it took as its own is: 2 to N_PAIRS here, so that
    top_1 is 37.5, top_5 56.25, avg_rank 5.8125 and med_rank 4."""
    overhead = np.random.default_rng(5).integers(20, 236, (N_PAIRS, 3))
    surface = overhead.copy()
    surface[:N_CONFUSED] = np.roll(overhead[:N_CONFUSED], -1, axis=0)
    return overhead, surface


def _color_pairs(directory):
    """N_PAIRS CVUSA pairs of flat colours (noise of 4 levels) from
    :func:`_pair_colors`."""
    rng = np.random.default_rng(0)
    (directory / "surface").mkdir(parents=True)
    (directory / "overhead").mkdir()
    rows = []
    overhead, surface = _pair_colors()
    for i in range(N_PAIRS):
        for view, hw, color in (("surface", (128, 512), surface[i]),
                                ("overhead", (256, 256), overhead[i])):
            img = np.clip(color + rng.integers(-4, 5, (*hw, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(directory / view / f"{i}.png")
        rows.append(f"overhead/{i}.png,surface/{i}.png\n")
    (directory / "pairs.csv").write_text("".join(rows))
    return str(directory / "pairs.csv")


def _f32(cfg, csv_path):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, dataset=dataclasses.replace(cfg.data.dataset,
                                                                       test_csv=csv_path)),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        eval=dataclasses.replace(cfg.eval, batch_size=2))


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both packages' reports on the same towers and pairs: plain, against
    their own metrics (PASS) and against top_1 + 1 pt (FAIL)."""
    tmp = tmp_path_factory.mktemp("parity")
    csv_path = _color_pairs(tmp / "data")
    pths = [str(tmp / "fov_360_surface_best.pth"), str(tmp / "fov_360_overhead_best.pth")]
    _fake_tower(pths[0], 0)
    _fake_tower(pths[1], 0)  # tied towers: a pair's two views embed alike
    cfgs = {"witw_tpu": _f32(j_fov_experiment(dataset="cvusa", fov=360), csv_path),
            "port": _f32(fov_experiment("cvusa", 360), csv_path)}
    run = {"witw_tpu": jparity.run_parity,
           "port": lambda *a, **k: tparity.run_parity(*a, device="cpu", **k)}
    out = {pkg: {"plain": run[pkg](cfgs[pkg], *pths, verbose=False)} for pkg in run}
    ref = dict(out["witw_tpu"]["plain"]["witw_tpu"])
    for pkg in run:
        out[pkg]["same"] = run[pkg](cfgs[pkg], *pths, reference_metrics=ref, verbose=False)
        out[pkg]["off"] = run[pkg](cfgs[pkg], *pths, verbose=False,
                                   reference_metrics=dict(ref, top_1=ref["top_1"] + 1.0))
    return out, cfgs["port"], pths, csv_path


def test_parity_pairs_rank_off_the_ceiling_and_off_any_tie(reports):
    """The planted confusions put the metrics between their bounds, and no
    query's true-match distance lies within 1e-3 of another overhead's
    (the distances are about 0.1), so f32 rounding in either package cannot
    move a rank."""
    out, cfg, pths, csv_path = reports
    metrics = out["witw_tpu"]["plain"]["witw_tpu"]
    assert 0 < metrics["top_1"] < metrics["top_5"] < metrics["top_10"] < 100
    assert 1 < metrics["med_rank"] < metrics["avg_rank"] < N_PAIRS
    pipeline, params = tparity.load_reference_towers(cfg, *pths, device="cpu")
    from witw_tpu_torch.cli.common import build_loader
    from witw_tpu_torch.data.csv_registry import read_pair_paths
    from witw_tpu_torch.evaluation.gallery import _paired_distance_batched

    loader = build_loader(cfg, read_pair_paths(cfg.data.dataset, csv_path), False, False, 2)
    s_emb, o_emb = loop.embed_all(pipeline, params, loader)
    g, q = np.meshgrid(np.arange(N_PAIRS), np.arange(N_PAIRS), indexing="ij")
    d = _paired_distance_batched(o_emb[g.ravel()], s_emb[q.ravel()]).reshape(N_PAIRS, N_PAIRS)
    d_true = d.diagonal()
    ranks = (d <= d_true[None]).sum(dim=0).numpy()
    assert ranks.min() == 1 and ranks.max() == N_PAIRS and (ranks > 1).sum() == N_CONFUSED
    assert metrics["avg_rank"] == ranks.mean()
    gap = (d - d_true[None]).abs() + torch.eye(N_PAIRS)
    assert gap.min() > 1e-3


def test_run_parity_report_matches_witw(reports):
    out = reports[0]
    for case in ("plain", "same", "off"):
        want, got = out["witw_tpu"][case], out["port"][case]
        assert sorted(got) == sorted(want)
        for key in tparity.METRIC_KEYS:
            assert got["witw_tpu"][key] == pytest.approx(want["witw_tpu"][key], abs=1e-6), key
        assert got["witw_tpu"]["locations"] == N_PAIRS
        if case != "plain":
            assert got["gate_pass"] == want["gate_pass"] == (case == "same")
            assert got["recall1_delta_pt"] == pytest.approx(want["recall1_delta_pt"], abs=1e-6)
            assert got["reference"] == want["reference"]


def test_run_parity_is_loop_test_on_the_converted_towers(reports):
    out, cfg, pths, csv_path = reports
    pipeline, params = tparity.load_reference_towers(cfg, *pths, device="cpu")
    sd = torch.load(pths[0], weights_only=True)
    assert torch.equal(params["surface"]["vgg.conv_0.weight"], sd["model.features.0.layer.weight"])
    assert torch.equal(params["surface"]["conv_27.bias"], sd["model.features.27.bias"])
    from witw_tpu_torch.cli.common import build_loader
    from witw_tpu_torch.data.csv_registry import read_pair_paths

    loader = build_loader(cfg, read_pair_paths(cfg.data.dataset, csv_path), False, False, 2)
    assert loop.test(cfg, pipeline, loader, params=params, verbose=False) == \
        out["port"]["plain"]["witw_tpu"]


def test_parity_cli_writes_the_report(reports, tmp_path, capsys):
    out, cfg, pths, csv_path = reports
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(out["port"]["plain"]["witw_tpu"]))
    report = tmp_path / "report.json"
    tparity.main(["--test-csv", csv_path, "--surface-pth", pths[0], "--overhead-pth", pths[1],
                  "--batch-size", "2", "--reference-metrics", str(ref), "--out-json", str(report),
                  "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "recall@1 gate (<= 0.5 pt)" in printed and "PASS" in printed
    got = json.loads(report.read_text())
    # bf16 towers by default: the gate holds against the f32 run's metrics
    assert got["witw_tpu"]["locations"] == N_PAIRS and "gate_pass" in got


@pytest.mark.parametrize("bo, bs, h, w, c, sw", [(3, 5, 2, 16, 4, 16), (4, 2, 1, 12, 3, 5),
                                                 (2, 3, 4, 64, 16, 16)])
def test_aligned_crop_matches_reference_impl(rng, bo, bs, h, w, c, sw):
    """The port's reference_impl.crop_overhead_materialized, which the
    embedding dump crops with, crops each overhead map at each query's
    orientation as witw_tpu's oracle does, bit for bit in f32: the whole
    [Bo, Bs] crop and, as the dump calls it, one query at a time."""
    o_emb = rng.normal(size=(bo, h, w, c)).astype(np.float32)
    orientation = rng.integers(0, w, (bo, bs)).astype(np.int32)
    want = np.asarray(crop_overhead_materialized(jnp.asarray(o_emb), jnp.asarray(orientation), sw))
    o_t = torch.from_numpy(o_emb)
    got = t_crop_overhead_materialized(o_t, torch.from_numpy(orientation), sw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for q in range(bs):
        got = t_crop_overhead_materialized(o_t, torch.from_numpy(orientation[:, q:q + 1]), sw)
        np.testing.assert_array_equal(got[:, 0].numpy(), want[:, q])
