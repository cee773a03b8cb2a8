"""The benchmark is driven by data: BENCHMARK.json keeps to its contract's
form, every cell, configuration and metric it names has its file, and one
added as new files in a copy is found with no file edited."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import cells

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        conf = cells.config(c["name"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        spec = cells.workload(w["name"])
        assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.py").is_file()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in b["workloads"]:  # every cell reports setup_s, another end-to-end and a per-layer metric
        e2e_names = [m["name"] for m in cells.metrics_of(b, w["name"], False)]
        assert "setup_s" in e2e_names and len(e2e_names) >= 2
        per_layer = cells.metrics_of(b, w["name"], True)
        assert per_layer and all(m["moves"] in e2e_names for m in per_layer)


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    """Copy the benchmark, add a configuration, a cell and a per-layer metric
    as new files plus manifest entries, and find each through ``cells``."""
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base)
    b = bench()
    before = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    conf = cells.config("fov_dsm-cvusa360")
    conf.update(name="fov_dsm-cvusa90", preset_args={"dataset": "cvusa", "fov": 90})
    (base / "configs" / "fov_dsm-cvusa90.json").write_text(json.dumps(conf))
    cell = cells.workload("fov_dsm-cvusa360.eval-bf16")
    cell["config"] = "fov_dsm-cvusa90"
    (base / "workloads" / "fov_dsm-cvusa90.eval-bf16.json").write_text(json.dumps(cell))
    (base / "metrics" / "pools_share.py").write_text(
        "def read(summary, work):\n    return 42.0\n")
    b["configs"].append({"name": "fov_dsm-cvusa90", "source": conf["source"],
                         "file": "benchmark/configs/fov_dsm-cvusa90.json", "reduced": [],
                         "why": "narrow field of view"})
    b["workloads"].append({"name": "fov_dsm-cvusa90.eval-bf16", "config": "fov_dsm-cvusa90",
                           "traffic": "eval", "chips": 1, "why": cell["why"]})
    next(e for e in b["end_to_end"] if e["name"] == "eval_pairs_per_s")["workloads"].append(
        "fov_dsm-cvusa90.eval-bf16")
    b["per_layer"].append({"name": "pools_share", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "Towers, bf16",
                           "moves": "eval_pairs_per_s", "workloads": ["fov_dsm-cvusa90.eval-bf16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    after = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    m = cells.manifest(tmp_path)
    found = cells.workload("fov_dsm-cvusa90.eval-bf16", base)
    assert cells.config(found["config"], base)["preset_args"]["fov"] == 90
    names = [x["name"] for x in cells.metrics_of(m, "fov_dsm-cvusa90.eval-bf16", True)]
    assert "pools_share" in names and "conv3x3_bf16_roofline" not in names
    assert cells.reader("pools_share", base)({}, {}) == 42.0
    # A split metric without a file of its own takes its quantity's reader.
    assert cells.reader("pools_share.safa", base)({}, {}) == 42.0
    e2e = [x["name"] for x in cells.metrics_of(m, "fov_dsm-cvusa90.eval-bf16", False)]
    assert e2e == ["eval_pairs_per_s", "setup_s"]
    cfg = cells.experiment(cells.config(found["config"], base))
    assert cfg.data.surface_width == 128


def test_run_refuses_without_the_port_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           bench()["workloads"][0]["name"], "--seed", "3000000000",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("seed", [0, 2**31 + 17, -5, 2**70])
def test_seeds_any_whole_number(seed):
    from benchmark import seeds

    a, b = seeds.derive(seed, "x", 1), seeds.derive(seed, "x", 2)
    assert 0 <= a < 2**63 and a != b and a == seeds.derive(seed, "x", 1)
