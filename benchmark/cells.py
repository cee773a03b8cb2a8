"""Cells, configurations, traffic kinds and per-layer metrics, found by name.

- ``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
- ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic
  kind and parameters, chips, why, and the limits of its outputs check.
- ``benchmark/configs/<config>.json``: the port's preset and overrides, the
  published widths, ``reduced``, ``assumed`` and the towers' precision.
- ``benchmark/traffic/<kind>.py``: the driver of a traffic kind.
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(summary, work)`` returning a number or None.

A later change adds a cell, configuration or metric as new files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


def root() -> Path:
    return HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(base: Optional[Path] = None) -> Dict:
    return load_json((base or root()) / "BENCHMARK.json")


def workload(name: str, base: Optional[Path] = None) -> Dict:
    return load_json((base or HERE) / "workloads" / f"{name}.json")


def config(name: str, base: Optional[Path] = None) -> Dict:
    return load_json((base or HERE) / "configs" / f"{name}.json")


def traffic(kind: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def split_bases(name: str) -> List[str]:
    """``name`` and the names it splits: a metric ``<quantity>.<part>`` is
    ``<quantity>`` reported for some cells apart (its own bound, or the
    end-to-end metric it moves), and has ``<quantity>``'s definition unless
    a file or value of its own name exists."""
    out = [name]
    while "." in out[-1]:
        out.append(out[-1].rsplit(".", 1)[0])
    return out


def reader(metric: str, base: Optional[Path] = None) -> Callable:
    """A per-layer metric's ``read`` function, loaded by path from the file
    of its name, or of the quantity it splits (metric names hold dots)."""
    folder = (base or HERE) / "metrics"
    path = next((folder / f"{n}.py" for n in split_bases(metric)
                 if (folder / f"{n}.py").is_file()), None)
    if path is None:
        raise FileNotFoundError(f"no reader for the metric {metric!r} in {folder}")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones. A metric with a ``workloads`` key is
    the listed cells'; a per-layer one without it is every cell's that
    reports the end-to-end metric it moves; an end-to-end one without it,
    every cell's."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def _replace(obj, overrides: Dict):
    """A frozen dataclass tree with ``overrides`` (nested dicts) applied."""
    changes = {}
    for key, value in overrides.items():
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            changes[key] = _replace(current, value)
        else:
            changes[key] = tuple(value) if isinstance(value, list) else value
    return dataclasses.replace(obj, **changes)


def experiment(conf: Dict, extra: Optional[Dict] = None):
    """The port's ExperimentConfig of a configuration file: its preset,
    then its overrides, then ``extra`` (the tests' smaller sizes)."""
    from witw_tpu_torch import configs

    cfg = getattr(configs, conf["preset"])(**conf.get("preset_args", {}))
    for overrides in (conf.get("overrides") or {}, extra or {}):
        cfg = _replace(cfg, overrides)
    if cfg.model.compute_dtype != conf["precision"]:
        raise ValueError(f"{conf['name']} states {conf['precision']} towers; the preset runs "
                         f"{cfg.model.compute_dtype}")
    return cfg
