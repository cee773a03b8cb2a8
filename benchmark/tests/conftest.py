"""Shared helpers of the benchmark's CPU tests: a cell's driver at a tiny
size on the CPU, with the port's plain versions of its kernels."""

from __future__ import annotations

import pytest
import torch

from benchmark import cells

# A 32 x 64 panorama and a 64^2 tile give [1, 8, 16] FOV maps and 8 x 8
# SAFA features; batches of 4, so a 10-pair split ends in a ragged batch.
TINY = {"data": {"surface_height": 32, "surface_width_max": 64, "overhead_size": 64},
        "eval": {"batch_size": 4, "query_block": 4, "gallery_chunk": 8}}
TINY_PARAMS = {"pairs": 10, "check_queries": 6}
EVAL_CELLS = ["fov_dsm-cvusa360.eval-bf16", "safa-cvusa.eval-bf16"]


def tiny_driver(name: str, seed: int = 2**31 + 11, params=None):
    cell = cells.workload(name)
    cell["params"] = dict(params or TINY_PARAMS)
    conf = cells.config(cell["config"])
    cfg = cells.experiment(conf, TINY)
    return cells.traffic(cell["traffic"]).Driver(cfg, conf, cell, seed, torch.device("cpu"))


def run_checked(driver, seconds: float = 0.0):
    """A run's window and check, as ``run.main`` makes them: (checks, the
    cell's limits, correct)."""
    driver.setup()
    driver.window(seconds)
    driver.release()
    checks = driver.check()
    limits = driver.cell["limits"]
    return checks, limits, all(checks[k] <= limits[k] for k in limits)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
