"""tests/torch_workers.py, the thread budget of the port's tests: under
pytest-xdist each worker gets its share of the cores it may run on, and the
processes it starts inherit the count; without xdist torch keeps its
default. Each case imports the module in a fresh interpreter."""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = """
import json, os, sys, torch
default = torch.get_num_threads()
sys.path.insert(0, "tests")
import torch_workers
print(json.dumps({"default": default, "threads": torch.get_num_threads(),
                  "cores": len(os.sched_getaffinity(0)),
                  "omp": os.environ.get("OMP_NUM_THREADS"), "mkl": os.environ.get("MKL_NUM_THREADS")}))
"""


def _probe(workers):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("workers", [6, None], ids=["xdist_6_workers", "no_xdist"])
def test_thread_budget(workers):
    got = _probe(workers)
    if workers is None:
        assert got["threads"] == got["default"]
        assert got["omp"] is None and got["mkl"] is None
    else:
        want = max(1, got["cores"] // workers)
        assert got["threads"] == want
        assert got["omp"] == got["mkl"] == str(want)
