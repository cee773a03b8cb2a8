"""The thread budget of the port's tests, set once when a test file imports it.

pytest-xdist runs each worker as its own process, and torch gives each one
an intra-op thread per core: six workers on eight cores ran 48 threads that
spun against each other, and a test took up to several hundred times its
time alone. Under xdist (which sets ``PYTEST_XDIST_WORKER_COUNT`` in each
worker) this gives each worker its share of the cores the process may run
on, and writes the same count into ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS``, so that the processes the tests start inherit it.
Without xdist it changes nothing.

Every ``tests/test_torch_*.py`` imports it first, as ``import torch_workers``:
pytest puts ``tests/`` on ``sys.path``, while ``from tests import`` can
find another installed package named ``tests``.
"""

import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _threads = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    torch.set_num_threads(_threads)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(_threads)
