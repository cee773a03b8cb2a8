"""Readings that a cell's check limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For each seed, in one process: the cell's set-up from that seed, a window of
one request (one eval), the program's state freed, then the cell's check;
on a control seed also the control (the reference one precision below the
configuration's, put in the program's place). Prints one JSON line a seed
with every number the check compares. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import cells
from benchmark.run import set_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    set_cache_dirs()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.workload(args.workload)
    conf = cells.config(cell["config"])
    cfg = cells.experiment(conf)
    device = torch.device("cuda", 0)
    for seed in list(args.seeds) + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        driver = cells.traffic(cell["traffic"]).Driver(cfg, conf, cell, seed, device)
        driver.setup()
        result = driver.window(0.0)  # one request
        driver.release()
        t1 = time.perf_counter()
        checks = driver.check(control=seed in args.control_seeds)
        t2 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "checks": checks,
                          "attempted": result["attempted"],
                          "setup_and_window_s": t1 - t0, "check_s": t2 - t1}), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
