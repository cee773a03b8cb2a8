"""Recall-parity harness: reference .pth weights -> the port -> metric table
(port of witw_tpu/tools/parity.py).

The acceptance gate for this framework is CVUSA recall@1 within 0.5 pt of the
PyTorch reference (BASELINE.md). Given mounted dataset CSVs and the
reference's trained tower checkpoints
(./weights/fov_{fov}_{surface,overhead}_best.pth — reference
model/cvig_fov.py:485-486), it

1. converts both torch state dicts into the port's towers
   (models/convert_torch.py),
2. runs the full-gallery retrieval eval on the card (``train/loop.test``:
   the bf16 towers on the conv kernel, ranks from the fused match — the
   exact rank-with-ties definition of reference cvig_fov.py:552),
3. prints the metric table, side by side with the reference's numbers when a
   JSON of them is supplied, and applies the 0.5-pt recall@1 gate.

Run: ``python -m witw_tpu_torch.tools.parity --fov 360 --dataset cvusa \
  --test-csv .../val-19zl.csv --surface-pth .../fov_360_surface_best.pth \
  --overhead-pth .../fov_360_overhead_best.pth [--reference-metrics ref.json]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional

import torch

from witw_tpu_torch.cli.common import build_loader
from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.models.convert_torch import (convert_fov_dsm_state_dict, load_torch_file,
                                                 merge_pretrained_vgg)
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.pipeline import FovPipeline

METRIC_KEYS = ("top_1", "top_5", "top_10", "top_percent", "avg_rank",
               "med_rank", "locations")
GATE_PT = 0.5  # the acceptance rule: recall@1 within this many points of the reference


def load_reference_towers(cfg, surface_pth: str, overhead_pth: str, device=None):
    """(pipeline, params): the reference's two tower checkpoints converted
    onto freshly initialized towers on ``device`` (the card when None)."""
    pipeline = FovPipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(0))
    for tower, path in (("surface", surface_pth), ("overhead", overhead_pth)):
        converted = convert_fov_dsm_state_dict(load_torch_file(path))
        merged = merge_pretrained_vgg({k: v.cpu() for k, v in params[tower].items()}, converted)
        params[tower] = {k: v.to(pipeline.device) for k, v in merged.items()}
    return pipeline, params


def run_parity(
    cfg,
    surface_pth: str,
    overhead_pth: str,
    reference_metrics: Optional[Dict[str, float]] = None,
    verbose: bool = True,
    device=None,
) -> Dict:
    """The port's metrics on ``cfg.data.dataset.test_csv`` with the
    reference towers, beside ``reference_metrics`` with the recall@1 gate
    when given (it passes within :data:`GATE_PT`). The report and the
    table keep witw_tpu's layout and keys (the metrics under
    ``"witw_tpu"``), so either package's report reads the same."""
    pipeline, params = load_reference_towers(cfg, surface_pth, overhead_pth, device)
    pairs = read_pair_paths(cfg.data.dataset, cfg.data.dataset.test_csv)
    loader = build_loader(cfg, pairs, shuffle=False, drop_last=False,
                          batch_size=cfg.eval.batch_size)
    results = loop.test(cfg, pipeline, loader, params=params, verbose=False)

    report = {"witw_tpu": results}
    if verbose:
        header = f"{'metric':>12} {'witw_tpu':>10}"
        if reference_metrics:
            header += f" {'reference':>10} {'delta':>8}"
        print(header)
        for key in METRIC_KEYS:
            line = f"{key:>12} {results[key]:>10.2f}"
            if reference_metrics and key in reference_metrics:
                ref = float(reference_metrics[key])
                line += f" {ref:>10.2f} {results[key] - ref:>+8.2f}"
            print(line)
    if reference_metrics and "top_1" in reference_metrics:
        delta = abs(results["top_1"] - float(reference_metrics["top_1"]))
        report["reference"] = reference_metrics
        report["recall1_delta_pt"] = delta
        report["gate_pass"] = bool(delta <= GATE_PT)
        if verbose:
            verdict = "PASS" if report["gate_pass"] else "FAIL"
            print(f"recall@1 gate (<= {GATE_PT} pt): |delta| = {delta:.3f} -> {verdict}")
    return report


def main(argv=None):
    from witw_tpu_torch.configs import fov_experiment

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", default="cvusa", choices=["cvusa", "witw"])
    parser.add_argument("--fov", type=int, default=360)
    parser.add_argument("--test-csv", required=True)
    parser.add_argument("--surface-pth", required=True)
    parser.add_argument("--overhead-pth", required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument(
        "--reference-metrics", default=None,
        help="JSON file of the reference run's metrics ({'top_1': ..., ...}) "
             "for the side-by-side table and 0.5-pt gate",
    )
    parser.add_argument("--out-json", default=None, help="write the report here")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run on the host)")
    args = parser.parse_args(argv)

    cfg = fov_experiment(dataset=args.dataset, fov=args.fov)
    ds = dataclasses.replace(cfg.data.dataset, test_csv=args.test_csv)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset=ds),
        eval=dataclasses.replace(cfg.eval, batch_size=args.batch_size),
    )
    ref = None
    if args.reference_metrics:
        with open(args.reference_metrics) as f:
            ref = json.load(f)
    report = run_parity(cfg, args.surface_pth, args.overhead_pth, ref, device=args.device)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
