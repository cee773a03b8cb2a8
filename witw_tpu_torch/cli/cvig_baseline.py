#!/usr/bin/env python
"""Baseline model CLI (port of witw_tpu/cli/cvig_baseline.py; reference
model/cvig_baseline.py:478-492): the 7-conv GeM towers, Euclidean retrieval.

Usage:
    python -m witw_tpu_torch.cli.cvig_baseline --mode {train,test} --dataset {cvusa,witw}
"""

from witw_tpu_torch.cli.common import apply_overrides, base_parser, run
from witw_tpu_torch.configs import baseline_experiment


def main(argv=None, device=None):
    """Run the CLI on ``device`` (the card when None)."""
    args = base_parser(with_fov=False).parse_args(argv)
    print(args)
    cfg = apply_overrides(baseline_experiment(dataset=args.dataset), args)
    return run(cfg, args, f"baseline_{args.dataset}", device)


if __name__ == "__main__":
    main()
