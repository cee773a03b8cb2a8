#!/usr/bin/env python
"""Semantic (5-channel) model CLI (port of witw_tpu/cli/cvig_semantic.py;
reference model/cvig_semantic.py).

Usage (the reference's flags, cvig_semantic.py:611-632):
    python -m witw_tpu_torch.cli.cvig_semantic --mode {train,test} --dataset {cvusa,witw} --fov {6-360}
"""

from witw_tpu_torch.cli.common import apply_overrides, base_parser, run
from witw_tpu_torch.configs import semantic_experiment


def main(argv=None, device=None):
    """Run the CLI on ``device`` (the card when None)."""
    args = base_parser(with_fov=True).parse_args(argv)
    print(args)
    cfg = apply_overrides(semantic_experiment(dataset=args.dataset, fov=args.fov), args)
    return run(cfg, args, f"semantic_{args.fov}_{args.dataset}", device)


if __name__ == "__main__":
    main()
