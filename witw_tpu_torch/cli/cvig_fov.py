#!/usr/bin/env python
"""FOV-DSM model CLI (port of witw_tpu/cli/cvig_fov.py; reference
model/cvig_fov.py).

Usage (the reference's flags, cvig_fov.py:580-601):
    python -m witw_tpu_torch.cli.cvig_fov --mode {train,test} --dataset {cvusa,witw} --fov {6-360}
"""

from witw_tpu_torch.cli.common import apply_overrides, base_parser, run
from witw_tpu_torch.configs import fov_experiment


def main(argv=None, device=None):
    """Run the CLI on ``device`` (the card when None)."""
    args = base_parser(with_fov=True).parse_args(argv)
    print(args)
    cfg = apply_overrides(fov_experiment(dataset=args.dataset, fov=args.fov), args)
    return run(cfg, args, f"fov_{args.fov}_{args.dataset}", device)


if __name__ == "__main__":
    main()
