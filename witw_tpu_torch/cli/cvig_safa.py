#!/usr/bin/env python
"""VGG16+SAFA model CLI (port of witw_tpu/cli/cvig_safa.py): global
embeddings, Euclidean retrieval.

Usage:
    python -m witw_tpu_torch.cli.cvig_safa --mode {train,test} --dataset {cvusa,witw} --fov {6-360}
"""

from witw_tpu_torch.cli.common import apply_overrides, base_parser, run
from witw_tpu_torch.configs import safa_experiment


def main(argv=None, device=None):
    """Run the CLI on ``device`` (the card when None)."""
    args = base_parser(with_fov=True).parse_args(argv)
    print(args)
    cfg = apply_overrides(safa_experiment(dataset=args.dataset, fov=args.fov), args)
    return run(cfg, args, f"safa_{args.fov}_{args.dataset}", device)


if __name__ == "__main__":
    main()
