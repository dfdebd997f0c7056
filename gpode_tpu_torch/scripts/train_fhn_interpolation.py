"""FHN interpolation with GPODE on the shipped non-uniform splits
(`data/fhn/fhn_interpolation[_small].npz`): train on the observed points,
score the held-out interpolation window.

    python -m gpode_tpu_torch.scripts.train_fhn_interpolation [--shooting] [--small] [flags]

Counterpart of `scripts/train_fhn_interpolation.py`: its flags and defaults,
plus `--device` (default: the CUDA card; `cpu` runs on the CPU). The data
path is `data/fhn`, relative to the working directory, as there. Ends with
one JSON line of the final metrics, the wall seconds and the Trainer's
steps/s.
"""

from __future__ import annotations

import sys

from gpode_tpu_torch.scripts._cli import (base_parser, run_and_report,
                                          to_experiment_args)
from gpode_tpu_torch.train.experiments import run_fhn_interpolation


def parser():
    p = base_parser("FHN interpolation with GPODE (non-uniform grid)")
    p.add_argument("--shooting", action="store_true",
                   help="masked shooting variant on the full uniform grid")
    p.add_argument("--small", action="store_true",
                   help="use the small interpolation split")
    p.set_defaults(save="results/fhn/interpolation", num_iter=3000)
    return p


def run(argv=None):
    """Parse `argv` and run: (params, the Trainer or None, metrics)."""
    ns = parser().parse_args(argv)
    args = to_experiment_args(ns)
    args.data_path = "data/fhn"
    return run_fhn_interpolation(args, small=ns.small,
                                 shooting_variant=ns.shooting)


def main(argv=None) -> int:
    return run_and_report(run, argv)


if __name__ == "__main__":
    sys.exit(main())
