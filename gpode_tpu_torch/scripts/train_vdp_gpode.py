"""Learn the Van der Pol system with vanilla GPODE.

    python -m gpode_tpu_torch.scripts.train_vdp_gpode [flags]

Counterpart of `scripts/train_vdp_gpode.py`: its flags and defaults, plus
`--device` (default: the CUDA card; `cpu` runs on the CPU). Ends with one JSON line of
the final metrics, the wall seconds and the Trainer's steps/s.
"""

from __future__ import annotations

import sys

from gpode_tpu_torch.scripts._cli import (add_vdp_flags, base_parser,
                                          run_and_report, to_experiment_args)
from gpode_tpu_torch.train.experiments import run_vdp


def parser():
    p = base_parser("Learning Van der Pol system with GPODE")
    add_vdp_flags(p)
    p.set_defaults(save="results/vdp/gpode")
    return p


def run(argv=None):
    """Parse `argv` and run: (params, the last Trainer or None, metrics)."""
    return run_vdp(to_experiment_args(parser().parse_args(argv)),
                   shooting_variant=False)


def main(argv=None) -> int:
    return run_and_report(run, argv)


if __name__ == "__main__":
    sys.exit(main())
