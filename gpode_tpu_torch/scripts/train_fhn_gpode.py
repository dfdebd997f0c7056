"""Learn FitzHugh-Nagumo dynamics with GPODE (`--shooting`: the
multiple-shooting variant).

    python -m gpode_tpu_torch.scripts.train_fhn_gpode [--shooting] [flags]

Counterpart of `scripts/train_fhn_gpode.py`: its flags and defaults, plus
`--device` (default: the CUDA card; `cpu` runs on the CPU). Ends with one
JSON line of the final metrics, the wall seconds and the Trainer's steps/s.
"""

from __future__ import annotations

import sys

from gpode_tpu_torch.scripts._cli import (add_shooting_flags, add_vdp_flags,
                                          base_parser, run_and_report,
                                          to_experiment_args)
from gpode_tpu_torch.train.experiments import run_fhn


def parser():
    p = base_parser("Learning FitzHugh-Nagumo dynamics with GPODE")
    add_vdp_flags(p)
    add_shooting_flags(p)
    p.add_argument("--shooting", action="store_true",
                   help="use the multiple-shooting variant")
    p.set_defaults(save="results/fhn/gpode", data_obs_s=30, data_obs_t=6.0,
                   data_obs_noise_var=0.025, num_samples=10)
    return p


def run(argv=None):
    """Parse `argv` and run: (params, the Trainer or None, metrics)."""
    ns = parser().parse_args(argv)
    return run_fhn(to_experiment_args(ns), shooting_variant=ns.shooting)


def main(argv=None) -> int:
    return run_and_report(run, argv)


if __name__ == "__main__":
    sys.exit(main())
