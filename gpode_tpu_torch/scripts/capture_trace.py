"""Capture a torch.profiler trace of N bench train steps, nothing else.

    python -m gpode_tpu_torch.scripts.capture_trace [--out results/trace]
        [--steps 5] [--preset official] [--kernels true|false|auto]
        [--device cuda]

Counterpart of `scripts/capture_trace.py`: builds a preset's bench problem
and the train step the entry points run (`train/graph_step.make_step`:
captured CUDA graphs wherever `capture_refusal` is None, else the eager
step; `scripts/bench.py`'s Adam lr 5e-3, step noise from a generator seeded
with 1), runs 5 warm-up steps OUTSIDE the trace window (a captured step's
eager warm-up and its capture among them), then traces `--steps` steps
ending in a device synchronize (`utils/profiling.trace`: CPU operators, the
program's spans and, on a card, its kernels and copies) into a gzipped
Chrome trace under `--out`. A captured step's trace holds its replay and
accept-read spans; an eager one (the CPU, `--kernels false`) its phases,
`gpode.draw` to `gpode.adam`. `--kernels` forces the CUDA kernels on
(`true`, the default, as the JAX script's `--pallas true`), off (`false`)
or leaves the auto rule (`auto`). Summarize the trace with
`gpode_tpu_torch.scripts.analyze_trace`, which rolls the spans up too.
"""

from __future__ import annotations

import argparse
import sys

import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models.shooting import sample_step_noise
from gpode_tpu_torch.train.bench_setup import (PRESETS, build_bench_problem,
                                               preset_model_args)
from gpode_tpu_torch.train.builders import shooting_loss_fn
from gpode_tpu_torch.train.graph_step import make_step
from gpode_tpu_torch.train.trainer import default_optimizer
from gpode_tpu_torch.utils import profiling

KERNEL_RULES = {"true": True, "false": False, "auto": None}
WARMUP = 5


def capture(out: str, steps: int = 5, preset: str = "official",
            kernels=True, device=None):
    """Trace `steps` warm train steps of `preset`; returns the profiler
    (`key_averages()`, and the trace file as `trace_path`)."""
    dev = resolve_device(device)
    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
                                               device=dev)
    step = make_step(shooting_loss_fn(args, kernels), params,
                     default_optimizer(params, 5e-3), args, kernels=kernels)
    gen = torch.Generator(dev).manual_seed(1)

    def run():
        return step(sample_step_noise(params, args.num_features,
                                      args.num_samples, gen), ys, ts)

    for _ in range(WARMUP):
        terms = run()
    float(terms.loss.detach())
    with profiling.trace(out) as prof:
        for _ in range(steps):
            terms = run()
        float(terms.loss.detach())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default="results/trace")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--preset", default="official", choices=PRESETS)
    ap.add_argument("--kernels", default="true", choices=tuple(KERNEL_RULES),
                    help="the CUDA kernels: forced on, off, or the auto rule")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    cli = ap.parse_args(argv)
    prof = capture(cli.out, cli.steps, cli.preset, KERNEL_RULES[cli.kernels],
                   cli.device)
    print(f"trace written to {prof.trace_path} ({cli.steps} steps)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
