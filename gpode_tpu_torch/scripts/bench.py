"""Benchmark: MoCap shooting-GPODE training throughput (ELBO steps/s).

    python -m gpode_tpu_torch.scripts.bench [--preset official] [--iters 200]
        [--device cuda]

Counterpart of the single-device `measure_steps_per_sec` of `bench.py`: the
bench problem of a preset (`train/bench_setup.py`: MoCap subject 09, seqlen
100, 5 PCA latents, the likelihood in the 50-D data space, kernel and
inducing init), the preset's shooting step with Adam (lr 5e-3, no frozen
mask, as `bench.py` builds it), step noise from a generator seeded with 1 on
the device. 3 warm-up steps, then 3 timing windows of `--iters` steps, each
ending in a host read of the loss; steps/s is the median window's.

Prints one JSON line: `steps_per_sec`, `rhs_evals_per_sec` (steps/s x the
last step's rhs evaluations x the segments of a step, draws x sequences x
steps), the final `loss`, `platform` ("gpu" or "cpu") and `device` (the
card's name), plus the preset, the iterations and the peak device memory
in MiB (null on the CPU). The JAX script's CPU-baseline subprocess and its
`--mesh` are not here. `--device cpu` runs on the CPU (the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models.shooting import sample_step_noise
from gpode_tpu_torch.train.bench_setup import (PRESETS, build_bench_problem,
                                               preset_model_args)
from gpode_tpu_torch.train.builders import shooting_loss_fn
from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step


def measure_steps_per_sec(preset: str = "official", iters: int = 200,
                          warmup: int = 3, device=None) -> dict:
    dev = resolve_device(device)
    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
                                               device=dev)
    step = make_train_step(shooting_loss_fn(args), params,
                           default_optimizer(params, 5e-3))
    gen = torch.Generator(dev).manual_seed(1)

    def run():
        return step(sample_step_noise(params, args.num_features,
                                      args.num_samples, gen), ys, ts)

    for _ in range(warmup):
        terms = run()
    float(terms.loss.detach())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window_times = []
    for _ in range(3):
        begin = time.perf_counter()
        for _ in range(iters):
            terms = run()
        final_loss = float(terms.loss.detach())  # the window ends in a host read
        window_times.append(time.perf_counter() - begin)
    steps_per_sec = iters / sorted(window_times)[1]
    segments = args.num_samples * ys.shape[0] * ys.shape[1]
    cuda = dev.type == "cuda"
    return {
        "steps_per_sec": steps_per_sec,
        "rhs_evals_per_sec": steps_per_sec * terms.nfe * segments,
        "loss": final_loss,
        "platform": "gpu" if cuda else "cpu",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "preset": preset,
        "iters": iters,
        "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                     if cuda else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="official", choices=PRESETS)
    ap.add_argument("--iters", type=int, default=200,
                    help="steps per timing window (3 windows)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps(measure_steps_per_sec(a.preset, a.iters,
                                           device=a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
