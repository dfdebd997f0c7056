"""Per-stage timing of the MoCap shooting train step (bench config).

    python -m gpode_tpu_torch.scripts.profile_step [--preset official]
        [--iters 30] [--trace DIR] [--out results/profile_step.json]
        [--device cuda]

Counterpart of `scripts/profile_step.py`. With the CUDA kernels forced ON
(`kernels`) and OFF (`plain`) it times, in ms per call:

  * `draw_build_ms`: the step's posterior draw (Cholesky of K(Z, Z), the
    whitened solves, the RFF prior at Z);
  * `rhs_eval_ms`: one rhs evaluation at the in-solver shape (S * N * (T-1)
    segment rows, the `fused_rhs` kernel when on);
  * `forward_ms`: the ELBO; `grad_ms`: the ELBO and its backward;
  * `train_step_ms`: ELBO, backward and Adam;

and derives the backward/forward ratio. Each figure is the mean of `--iters`
calls (4x that for the two short ones) after 3 warm-up calls, timed on the
host clock around work that ends in a device synchronize. `--trace DIR`
also captures a trace of 5 steps with the kernels on
(`utils/profiling.trace`). Writes the report as JSON to `--out` and prints
it as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models import gp
from gpode_tpu_torch.models.shooting import sample_draw_noise, sample_step_noise
from gpode_tpu_torch.train.bench_setup import (PRESETS, build_bench_problem,
                                               preset_model_args)
from gpode_tpu_torch.train.builders import shooting_loss_fn
from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step
from gpode_tpu_torch.utils import profiling


def _timeit(fn, sync, iters, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    sync()
    begin = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - begin) / iters * 1e3


def profile(preset: str = "official", iters: int = 30, trace_dir=None,
            device=None) -> dict:
    dev = resolve_device(device)
    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
                                               device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_seq, t_len = ys.shape[0], ys.shape[1]
    d_lat = params.states.mean.shape[-1]
    rows = args.num_samples * n_seq * (t_len - 1)
    x_batch = torch.as_tensor(
        np.random.RandomState(2).randn(rows, d_lat).astype(np.float32),
        device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    report = {"preset": preset, "rhs_rows": int(rows),
              "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu")}

    def draw():
        noise = sample_draw_noise(params, args.num_features, gen)
        return gp.draw_posterior(params.gp, noise["rff_weights"],
                                 noise["rff_freq"], noise["rff_phase"],
                                 noise["inducing"])

    def noise():
        return sample_step_noise(params, args.num_features, args.num_samples,
                                 gen)

    for kernels in (True, False):
        loss_fn = shooting_loss_fn(args, kernels)
        fixed_draw = draw()
        step_noise = noise()
        opt = default_optimizer(params, 5e-3)
        step = make_train_step(loss_fn, params, opt)

        def forward():
            with torch.no_grad():
                return loss_fn(params, step_noise, ys, ts)[0]

        def grad():
            params.zero_grad(set_to_none=True)
            loss_fn(params, step_noise, ys, ts)[0].backward()

        def rhs():
            with torch.no_grad():
                return gp.eval_draw(params.gp, fixed_draw, x_batch, kernels)

        r = {"draw_build_ms": _timeit(lambda: draw(), sync, iters * 4),
             "rhs_eval_ms": _timeit(rhs, sync, iters * 4),
             "forward_ms": _timeit(forward, sync, iters),
             "grad_ms": _timeit(grad, sync, iters),
             # params move: the step's own noise each call, as training
             "train_step_ms": _timeit(lambda: step(noise(), ys, ts), sync,
                                      iters)}
        r["bwd_over_fwd"] = round(
            (r["grad_ms"] - r["forward_ms"]) / max(r["forward_ms"], 1e-9), 2)
        r = {k: round(v, 4) for k, v in r.items()}
        tag = "kernels" if kernels else "plain"
        report[tag] = r
        print(f"[{tag:>7}] " + "  ".join(f"{k}={v}" for k, v in r.items()),
              flush=True)

    if trace_dir:
        step = make_train_step(shooting_loss_fn(args, True), params,
                               default_optimizer(params, 5e-3))
        with profiling.trace(trace_dir) as prof:
            for _ in range(5):
                terms = step(noise(), ys, ts)
            float(terms.loss.detach())
            sync()
        report["trace"] = prof.trace_path
        print(f"trace written to {prof.trace_path}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="official", choices=PRESETS)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--trace", type=str, default=None,
                    help="capture a trace of 5 steps to this directory")
    ap.add_argument("--out", type=str, default="results/profile_step.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    cli = ap.parse_args(argv)
    report = profile(cli.preset, cli.iters, cli.trace, cli.device)
    os.makedirs(os.path.dirname(os.path.abspath(cli.out)), exist_ok=True)
    with open(cli.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
