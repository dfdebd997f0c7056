"""Time to test LL on the card: MoCap-09 shooting GPODE trained from scratch
at a bench preset until the test LL first reaches each target.

    python -m gpode_tpu_torch.scripts.bench_time_to_nll [--preset fast]
        [--num_iter 10000] [--eval_every 250] [--targets -1.50 -1.45 -1.42]
        [--eval_draws 128] [--track_draws 16] [--seed 121]
        [--num_samples N] [--out PATH] [--device cuda]

Counterpart of `scripts/bench_time_to_nll.py` with the init of
`scripts/_init_mocap_cpu.py`, run in one process on the device (PyTorch
compiles nothing ahead, so nothing needs hiding behind a subprocess):

  * init: the preset's model (subject 09, seqlen 100, 5 PCA latents, the
    likelihood in the 50-D data space), kernel lengthscale 1.25 and variance
    0.5, inducing points at k-means centers, the initial state by backward
    integration over 50 posterior draws and the shooting states at the data
    (under the eval solver: the preset's, max_steps >= 512, Hairer's first
    step), then the noise variance 1.5 x (the residual variance of a 16-draw
    `predict` of the training split in data space + 1e-4);
  * training: the preset's step with Adam (lr 5e-3), the constraint frozen
    (`default_frozen_predicate`, as the JAX driver does), captured as CUDA
    graphs where `train/graph_step.capture_refusal` allows, step noise from
    a device generator seeded from `--seed`;
  * evals: the mixture test LL and MSE of the posterior predictive in the
    50-D data space (`train/evaluation.make_projected_scorer`): a
    `--track_draws` eval every `--eval_every` iterations; a tracking LL at or
    above a target is confirmed by an `--eval_draws` eval of the same
    iteration (the targets taken from the lowest first); one `--eval_draws`
    eval at the end. An eval's noise comes from a generator seeded from
    (seed, iteration). Training stops once every target is confirmed.

Writes one JSON (default `chiprun_out/time_to_nll_<preset>.json`): the
card's name and power limit (nvidia-smi), the preset's config, init
seconds, each crossing's iteration, train and wall seconds, LL and MSE, the
final LL and MSE, the trace, train steps/s, the final loss, and for a
whole-span dopri5 preset the number of steps whose whole-span attempt was
rejected. The CPU-baseline extrapolation of the JAX driver is not ported.
`--device cpu` runs everything on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.data.mocap import latent_to_data_projector
from gpode_tpu_torch.models.gpode import predict, sample_predict_noise
from gpode_tpu_torch.models.init import (initialize_inducing,
                                         initialize_kernel_parameters,
                                         initialize_noisevar,
                                         initialize_shooting_states_with_data)
from gpode_tpu_torch.models.likelihoods import project
from gpode_tpu_torch.models.shooting import sample_step_noise
from gpode_tpu_torch.ops.ode import FIRST_STEP_SPAN
from gpode_tpu_torch.train.bench_setup import (PRESETS, load_bench_data,
                                               preset_model_args)
from gpode_tpu_torch.train.builders import (build_shooting,
                                            default_frozen_predicate,
                                            make_projector, shooting_loss_fn)
from gpode_tpu_torch.train.evaluation import make_projected_scorer
from gpode_tpu_torch.train.experiments import _eval_cfg, generator, view
from gpode_tpu_torch.train.graph_step import make_step
from gpode_tpu_torch.train.trainer import default_optimizer

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

X0_DRAWS = 50          # backward-integration draws of the x0 estimate
NOISEVAR_DRAWS = 16    # draws of the residual-variance predict
# the driver's random streams, each a generator seeded from (seed, stream)
_X0, _NOISEVAR, _TRAIN, _EVAL = range(4)


def eval_config(margs):
    """The eval solver: the preset's, with max_steps >= 512 and Hairer's
    first step."""
    return _eval_cfg(margs.solver_config())


def build_model(margs, data_pca, data_full, seed, device):
    """The preset's shooting model with its kernel and inducing init:
    parameters from a CPU generator seeded with `seed`, k-means from
    `np.random.RandomState(seed)`, so every device starts from the same
    values."""
    params = build_shooting(torch.Generator().manual_seed(seed), margs,
                            data_pca.trn.ys,
                            projector=latent_to_data_projector(data_pca),
                            full_dim=data_full.trn.ys.shape[-1], device=device)
    initialize_kernel_parameters(params.gp, lengthscale_value=1.25,
                                 variance_value=0.5)
    initialize_inducing(params.gp, data_pca.trn.ys,
                        float(data_pca.trn.ts.max()), 1e0,
                        rng=np.random.RandomState(seed))
    return params


@torch.no_grad()
def init_states_and_noise(params, margs, data_pca, data_full, x0_noise,
                          resid_noise):
    """The data-driven init of the states and the noise variance, in place:
    the x0 mean by backward integration over the draws of `x0_noise`, the
    shooting states at the data, then the noise variance 1.5 x (the
    data-space residual variance of a `predict` of the training split over
    the draws of `resid_noise` + 1e-4). Returns that residual variance
    (D_full,)."""
    cfg = eval_config(margs)
    initialize_shooting_states_with_data(params, x0_noise, data_pca.trn.ys,
                                         data_pca.trn.ts, cfg)
    dev = params.states.mean.device
    zs = predict(view(params), resid_noise,
                 torch.as_tensor(data_pca.trn.ts, device=dev), cfg)
    init_ys = project(make_projector(latent_to_data_projector(data_pca), dev),
                      zs)
    ys = torch.as_tensor(data_full.trn.ys, device=dev)
    resid_var = (ys[None] - init_ys).var(dim=(0, 1, 2), unbiased=False) + 1e-4
    initialize_noisevar(params.likelihood, 1.5 * resid_var.cpu().numpy())
    return resid_var


def _card(device):
    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="official", choices=PRESETS)
    ap.add_argument("--num_iter", type=int, default=10000)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--targets", type=float, nargs="+",
                    default=[-1.50, -1.45, -1.42])
    ap.add_argument("--eval_draws", type=int, default=128)
    ap.add_argument("--track_draws", type=int, default=16)
    ap.add_argument("--seed", type=int, default=121)
    ap.add_argument("--num_samples", type=int, default=0,
                    help="override the preset's MC draws per step (0 = keep)")
    ap.add_argument("--out", default=None,
                    help="default: chiprun_out/time_to_nll_<preset>.json")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    a = ap.parse_args(argv)
    out_path = a.out or os.path.join(_REPO, "chiprun_out",
                                     f"time_to_nll_{a.preset}.json")

    t_start = time.perf_counter()
    dev = resolve_device(a.device)
    card = _card(dev)
    margs = preset_model_args(a.preset)
    if a.num_samples:
        margs = dataclasses.replace(margs, num_samples=a.num_samples)
    f = margs.num_features
    data_pca, data_full = load_bench_data()

    # ---- init ----
    params = build_model(margs, data_pca, data_full, a.seed, dev)
    x0_noise = sample_predict_noise(view(params), f, X0_DRAWS,
                                    generator(dev, a.seed, _X0),
                                    sample_x0=False)
    resid_noise = sample_predict_noise(view(params), f, NOISEVAR_DRAWS,
                                       generator(dev, a.seed, _NOISEVAR))
    resid_var = init_states_and_noise(params, margs, data_pca, data_full,
                                      x0_noise, resid_noise)
    noise_var = params.likelihood.variance.detach().cpu().numpy()  # waits
    init_seconds = time.perf_counter() - t_start
    print(f"[{init_seconds:7.1f}s] init done: noise variance "
          f"{noise_var.min():.4g} .. {noise_var.max():.4g}", flush=True)

    # ---- train, track, confirm crossings ----
    ys = torch.as_tensor(data_full.trn.ys, device=dev)
    ts = torch.as_tensor(data_pca.trn.ts, device=dev)
    step = make_step(shooting_loss_fn(margs), params, default_optimizer(
        params, 5e-3, frozen_predicate=default_frozen_predicate(margs)), margs)
    train_gen = generator(dev, a.seed, _TRAIN)
    scorer = make_projected_scorer(eval_config(margs),
                                   latent_to_data_projector(data_pca),
                                   data_full.tst.ys, data_pca.tst.ts,
                                   data_pca.tst.ys[:, 0], device=dev)

    def run_eval(draws, itr):
        noise = sample_predict_noise(view(params), f, draws,
                                     generator(dev, a.seed, _EVAL, itr),
                                     sample_x0=False)
        ll, mse = scorer(view(params), noise)
        return float(ll), float(mse)

    whole_span = (margs.solver == "dopri5"
                  and margs.first_step == FIRST_STEP_SPAN)
    trace, crossings = [], {}
    pending = sorted(a.targets)   # the lowest LL is crossed first
    train_seconds = eval_seconds = 0.0
    n_track = n_full = rejected = uncovered = 0
    itr, final_loss = 0, float("nan")
    while itr < a.num_iter:
        t0 = time.perf_counter()
        for _ in range(min(a.eval_every, a.num_iter - itr)):
            terms = step(sample_step_noise(params, f, margs.num_samples,
                                           train_gen), ys, ts)
            itr += 1
            rejected += whole_span and terms.natt > 1
            uncovered += terms.ncov < 2
        final_loss = float(terms.loss.detach())   # waits for the device
        train_seconds += time.perf_counter() - t0

        t0 = time.perf_counter()
        ll_t, mse_t = run_eval(a.track_draws, itr)
        n_track += 1
        row = dict(iter=itr, loss=final_loss, train_seconds=train_seconds,
                   track_ll=ll_t, track_mse=mse_t)
        while pending and ll_t >= pending[0]:
            target = pending[0]
            ll_f, mse_f = run_eval(a.eval_draws, itr)
            n_full += 1
            row.update(test_ll=ll_f, test_mse=mse_f)
            if ll_f < target:
                break   # the tracking eval was optimistic: keep training
            pending.pop(0)
            wall = time.perf_counter() - t_start
            crossings[str(target)] = dict(
                iter=itr, train_seconds=train_seconds, wall_seconds=wall,
                test_ll=ll_f, test_mse=mse_f)
            print(f"*** target {target} confirmed at iter {itr}: LL {ll_f:.4f} "
                  f"({a.eval_draws} draws), train {train_seconds:.1f}s, wall "
                  f"{wall:.1f}s", flush=True)
        eval_seconds += time.perf_counter() - t0
        row["wall_seconds"] = time.perf_counter() - t_start
        trace.append(row)
        print(f"iter {itr}: loss {final_loss:.4f}, track LL {ll_t:.4f} "
              f"({a.track_draws} draws), train {train_seconds:.1f}s",
              flush=True)
        if not pending:
            break

    ll_f, mse_f = run_eval(a.eval_draws, itr)
    n_full += 1
    wall_total = time.perf_counter() - t_start
    payload = {
        "metric": "mocap09_shooting_time_to_test_nll",
        "card": card,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "preset": a.preset,
        "config": dataclasses.asdict(margs),
        "seed": a.seed,
        "targets": a.targets,
        "eval_draws": a.eval_draws,
        "track_draws": a.track_draws,
        "eval_every": a.eval_every,
        "num_iter": a.num_iter,
        "init_seconds": init_seconds,
        "noise_variance": noise_var.tolist(),
        "residual_variance": resid_var.cpu().numpy().tolist(),
        "crossings": crossings,
        "final": dict(iter=itr, test_ll=ll_f, test_mse=mse_f),
        "train_steps_per_sec": itr / train_seconds,
        "final_loss": final_loss,
        "rejected_attempt_steps": rejected if whole_span else None,
        "uncovered_steps": uncovered,
        "overheads": dict(init_seconds=init_seconds,
                          train_seconds=train_seconds,
                          eval_seconds_total=eval_seconds,
                          n_track_evals=n_track, n_full_evals=n_full,
                          wall_seconds_total=wall_total),
        "trace": trace,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps({k: v for k, v in payload.items()
                      if k not in ("trace", "noise_variance",
                                   "residual_variance")}))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
