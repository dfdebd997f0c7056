"""Shared command-line plumbing for the training scripts.

Counterpart of `scripts/_cli.py`: the same flag names, defaults and choices,
so a command line of the JAX scripts runs here too, plus `--device` (the
default is the CUDA card; `--device cpu` runs on the CPU). `--pallas_rhs
auto|true|false` picks the CUDA kernels' rule: the auto dispatch, always,
or never (`SolverConfig.kernels` None / True / False).
"""

from __future__ import annotations

import argparse
import json
import time

from gpode_tpu_torch.train.builders import CONSTRAINTS, SOLVERS
from gpode_tpu_torch.train.experiments import ExperimentArgs


def _str2bool(v):
    return str(v).lower() in ("true", "1", "yes")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description)
    p.add_argument("--num_features", type=int, default=256,
                   help="Number of Fourier basis functions (pathwise GP sampling)")
    p.add_argument("--num_inducing", type=int, default=16,
                   help="Number of inducing points for the sparse GP")
    p.add_argument("--dimwise", type=_str2bool, default=True,
                   help="Separate lengthscales for every output dimension")
    p.add_argument("--q_diag", type=_str2bool, default=False,
                   help="Diagonal posterior approximation for inducing variables")
    p.add_argument("--solver", type=str, default="dopri5", choices=SOLVERS,
                   help="ODE solver for numerical integration")
    p.add_argument("--ts_dense_scale", type=int, default=4,
                   help="Dense integration grid factor (fixed-step solvers)")
    p.add_argument("--first_step", type=float, default=None,
                   help="dopri5 initial step (None=heuristic, -1=whole span; "
                        "shooting drivers default to -1)")
    p.add_argument("--max_steps", type=int, default=64,
                   help="Adaptive-solver step budget per solve")
    p.add_argument("--use_adjoint", type=_str2bool, default=False,
                   help="O(1)-memory continuous-adjoint gradients")
    p.add_argument("--remat", type=_str2bool, default=False,
                   help="Rematerialize rhs evals in backward")
    p.add_argument("--num_iter", type=int, default=5000,
                   help="Number of gradient steps")
    p.add_argument("--lr", type=float, default=0.005, help="Adam learning rate")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="Global-norm gradient clip (0 = off)")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=("constant", "cosine"),
                   help="Learning-rate schedule (cosine decays to lr/100)")
    p.add_argument("--pallas_rhs", type=str, default="auto",
                   choices=("auto", "true", "false"),
                   help="The CUDA rhs and segment kernels: auto (by batch "
                        "size and shape), true (force), false (plain path)")
    p.add_argument("--eval_sample_size", type=int, default=128,
                   help="Posterior samples for predictive evaluation")
    p.add_argument("--save", type=str, default="results/run",
                   help="Output directory")
    p.add_argument("--seed", type=int, default=121, help="Global seed")
    p.add_argument("--log_freq", type=int, default=10, help="Logging frequency")
    p.add_argument("--checkpoint_every", type=int, default=1000,
                   help="Periodic checkpoint cadence in iterations (0 = only "
                        "the final checkpoint)")
    p.add_argument("--no_plots", action="store_true",
                   help="Skip diagnostics plots")
    p.add_argument("--resume", action="store_true",
                   help="Resume from <save>/checkpt.npz if present")
    p.add_argument("--flatten_opt", type=_str2bool, default=True,
                   help="Accepted for the JAX command lines; no effect here")
    p.add_argument("--eval_only", action="store_true",
                   help="Skip initialization and training: load the trained "
                        "checkpoint from <save> and run evaluation and "
                        "prediction export only (model/data flags must "
                        "match the training run)")
    p.add_argument("--eval_checkpoint", type=str, default="checkpt.npz",
                   help="Checkpoint filename inside <save> for --eval_only "
                        "(e.g. checkpt_best.npz)")
    p.add_argument("--device", type=str, default=None,
                   help="Torch device (default: the CUDA card, raises "
                        "without one; 'cpu' runs on the CPU)")
    return p


def add_vdp_flags(p: argparse.ArgumentParser):
    p.add_argument("--data_obs_S", type=int, default=25, dest="data_obs_s",
                   help="Training sequence length")
    p.add_argument("--data_obs_T", type=float, default=7.0, dest="data_obs_t",
                   help="Training integration time")
    p.add_argument("--data_obs_noise_var", type=float, default=0.05,
                   help="Observation noise variance for simulation")
    p.add_argument("--data_nonuniform", type=_str2bool, default=False,
                   help="Observe VDP at sorted random times "
                        "(VanderPolNonUniform; vanilla variant only)")


def add_mocap_flags(p: argparse.ArgumentParser):
    p.add_argument("--data_subject", type=str, default="09",
                   choices=("09", "35", "39"), help="MoCap subject")
    p.add_argument("--data_seqlen", type=int, default=100,
                   help="Training sequence length")
    p.add_argument("--num_latents", type=int, default=5,
                   help="Latent (PCA) dimensionality")
    p.add_argument("--data_path", type=str, default="data/mocap")
    p.add_argument("--val_freq", type=int, default=500,
                   help="Validation-eval cadence in iterations (0 = off); "
                        "tracks val LL/MSE and keeps the best checkpoint")
    p.add_argument("--draw_stages", type=str, default="",
                   help="MC-draw schedule 'S1:N1,S2:N2' (stage iters must "
                        "sum to num_iter); trains the same params through "
                        "stages of num_samples")
    p.add_argument("--val_draws", type=int, default=32,
                   help="Posterior draws per validation evaluation")


def add_shooting_flags(p: argparse.ArgumentParser):
    p.add_argument("--mesh", type=str, default=None,
                   help="Rank mesh, e.g. 'dp=2,mc=4': sequences over dp, "
                        "MC samples over mc; sizes multiply to the world "
                        "size (torchrun --nproc_per_node, or 1 in a plain "
                        "process)")
    p.add_argument("--parallel", type=str, default="shard_map",
                   choices=("shard_map", "gspmd"),
                   help="Sharded-step style with --mesh: per-rank sample "
                        "noise (shard_map) or the single-device step's "
                        "noise split over the ranks (gspmd; takes "
                        "--segment_minibatch)")
    p.add_argument("--constraint_type", type=str, default="gauss",
                   choices=CONSTRAINTS, help="Shooting-constraint density")
    p.add_argument("--constraint_trainable", type=_str2bool, default=False,
                   help="Learn the constraint scale")
    p.add_argument("--constraint_initial_scale", type=float, default=1e-3,
                   help="Constraint scale init")
    p.add_argument("--constraint_anneal_iters", type=int, default=0,
                   help="Anneal the constraint scale geometrically from "
                        "--constraint_anneal_start down to "
                        "--constraint_initial_scale over this many iterations "
                        "(0 = off)")
    p.add_argument("--constraint_anneal_start", type=float, default=0.1,
                   help="Initial (loose) constraint scale when annealing")
    p.add_argument("--num_samples", type=int, default=5,
                   help="Reparameterized MC samples per gradient step")
    p.add_argument("--segment_minibatch", type=int, default=0,
                   help="Integrate only K uniformly sampled shooting segments "
                        "per step (0 = all): O(K) step cost on long "
                        "trajectories, unbiased ELBO estimator")


def to_experiment_args(ns: argparse.Namespace) -> ExperimentArgs:
    args = ExperimentArgs()
    for field in vars(args):
        if hasattr(ns, field):
            setattr(args, field, getattr(ns, field))
    args.kernels = {"auto": None, "true": True, "false": False}[ns.pallas_rhs]
    args.plots = not ns.no_plots
    return args


def run_and_report(run, argv=None) -> int:
    """`run(argv)` (a twin's), then one JSON line on stdout: the final
    metrics, the wall seconds of the run, and the Trainer's steps/s (its
    step-time meter: the steps after the warm-up, without the validation
    callbacks), or None for an `--eval_only` run. A `--mesh` rank other
    than 0, which does not evaluate, prints nothing."""
    t0 = time.perf_counter()
    _, trainer, metrics = run(argv)
    wall = time.perf_counter() - t0
    if metrics is None:
        return 0
    sps = (1.0 / trainer.time_meter.avg
           if trainer is not None and trainer.time_meter.avg > 0 else None)
    print(json.dumps({"metrics": metrics, "wall_seconds": wall,
                      "steps_per_sec": sps}))
    return 0
