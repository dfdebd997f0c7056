"""End-to-end experiment drivers: MoCap, Van der Pol and FitzHugh-Nagumo,
vanilla and shooting, and the FHN interpolation experiment. Counterpart of
`gpode_tpu/train/experiments.py`: data -> build -> initialize -> train ->
evaluate -> plots -> artifacts. The command lines in
`gpode_tpu_torch/scripts/` stay thin.

Random numbers are inputs: each of the driver's streams is its own
generator, seeded from (seed, stream) — the counterparts of the JAX
driver's `split(PRNGKey(seed))` keys — and a validation draw at iteration
`itr` from (seed, eval stream, itr), the counterpart of
`fold_in(k_eval, itr)`. The plots draw from streams of their own, so a run
with plots on trains bit-equal to the same run without; the MoCap plot
before initialization reuses the noise-variance init's stream, as the JAX
driver reuses its key. The k-means init takes `np.random.RandomState(seed)`
as in JAX. Parameters are built from a CPU generator, so every device starts
from the same values.

`--mesh dp=2,mc=...` (shooting variants) trains over a rank mesh
(`gpode_tpu_torch/parallel/`): one process per rank, started by `torchrun`
or, for a world of 1, by the driver itself. Rank 0 runs the data-driven
init and its parameters are broadcast, so the replicas start bit-equal;
every rank trains on its block of sequences with the `--parallel` step;
only rank 0 logs, writes the checkpoints, the trace, the predictions and
the plots, and evaluates (the other ranks return no metrics). A plots-on
run where matplotlib does not import raises before any work, naming
`--no_plots`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.convert import params_like
from gpode_tpu_torch.data.fhn import FHN, load_fhn_interpolation
from gpode_tpu_torch.data.mocap import MocapDataset, latent_to_data_projector
from gpode_tpu_torch.data.vanderpol import VanderPol, VanderPolNonUniform
from gpode_tpu_torch.models import gpode, shooting
from gpode_tpu_torch.models.init import (initialize_inducing,
                                         initialize_kernel_parameters,
                                         initialize_latents_with_data,
                                         initialize_noisevar,
                                         initialize_shooting_states_with_data)
from gpode_tpu_torch.models.likelihoods import project
from gpode_tpu_torch.ops.ode import FIRST_STEP_SPAN
from gpode_tpu_torch.parallel import STYLES, multihost
from gpode_tpu_torch.parallel.mesh import (make_mesh, parse_mesh_spec,
                                           world_size_and_rank)
from gpode_tpu_torch.parallel.train import check_step_mesh
from gpode_tpu_torch.plots import pyplot
from gpode_tpu_torch.train.builders import (ModelArgs, build_gpode,
                                            build_shooting,
                                            default_frozen_predicate,
                                            gpode_loss_fn, gpode_noise_fn,
                                            make_projector, shooting_loss_fn,
                                            shooting_noise_fn)
from gpode_tpu_torch.train.metrics import compute_calibration, compute_summary
from gpode_tpu_torch.train.trainer import TrainConfig, Trainer, save_trace
from gpode_tpu_torch.utils import io as io_utils
from gpode_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gpode_tpu_torch.utils.meters import Meter

# the drivers' random streams, each a generator seeded from (seed, stream)
(_BUILD, _INIT, _NOISE, _TRAIN, _EVAL, _EVAL_TRAIN, _EVAL_TEST, _PLOT_INIT,
 _PLOT_FIELD) = range(9)
# backward-integration draws of the x0 init (the JAX defaults)
_X0_DRAWS = {True: 50, False: 20}   # by shooting_variant
_NOISEVAR_DRAWS = 16


@dataclasses.dataclass
class ExperimentArgs:
    """The JAX package's `ExperimentArgs` (every field and default), plus
    the port's two: `kernels` (None = the auto rule, True / False = force
    the CUDA kernels on / off; `--pallas_rhs auto|true|false`) and `device`
    (None = the CUDA card)."""

    # model
    num_features: int = 256
    num_inducing: int = 16
    dimwise: bool = True
    q_diag: bool = False
    # constraints (shooting only)
    constraint_type: str = "gauss"
    constraint_trainable: bool = False
    constraint_initial_scale: float = 1e-3
    constraint_anneal_iters: int = 0
    constraint_anneal_start: float = 0.1
    # stochastic segment minibatching (shooting only; 0 = off)
    segment_minibatch: int = 0
    # data
    data_obs_s: int = 25
    data_obs_t: float = 7.0
    data_obs_noise_var: float = 0.05
    data_nonuniform: bool = False
    data_subject: str = "09"
    data_seqlen: int = 100
    num_latents: int = 5
    data_path: str = "data/mocap"
    # solver
    solver: str = "dopri5"
    ts_dense_scale: int = 4
    rtol: float = 1e-6
    atol: float = 1e-6
    max_steps: int = 64
    first_step: Optional[float] = None
    use_adjoint: bool = False
    remat: bool = False
    # training
    num_iter: int = 5000
    num_samples: int = 5
    val_freq: int = 500
    val_draws: int = 32
    draw_stages: str = ""
    lr: float = 5e-3
    lr_schedule: str = "constant"
    grad_clip: float = 0.0
    eval_sample_size: int = 128
    mesh: Optional[str] = None
    parallel: str = "shard_map"
    eval_only: bool = False
    eval_checkpoint: str = "checkpt.npz"
    save: str = "results/run"
    seed: int = 121
    log_freq: int = 10
    checkpoint_every: int = 1000
    plots: bool = True
    resume: bool = False  # continue from <save>/checkpt.npz if present
    flatten_opt: bool = True  # accepted; no torch meaning (TrainConfig)
    # the port's own
    kernels: Optional[bool] = None
    device: Optional[str] = None

    def model_args(self) -> ModelArgs:
        return ModelArgs(
            num_features=self.num_features, num_inducing=self.num_inducing,
            dimwise=self.dimwise, q_diag=self.q_diag, solver=self.solver,
            ts_dense_scale=self.ts_dense_scale, rtol=self.rtol, atol=self.atol,
            max_steps=self.max_steps, first_step=self.first_step,
            use_adjoint=self.use_adjoint,
            remat=self.remat, num_samples=self.num_samples,
            constraint_type=self.constraint_type,
            constraint_trainable=self.constraint_trainable,
            constraint_initial_scale=self.constraint_initial_scale,
            constraint_anneal_iters=self.constraint_anneal_iters,
            constraint_anneal_start=self.constraint_anneal_start,
            segment_minibatch=self.segment_minibatch)


def generator(device, *words) -> torch.Generator:
    """A generator on `device` seeded from the integers `words` (a seed and
    a stream, and for an eval its iteration)."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator(device).manual_seed(seed)


def view(params) -> gpode.GPODEParams:
    """The model as the GPODE that `predict` scores: a shooting model's
    GP, q(x0) and likelihood (shared, not copied); a vanilla model as it
    is."""
    if isinstance(params, shooting.ShootingParams):
        return gpode.GPODEParams(params.gp, params.states.x0, params.likelihood)
    return params


def _eval_cfg(cfg):
    """Whole-trajectory evaluation config: budget sized for the full horizon
    and the init-step heuristic restored (a whole-span first attempt is only
    right for one-interval training segments)."""
    return dataclasses.replace(cfg, max_steps=max(512, cfg.max_steps),
                               first_step=None)


def _parse_draw_stages(spec: str, default_num_samples: int,
                       num_iter: int) -> list:
    """'5:8000,32:2000' -> [(5, 8000), (32, 2000)]; stage iters must sum to
    num_iter. Empty spec = one stage at the configured num_samples."""
    if not spec:
        return [(default_num_samples, num_iter)]
    stages = []
    for part in spec.split(","):
        draws, _, iters = part.partition(":")
        stages.append((int(draws), int(iters)))
    total = sum(n for _, n in stages)
    if total != num_iter:
        raise ValueError(f"draw_stages iters sum to {total} != num_iter "
                         f"{num_iter}: {spec!r}")
    if any(d <= 0 or n <= 0 for d, n in stages):
        raise ValueError(f"draw_stages entries must be positive: {spec!r}")
    return stages


def _shooting_margs(margs: ModelArgs, shooting_variant: bool) -> ModelArgs:
    """Shooting trains one-interval segments: dopri5 defaults to a
    whole-span first attempt (first_step=-1.0), which is what engages the
    fused attempt kernel. The controller still rejects and shrinks when the
    tolerance disagrees; an explicit --first_step overrides."""
    if (shooting_variant and margs.solver == "dopri5"
            and margs.first_step is None):
        return dataclasses.replace(margs, first_step=FIRST_STEP_SPAN)
    return margs


def _check_ported(args: ExperimentArgs, plots: bool = True):
    """Refuse, before any work, a plots-on run of a driver that draws
    (`plots`) where matplotlib does not import."""
    if plots and args.plots:
        pyplot()


def _mesh_step_factory(args: ExperimentArgs, margs: ModelArgs, logger,
                       shooting_variant: bool):
    """--mesh: (step_factory, noise_fn, mesh) for the Trainer, or three
    Nones without it. The factory plugs into the Trainer's `step_factory`
    hook, so the loop, meters, checkpoints and validation callbacks are the
    single-device path's; only the step and its noise are the mesh's
    (sequences over `dp`, MC samples over `mc`). The mesh is checked
    against the world size before this process joins a group (started
    here, from the `torchrun` environment or as a world of 1)."""
    if not args.mesh:
        return None, None, None
    if not shooting_variant:
        raise ValueError(
            "--mesh multi-chip training is wired for the shooting variants "
            "(the scale-out workload, SURVEY.md §2.3); drop --mesh or use "
            "the shooting driver")
    if args.segment_minibatch > 0 and args.parallel == "shard_map":
        raise ValueError(
            "--segment_minibatch with --mesh needs --parallel gspmd (the "
            "explicit-collective step integrates fixed per-device segment "
            "blocks; the GSPMD step supports the subsampled estimator)")
    mesh = make_mesh(parse_mesh_spec(args.mesh))
    check_step_mesh(mesh, margs)
    multihost.initialize(device=args.device)
    logger.info(f"Multi-device training: mesh {mesh.shape} over {mesh.size} "
                f"ranks ({args.parallel} step, {dist.get_backend()})")
    make, noise_fn = STYLES[args.parallel]

    def factory(params, optimizer):
        return make(mesh, margs, params, optimizer, args.kernels)

    return factory, noise_fn(mesh, margs), mesh


def _place_on_mesh(mesh, params, ys, device):
    """Rank 0's parameters on every rank (broadcast); the rank's block of
    the sequences `ys` (N, T, D) over `dp`, on `device`."""
    multihost.broadcast_params(params)
    return multihost.global_array(np.asarray(ys, np.float32), mesh, "dp",
                                  device)


def _is_main(args: ExperimentArgs) -> bool:
    """Whether this process logs, writes the run's files and evaluates:
    the single process, or rank 0 of a `--mesh` run (the group's rank, or
    the `torchrun` environment's before the group starts)."""
    return not args.mesh or world_size_and_rank()[1] == 0


def _run_device(args: ExperimentArgs, mesh) -> torch.device:
    """The run's device: under a mesh the rank's (`local_device`)."""
    if mesh is None:
        return resolve_device(args.device)
    return multihost.local_device(args.device)


def _ncov_expected(shooting_variant: bool, ts) -> int:
    """Observation times each train-step solve must cover: 2 for one-interval
    shooting segments, T+1 (t=0 prepended) for whole trajectories — feeds the
    Trainer's solver-health warning."""
    return 2 if shooting_variant else len(np.asarray(ts)) + 1


def _setup_run(args: ExperimentArgs, name: str, main: bool = True):
    """The run's logger (`<save>/logs` and stderr), and its args record;
    a rank other than 0 (`main` False) gets a silent logger and writes
    nothing."""
    if not main:
        return io_utils.get_logger(displaying=False, saving=False,
                                   name=f"{name}.rank")
    io_utils.makedirs(args.save)
    logger = io_utils.get_logger(os.path.join(args.save, "logs"), name=name)
    # an eval-only invocation must not clobber the training run's arg record
    fname = "eval_args.json" if args.eval_only else "train_args.json"
    io_utils.save_args(args, os.path.join(args.save, fname))
    return logger


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _load_eval_params(args: ExperimentArgs, template, margs, logger):
    """--eval_only: the trained parameters, loaded in the freshly built
    model's form (a checkpoint of other model or data flags raises)."""
    path = os.path.join(args.save, args.eval_checkpoint)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"--eval_only needs a trained checkpoint at {path} "
            "(train first, or point --eval_checkpoint at one)")
    state = load_checkpoint(path)
    step = state.get("step")
    logger.info(f"Eval-only: loaded {path}"
                + (f" (step {int(step)})" if step is not None else ""))
    return params_like(template, state["params"], margs)


def _maybe_resume(args: ExperimentArgs, params, margs, logger, mesh=None):
    """(params, opt_state, generator state, start_iter) from
    <save>/checkpt.npz under `--resume`, else (params, None, None, 1).
    Under a mesh every rank reads rank 0's checkpoint, after a barrier."""
    path = os.path.join(args.save, "checkpt.npz")
    if mesh is not None and args.resume:
        dist.barrier()
    if not (args.resume and os.path.exists(path)):
        return params, None, None, 1
    state = load_checkpoint(path)
    step = int(state["step"])
    logger.info(f"Resuming from {path} at step {step}")
    return (params_like(params, state["params"], margs), state["opt_state"],
            state["generator_state"], step + 1)


def _train_generator(args, device, generator_state):
    gen = generator(device, args.seed, _TRAIN)
    if generator_state is not None:
        gen.set_state(generator_state)
    return gen


@torch.no_grad()
def _predict(params, noise, ts, cfg, device, x0=None, t0_shift=None):
    """Posterior-predictive latent trajectories (S, N, T, D) on the device
    from `noise` (a `gpode.PredictNoise`)."""
    return gpode.predict(view(params), noise, _tensor(ts, device), cfg,
                         x0=None if x0 is None else _tensor(x0, device),
                         t0_shift=t0_shift)


def _predict_noise(params, margs, draws, gen, sample_x0):
    return gpode.sample_predict_noise(view(params), margs.num_features, draws,
                                      gen, sample_x0=sample_x0)


@torch.no_grad()
def mocap_predictions(params, noise, ts, x0, cfg, projector_module):
    """MoCap predictions from the observed first latent states x0 (N, D):
    (latent (S, N, T, D), data space (S, N, T, D_full)) as host arrays."""
    device = projector_module.components.device
    zs = _predict(params, noise, ts, cfg, device, x0=x0)
    return zs.cpu().numpy(), project(projector_module, zs).cpu().numpy()


def _eval_and_log(logger, data, params, margs, cfg, seed, device,
                  eval_sample_size):
    """VDP-style evaluation: extrapolation scored beyond the train horizon,
    predictions from q(x0) samples."""
    horizon = float(np.asarray(data.trn.ts)[-1])
    t_train = int(np.searchsorted(np.asarray(data.tst.ts),
                                  horizon * (1.0 + 1e-6)))
    # the model's time axis is set by training (observation k lives at model
    # time trn_ts[k] + dt_trn): the test grid reuses the training shift
    dt_trn = float(np.asarray(data.trn.ts)[1] - np.asarray(data.trn.ts)[0])
    test_noise = _predict_noise(params, margs, eval_sample_size,
                                generator(device, seed, _EVAL_TEST), True)
    test_pred = _predict(params, test_noise, data.tst.ts, cfg, device,
                         t0_shift=dt_trn).cpu().numpy()
    train_noise = _predict_noise(params, margs, eval_sample_size,
                                 generator(device, seed, _EVAL_TRAIN), True)
    train_pred = _predict(params, train_noise, data.trn.ts, cfg,
                          device).cpu().numpy()
    noise_var = params.likelihood.variance.detach().cpu().numpy()
    train_ll, train_mse = compute_summary(data.trn.ys, train_pred, noise_var)
    test_ll, test_mse = compute_summary(data.tst.ys[:, t_train:],
                                        test_pred[:, :, t_train:], noise_var)
    kern = params.gp.kernel
    logger.info(f"[TRAIN] LL {train_ll:.3f} | MSE {train_mse:.3f}")
    logger.info(f"[TEST]  LL {test_ll:.3f} | MSE {test_mse:.3f}")
    logger.info(f"Kernel lengthscales {kern.lengthscales.detach().cpu().numpy()}")
    logger.info(f"Kernel variance {kern.variance.detach().cpu().numpy()}")
    logger.info(f"Observation likelihood variance {noise_var}")
    return train_pred, test_pred, dict(train_ll=train_ll, train_mse=train_mse,
                                       test_ll=test_ll, test_mse=test_mse)


def run_vdp(args: ExperimentArgs, shooting_variant: bool = False):
    """VDP experiment, vanilla or shooting."""
    _check_ported(args)
    name = "vdp_gpode_shooting" if shooting_variant else "vdp_gpode"
    if args.data_nonuniform:
        # sorted random observation times; the test split is the next
        # t_train seconds on a fresh random grid (pure extrapolation)
        if shooting_variant:
            raise ValueError(
                "--data_nonuniform needs the vanilla variant: the shooting "
                "model integrates uniform one-interval segments")
        data = VanderPolNonUniform(
            s_train=args.data_obs_s, t_train=args.data_obs_t,
            s_test=args.data_obs_s, t_test=2.0 * args.data_obs_t,
            noise_var=args.data_obs_noise_var,
            x0=np.array([[-1.5, 2.5]]), mu=0.5)
        return run_2d(args, data, "vdp_gpode_nonuniform", False)
    n_ahead = args.data_obs_s if not shooting_variant else 50
    data = VanderPol(
        s_train=args.data_obs_s, t_train=args.data_obs_t,
        s_test=args.data_obs_s + n_ahead,
        t_test=args.data_obs_t * (args.data_obs_s + n_ahead - 1) / (args.data_obs_s - 1),
        noise_var=args.data_obs_noise_var,
        x0=np.array([[-1.5, 2.5]]), mu=0.5)
    return run_2d(args, data, name, shooting_variant)


def run_fhn(args: ExperimentArgs, shooting_variant: bool = False):
    """FitzHugh-Nagumo experiment, vanilla or shooting, through `run_2d`."""
    _check_ported(args)
    name = "fhn_gpode_shooting" if shooting_variant else "fhn_gpode"
    data = FHN(s_train=args.data_obs_s, t_train=args.data_obs_t,
               noise_var=args.data_obs_noise_var,
               x0=np.array([[-1.0, -1.0]]))
    return run_2d(args, data, name, shooting_variant)


def _train_config(args, num_iter, warmup_iters, shooting_variant, ts):
    return TrainConfig(num_iter=num_iter, lr=args.lr,
                       lr_schedule=args.lr_schedule, grad_clip=args.grad_clip,
                       log_freq=args.log_freq, warmup_iters=warmup_iters,
                       checkpoint_every=args.checkpoint_every,
                       flatten_opt=args.flatten_opt,
                       ncov_expected=_ncov_expected(shooting_variant, ts))


def _final_checkpoint(args, params, opt_state, gen):
    save_checkpoint(os.path.join(args.save, "checkpt.npz"),
                    {"params": params, "opt_state": opt_state,
                     "generator": gen, "step": args.num_iter})


def _plot_initialization(args, params, data, margs, cfg, device, fname,
                         shooting_variant):
    """`model_{before,after}_initialization.png`: the shooting snapshot
    (its 20-draw prediction from the plot-init stream, the same draws
    before and after) or the field and inducing snapshot."""
    from gpode_tpu_torch.plots import plots_2d
    if shooting_variant:
        plots_2d.plot_shooting_initialization(
            generator(device, args.seed, _PLOT_INIT), params, data, cfg,
            margs.num_features, args.save, fname)
    else:
        plots_2d.plot_model_initialization(params.gp, data, args.save, fname)


def _plot_2d_results(args, params, data, margs, test_pred, trainer, device,
                     shooting_variant):
    """The post-evaluation suite of the 2-D drivers."""
    from gpode_tpu_torch.plots import plots_2d
    noise_var = params.likelihood.variance.detach().cpu().numpy()
    plots_2d.plot_longitudinal(data, test_pred, noise_var, args.save)
    plots_2d.plot_longitudinal_per_sequence(data, test_pred, noise_var,
                                            args.save)
    plots_2d.plot_vectorfield(params.gp, data, test_pred, args.save,
                              generator=generator(device, args.seed,
                                                  _PLOT_FIELD),
                              num_features=margs.num_features)
    plots_2d.plot_inducing_posterior(params.gp, data, args.save)
    plots_2d.plot_long_pred(data.tst.ys, test_pred, data.tst.ts, args.save,
                            "plt_long_pred.png")
    plots_2d.plot_long_pred(data.tst.ys, test_pred, data.tst.ts, args.save,
                            "plt_longnoise_pred.png", noise_var=noise_var)
    plots_2d.plot_long_pred_single(data.tst.ys, test_pred, data.tst.ts,
                                   args.save, "plt_longnoise_pred_single.png",
                                   noise_var=noise_var)
    if shooting_variant:
        plots_2d.plot_shooting_states(params.states, data, args.save)
    if trainer is not None:
        plots_2d.plot_trace(trainer, args.save)


def run_2d(args: ExperimentArgs, data, name: str,
           shooting_variant: bool = False):
    """Shared 2-D driver: build -> initialize -> train -> eval -> artifacts."""
    _check_ported(args)
    main = _is_main(args)
    logger = _setup_run(args, name, main)
    margs = _shooting_margs(args.model_args(), shooting_variant)
    cfg = margs.solver_config(args.kernels)
    eval_cfg = _eval_cfg(cfg)
    # validate/construct the mesh before any expensive init work
    step_factory, mesh_noise_fn, mesh = (
        (None, None, None) if args.eval_only else
        _mesh_step_factory(args, margs, logger, shooting_variant))
    device = _run_device(args, mesh)
    plots = args.plots and main
    rng = np.random.RandomState(args.seed)
    build_gen = generator("cpu", args.seed, _BUILD)

    if shooting_variant:
        params = build_shooting(build_gen, margs, data.trn.ys, device=device)
        loss_fn = shooting_loss_fn(margs, args.kernels)
        noise_fn = mesh_noise_fn or shooting_noise_fn(margs)
        frozen = default_frozen_predicate(margs)
    else:
        params = build_gpode(build_gen, margs, data.trn.ys, device=device)
        loss_fn = gpode_loss_fn(margs, args.kernels)
        noise_fn = gpode_noise_fn(margs)
        frozen = None

    if args.eval_only:
        params = _load_eval_params(args, params, margs, logger)
        trainer = None
    else:
        if plots:
            _plot_initialization(args, params, data, margs, eval_cfg, device,
                                 "model_before_initialization.png",
                                 shooting_variant)
        if main:  # under a mesh rank 0 initializes, then broadcasts
            initialize_inducing(params.gp, data.trn.ys,
                                float(data.trn.ts.max()), rng=rng)
            x0_noise = _predict_noise(params, margs,
                                      _X0_DRAWS[shooting_variant],
                                      generator(device, args.seed, _INIT),
                                      False)
            init = (initialize_shooting_states_with_data if shooting_variant
                    else initialize_latents_with_data)
            init(params, x0_noise, data.trn.ys, data.trn.ts, eval_cfg)
        if plots:
            _plot_initialization(args, params, data, margs, eval_cfg, device,
                                 "model_after_initialization.png",
                                 shooting_variant)

        params, opt_state0, gen_state, start_iter = _maybe_resume(
            args, params, margs, logger, mesh)
        train_ys = (_tensor(data.trn.ys, device) if mesh is None else
                    _place_on_mesh(mesh, params, data.trn.ys, device))
        trainer = Trainer(loss_fn,
                          _train_config(args, args.num_iter,
                                        min(100, args.num_iter // 10),
                                        shooting_variant, data.trn.ts),
                          noise_fn, frozen_predicate=frozen, logger=logger,
                          checkpoint_path=(os.path.join(args.save,
                                                        "checkpt.npz")
                                           if main else None),
                          pass_iteration=(shooting_variant
                                          and margs.constraint_anneal_iters > 0),
                          step_factory=step_factory, model_args=margs,
                          kernels=args.kernels)
        params, opt_state, gen = trainer.train(
            params, _train_generator(args, device, gen_state), train_ys,
            _tensor(data.trn.ts, device), start_iter=start_iter,
            opt_state=opt_state0)
        logger.info("********** Optimization completed **********")
        if main:
            save_trace(trainer, os.path.join(args.save,
                                             "optimization_trace.json"))
            _final_checkpoint(args, params, opt_state, gen)

    if not main:  # rank 0 evaluates
        return params, trainer, None
    train_pred, test_pred, metrics = _eval_and_log(
        logger, data, params, margs, eval_cfg, args.seed, device,
        args.eval_sample_size)
    np.savez(os.path.join(args.save, "model_predictions.npz"),
             train_ts=data.trn.ts, train_ys=data.trn.ys, train_pred=train_pred,
             test_ts=data.tst.ts, test_ys=data.tst.ys, test_pred=test_pred,
             obs_noisevar=params.likelihood.variance.detach().cpu().numpy())
    if args.plots:
        _plot_2d_results(args, params, data, margs, test_pred, trainer,
                         device, shooting_variant)
    return params, trainer, metrics


def _plot_mocap_predictions(args, data_pca, data_full, tag, zs_pred, ys_pred):
    """Latent- and data-space prediction grids of a training-pipeline
    stage."""
    from gpode_tpu_torch.plots import plots_mocap
    plots_mocap.plot_pca_predictions(data_pca.trn.ys, zs_pred, data_pca.trn.ts,
                                     args.save, name=f"plt_latents_{tag}")
    plots_mocap.plot_data_predictions(data_full.trn.ys, ys_pred,
                                      data_pca.trn.ts, args.save,
                                      name=f"plt_data_{tag}")


def _plot_mocap_results(args, params, data_pca, data_full, train_pred_zs,
                        train_pred_ys, test_pred_zs, test_pred_ys, trainer):
    """The post-evaluation suite of the MoCap drivers."""
    from gpode_tpu_torch.plots import plots_mocap
    for split, zs, ys, full in (("train", train_pred_zs, train_pred_ys,
                                 data_full.trn),
                                ("test", test_pred_zs, test_pred_ys,
                                 data_full.tst)):
        pca = data_pca.trn if split == "train" else data_pca.tst
        plots_mocap.plot_pca_predictions(
            pca.ys, zs, pca.ts, args.save,
            name=f"plt_latents_after_optimization_{split}")
        plots_mocap.plot_data_predictions(
            full.ys, ys, pca.ts, args.save,
            name=f"plt_data_after_optimization_{split}")
    plots_mocap.plot_inducing_posterior_3d(params.gp, train_pred_zs, args.save,
                                           name="inducing_posterior_train")
    plots_mocap.plot_inducing_posterior_3d(params.gp, test_pred_zs, args.save,
                                           name="inducing_posterior_test")
    # a small draw subset keeps the Line3DCollection count bounded
    plots_mocap.plot_latents_3d(train_pred_zs[:8], data_pca.trn.ts, args.save,
                                name="plt_latents_3d",
                                rng=np.random.RandomState(args.seed))
    if trainer is not None:
        plots_mocap.plot_trace(trainer, args.save)


def run_mocap(args: ExperimentArgs, shooting_variant: bool = False):
    """MoCap experiment: dynamics in the PCA latent space, likelihood in the
    50-D data space. Returns (params, the last stage's Trainer or None,
    metrics; None on a mesh rank other than 0)."""
    _check_ported(args)
    name = "mocap_gpode_shooting" if shooting_variant else "mocap_gpode"
    main = _is_main(args)
    logger = _setup_run(args, name, main)
    margs = _shooting_margs(args.model_args(), shooting_variant)
    # validate/construct the mesh before any expensive init work
    step_factory, mesh_noise_fn, mesh = (
        (None, None, None) if args.eval_only else
        _mesh_step_factory(args, margs, logger, shooting_variant))
    device = _run_device(args, mesh)
    plots = args.plots and main

    data_pca = MocapDataset(data_path=args.data_path, subject=args.data_subject,
                            pca_components=args.num_latents,
                            data_normalize=False, pca_normalize=True,
                            dt=0.01, seqlen=args.data_seqlen)
    data_full = MocapDataset(data_path=args.data_path, subject=args.data_subject,
                             pca_components=-1, data_normalize=False,
                             pca_normalize=False, dt=0.01, seqlen=args.data_seqlen)
    projector = latent_to_data_projector(data_pca)
    proj = make_projector(projector, device)
    d_full = data_full.trn.ys.shape[-1]

    eval_cfg = _eval_cfg(margs.solver_config(args.kernels))
    rng = np.random.RandomState(args.seed)
    builder = build_shooting if shooting_variant else build_gpode
    params = builder(generator("cpu", args.seed, _BUILD), margs,
                     data_pca.trn.ys, projector=projector, full_dim=d_full,
                     device=device)

    if args.eval_only:
        params = _load_eval_params(args, params, margs, logger)
        trainer = None
    else:
        if plots:
            # before initialization, from the observed first states; the
            # draws of the noise-variance init's stream, as in JAX
            pre_noise = _predict_noise(params, margs, _NOISEVAR_DRAWS,
                                       generator(device, args.seed, _NOISE),
                                       False)
            _plot_mocap_predictions(args, data_pca, data_full,
                                    "before_initialization",
                                    *mocap_predictions(
                                        params, pre_noise, data_pca.trn.ts,
                                        data_pca.trn.ys[:, 0], eval_cfg, proj))
        if main:  # under a mesh rank 0 initializes, then broadcasts
            initialize_kernel_parameters(params.gp, lengthscale_value=1.25,
                                         variance_value=0.5)
            initialize_inducing(params.gp, data_pca.trn.ys,
                                float(data_pca.trn.ts.max()), 1e0, rng=rng)
            x0_noise = _predict_noise(params, margs,
                                      _X0_DRAWS[shooting_variant],
                                      generator(device, args.seed, _INIT),
                                      False)
            init = (initialize_shooting_states_with_data if shooting_variant
                    else initialize_latents_with_data)
            init(params, x0_noise, data_pca.trn.ys, data_pca.trn.ts, eval_cfg)

            # noise init from the residual variance of initial predictions
            resid_noise = _predict_noise(params, margs, _NOISEVAR_DRAWS,
                                         generator(device, args.seed, _NOISE),
                                         True)
            with torch.no_grad():
                init_zs = _predict(params, resid_noise, data_pca.trn.ts,
                                   eval_cfg, device)
                init_ys = project(proj, init_zs)
                resid_var = (_tensor(data_full.trn.ys, device)[None]
                             - init_ys).var(dim=(0, 1, 2),
                                            unbiased=False) + 1e-4
            initialize_noisevar(params.likelihood,
                                1.5 * resid_var.cpu().numpy())
            if plots:
                _plot_mocap_predictions(args, data_pca, data_full,
                                        "after_initialization",
                                        init_zs.cpu().numpy(),
                                        init_ys.cpu().numpy())

        frozen = default_frozen_predicate(margs) if shooting_variant else None
        params, opt_state, gen_state, start_iter = _maybe_resume(
            args, params, margs, logger, mesh)

        # periodic validation: full-trajectory predictions from the observed
        # val x0, scored in the 50-D data space; best-val-LL params kept
        val_meters = {"val_ll": Meter(), "val_mse": Meter()}
        val_callback = None
        if args.val_freq > 0 and main:
            best = {"ll": -np.inf}

            def val_callback(itr, p):
                noise = _predict_noise(p, margs, args.val_draws,
                                       generator(device, args.seed, _EVAL, itr),
                                       False)
                _, ys_pred = mocap_predictions(p, noise, data_pca.val.ts,
                                               data_pca.val.ys[:, 0], eval_cfg,
                                               proj)
                nv = p.likelihood.variance.detach().cpu().numpy()
                ll, mse = compute_summary(data_full.val.ys, ys_pred, nv)
                val_meters["val_ll"].update(ll, itr)
                val_meters["val_mse"].update(mse, itr)
                marker = ""
                if ll > best["ll"]:
                    best["ll"] = ll
                    save_checkpoint(os.path.join(args.save, "checkpt_best.npz"),
                                    {"params": p, "step": itr, "val_ll": ll})
                    marker = " *best"
                logger.info(f"[VAL] iter {itr} LL {ll:.3f} | "
                            f"MSE {mse:.3f}{marker}")

        train_ys = (_tensor(data_full.trn.ys, device) if mesh is None else
                    _place_on_mesh(mesh, params, data_full.trn.ys, device))
        train_ts = _tensor(data_pca.trn.ts, device)
        # --draw_stages: the same params through a schedule of MC draw
        # counts; each stage is a new Trainer whose schedule horizon is its
        # stage end, while Adam's moments and count and the meters carry on
        stages = _parse_draw_stages(args.draw_stages, margs.num_samples,
                                    args.num_iter)
        gen = _train_generator(args, device, gen_state)
        trainer = None
        stage_start = 1
        for s_draws, s_iters in stages:
            stage_end = stage_start + s_iters - 1
            if start_iter > stage_end:
                stage_start = stage_end + 1
                continue  # resume landed past this stage
            margs_s = dataclasses.replace(margs, num_samples=s_draws)
            loss_fn = (shooting_loss_fn(margs_s, args.kernels)
                       if shooting_variant
                       else gpode_loss_fn(margs_s, args.kernels))
            noise_fn = (shooting_noise_fn(margs_s) if shooting_variant
                        else gpode_noise_fn(margs_s))
            sf_s = step_factory
            if mesh is not None:  # the stage's draws: its own mesh step
                sf_s, noise_fn = step_factory, mesh_noise_fn
                if s_draws != margs.num_samples:
                    sf_s, noise_fn, _ = _mesh_step_factory(
                        args, margs_s, logger, shooting_variant)
            prev = trainer
            trainer = Trainer(loss_fn,
                              _train_config(args, stage_end, 100,
                                            shooting_variant, data_pca.trn.ts),
                              noise_fn, frozen_predicate=frozen, logger=logger,
                              checkpoint_path=(os.path.join(args.save,
                                                            "checkpt.npz")
                                               if main else None),
                              callback=val_callback,
                              callback_every=args.val_freq,
                              pass_iteration=(shooting_variant
                                              and margs.constraint_anneal_iters
                                              > 0),
                              step_factory=sf_s, model_args=margs_s,
                              kernels=args.kernels)
            if prev is not None:
                # meters continue across stages: one uninterrupted trace
                for meter in ("loss_meter", "observ_nll_meter",
                              "state_kl_meter", "init_kl_meter",
                              "inducing_kl_meter", "time_meter"):
                    setattr(trainer, meter, getattr(prev, meter))
            if len(stages) > 1:
                logger.info(f"[STAGE] iters {max(stage_start, start_iter)}-"
                            f"{stage_end}: num_samples={s_draws}")
            params, opt_state, gen = trainer.train(
                params, gen, train_ys, train_ts,
                start_iter=max(stage_start, start_iter), opt_state=opt_state)
            stage_start = stage_end + 1
        logger.info("********** Optimization completed **********")
        if main:
            save_trace(trainer, os.path.join(args.save,
                                             "optimization_trace.json"),
                       extra=val_meters)
            _final_checkpoint(args, params, opt_state, gen)

    if not main:  # rank 0 evaluates
        return params, trainer, None
    # evaluation from the observed first latent states
    def predictions(p, split, stream):
        noise = _predict_noise(p, margs, args.eval_sample_size,
                               generator(device, args.seed, stream), False)
        return mocap_predictions(p, noise, split.ts, split.ys[:, 0], eval_cfg,
                                 proj)

    train_pred_zs, train_pred_ys = predictions(params, data_pca.trn, _EVAL_TRAIN)
    test_pred_zs, test_pred_ys = predictions(params, data_pca.tst, _EVAL_TEST)
    noise_var = params.likelihood.variance.detach().cpu().numpy()
    train_ll, train_mse = compute_summary(data_full.trn.ys, train_pred_ys,
                                          noise_var)
    test_ll, test_mse = compute_summary(data_full.tst.ys, test_pred_ys,
                                        noise_var)
    logger.info(f"[TRAIN] LL {train_ll:.3f} | MSE {train_mse:.3f}")
    logger.info(f"[TEST]  LL {test_ll:.3f} | MSE {test_mse:.3f}")
    cal = compute_calibration(data_full.tst.ys, test_pred_ys, noise_var)
    logger.info("[TEST cal] " + " ".join(
        f"{int(q * 100)}%: {c:.3f}" for q, c in cal["coverage"].items())
        + f" | PIT MAE {cal['pit_mae']:.3f} (0.25 = calibrated)")

    # early-stopped evaluation: when validation ran, also score the
    # best-val-LL checkpoint on the test split (the same draws' noise)
    best_metrics = {}
    best_path = os.path.join(args.save, "checkpt_best.npz")
    if args.val_freq > 0 and os.path.exists(best_path):
        best_ck = load_checkpoint(best_path)
        bp = params_like(params, best_ck["params"], margs)
        _, by = predictions(bp, data_pca.tst, _EVAL_TEST)
        bnv = bp.likelihood.variance.detach().cpu().numpy()
        b_ll, b_mse = compute_summary(data_full.tst.ys, by, bnv)
        b_cal = compute_calibration(data_full.tst.ys, by, bnv)
        logger.info(f"[TEST best-val @ iter {int(best_ck['step'])}] "
                    f"LL {b_ll:.3f} | MSE {b_mse:.3f} | cal " + " ".join(
                        f"{int(q * 100)}%: {c:.3f}"
                        for q, c in b_cal["coverage"].items()))
        best_metrics = dict(test_ll_bestval=b_ll, test_mse_bestval=b_mse,
                            bestval_iter=int(best_ck["step"]),
                            calibration_bestval=b_cal)

    np.savez(os.path.join(args.save, "model_predictions.npz"),
             train_pred_zs=train_pred_zs, train_pred_ys=train_pred_ys,
             test_pred_zs=test_pred_zs, test_pred_ys=test_pred_ys,
             obs_noisevar=noise_var)
    if args.plots:
        _plot_mocap_results(args, params, data_pca, data_full, train_pred_zs,
                            train_pred_ys, test_pred_zs, test_pred_ys, trainer)
    metrics = dict(train_ll=train_ll, train_mse=train_mse,
                   test_ll=test_ll, test_mse=test_mse, calibration=cal,
                   **best_metrics)
    return params, trainer, metrics


def run_fhn_interpolation(args: ExperimentArgs, small: bool = False,
                          shooting_variant: bool = False):
    """FHN interpolation experiment on the shipped splits
    (`data/fhn/fhn_interpolation[_small].npz`): score the held-out
    interpolation window. Vanilla trains on the non-uniform observed times;
    shooting trains on the full uniform grid with the held-out points
    masked out of the likelihood (`obs_mask`, hidden entries zero-filled)
    and its model args as given (a dopri5 solve takes Hairer's first step).
    It draws no plots.
    """
    _check_ported(args, plots=False)
    device = resolve_device(args.device)
    name = ("fhn_interpolation_shooting" if shooting_variant
            else "fhn_interpolation")
    logger = _setup_run(args, name)

    split = load_fhn_interpolation(args.data_path, small=small)
    full_ts = split["full_ts"]
    mask = split["interpolation_mask"]          # True = held out

    margs = args.model_args()
    cfg = margs.solver_config(args.kernels)
    eval_cfg = _eval_cfg(cfg)
    rng = np.random.RandomState(args.seed)
    build_gen = generator("cpu", args.seed, _BUILD)

    if shooting_variant:
        train_ts = full_ts
        train_ys = np.where(mask[None, :, None], 0.0, split["full_ys"])
        obs_mask = _tensor(np.broadcast_to(~mask, train_ys.shape[:2]), device)
        params = build_shooting(build_gen, margs, train_ys, device=device)
        if not args.eval_only:
            initialize_inducing(params.gp, split["train_ys"],
                                float(split["train_ts"].max()), rng=rng)
            x0_noise = _predict_noise(params, margs, _X0_DRAWS[True],
                                      generator(device, args.seed, _INIT),
                                      False)
            initialize_shooting_states_with_data(params, x0_noise, train_ys,
                                                 train_ts, eval_cfg)

        def loss_fn(p, noise, ys, ts):
            return shooting.elbo_loss(p, noise, ys, ts, cfg,
                                      obs_mask=obs_mask)

        # every segment each step: the masked loss takes no minibatch
        noise_fn = shooting_noise_fn(dataclasses.replace(margs,
                                                         segment_minibatch=0))
        frozen = default_frozen_predicate(margs)
    else:
        train_ys, train_ts = split["train_ys"], split["train_ts"]
        params = build_gpode(build_gen, margs, train_ys, device=device)
        if not args.eval_only:
            initialize_inducing(params.gp, train_ys, float(train_ts.max()),
                                rng=rng)
            x0_noise = _predict_noise(params, margs, _X0_DRAWS[False],
                                      generator(device, args.seed, _INIT),
                                      False)
            initialize_latents_with_data(params, x0_noise, train_ys, train_ts,
                                         eval_cfg)
        loss_fn = gpode_loss_fn(margs, args.kernels)
        noise_fn = gpode_noise_fn(margs)
        frozen = None

    if args.eval_only:
        params = _load_eval_params(args, params, margs, logger)
        trainer = None
    else:
        params, opt_state0, gen_state, start_iter = _maybe_resume(
            args, params, margs, logger)
        trainer = Trainer(loss_fn,
                          TrainConfig(num_iter=args.num_iter, lr=args.lr,
                                      log_freq=args.log_freq,
                                      warmup_iters=min(100,
                                                       args.num_iter // 10),
                                      checkpoint_every=args.checkpoint_every,
                                      flatten_opt=args.flatten_opt,
                                      ncov_expected=_ncov_expected(
                                          shooting_variant, train_ts)),
                          noise_fn, frozen_predicate=frozen, logger=logger,
                          checkpoint_path=os.path.join(args.save,
                                                       "checkpt.npz"),
                          model_args=dataclasses.replace(
                              margs, segment_minibatch=0),
                          kernels=args.kernels)
        params, opt_state, gen = trainer.train(
            params, _train_generator(args, device, gen_state),
            _tensor(train_ys, device), _tensor(train_ts, device),
            start_iter=start_iter, opt_state=opt_state0)
        logger.info("********** Optimization completed **********")
        save_trace(trainer, os.path.join(args.save, "optimization_trace.json"))
        _final_checkpoint(args, params, opt_state, gen)

    # predict on the full grid from the optimized x0 posterior; score the
    # held-out interpolation window
    noise = _predict_noise(params, margs, args.eval_sample_size,
                           generator(device, args.seed, _EVAL), True)
    pred_full = _predict(params, noise, full_ts, eval_cfg,
                         device).cpu().numpy()
    noise_var = params.likelihood.variance.detach().cpu().numpy()
    interp_ll, interp_mse = compute_summary(split["full_ys"][:, mask],
                                            pred_full[:, :, mask], noise_var)
    train_mask = ~mask
    train_ll, train_mse = compute_summary(split["full_ys"][:, train_mask],
                                          pred_full[:, :, train_mask],
                                          noise_var)
    logger.info(f"[TRAIN]  LL {train_ll:.3f} | MSE {train_mse:.3f}")
    logger.info(f"[INTERP] LL {interp_ll:.3f} | MSE {interp_mse:.3f}")
    np.savez(os.path.join(args.save, "model_predictions.npz"),
             full_ts=full_ts, full_ys=split["full_ys"], pred_full=pred_full,
             interpolation_mask=mask, obs_noisevar=noise_var)
    return params, trainer, dict(train_ll=train_ll, train_mse=train_mse,
                                 interp_ll=interp_ll, interp_mse=interp_mse)
