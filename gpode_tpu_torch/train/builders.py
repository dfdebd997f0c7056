"""Model wiring for the vanilla and the shooting GPODE. Counterpart of
`gpode_tpu/train/builders.py`, with the step's noise samplers beside the
losses (random numbers are inputs in the port)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models import gp, gpode, shooting
from gpode_tpu_torch.models.constraints import init_constraint
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.likelihoods import (ProjectedGaussianLikelihood,
                                                Projector,
                                                init_gaussian_likelihood)
from gpode_tpu_torch.models.states import (init_initial_state,
                                           init_shooting_states)
from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.ode import SOLVERS

CONSTRAINTS = ("gauss", "laplace")


@dataclasses.dataclass(frozen=True)
class ModelArgs:
    """Static model hyperparameters (names and defaults as in the JAX
    package's `ModelArgs`)."""

    num_features: int = 256
    num_inducing: int = 16
    dimwise: bool = True
    q_diag: bool = False
    solver: str = "dopri5"
    ts_dense_scale: int = 4
    rtol: float = 1e-6
    atol: float = 1e-6
    max_steps: int = 256
    first_step: Optional[float] = None  # dopri5 initial dt; -1.0 = full span
    use_adjoint: bool = False  # continuous-adjoint gradients
    remat: bool = False        # rematerialize rhs evaluations in backward
    num_samples: int = 5  # shooting MC draws per step
    constraint_type: str = "gauss"
    constraint_trainable: bool = False
    constraint_initial_scale: float = 1e-3
    # Constraint-scale annealing (0 = off): the continuity scale decays
    # geometrically from `constraint_anneal_start` to
    # `constraint_initial_scale` over the first `constraint_anneal_iters`
    # iterations (`constraint_annealer`).
    constraint_anneal_iters: int = 0
    constraint_anneal_start: float = 0.1
    # Stochastic segment minibatching (0 = off): integrate K uniformly
    # sampled shooting segments per step (`shooting.elbo_loss`).
    segment_minibatch: int = 0

    def solver_config(self, kernels: Optional[bool] = None) -> SolverConfig:
        """The solver knobs (`kernels`: the kernel rule, see
        `SolverConfig`)."""
        return SolverConfig(solver=self.solver, rtol=self.rtol, atol=self.atol,
                            ts_dense_scale=self.ts_dense_scale,
                            max_steps=self.max_steps,
                            first_step=self.first_step, remat=self.remat,
                            use_adjoint=self.use_adjoint, kernels=kernels)


def make_projector(arrays, device) -> Projector:
    """A `Projector` module from the arrays of `latent_to_data_projector`,
    on copies: a CPU parameter made with `as_tensor` would share the
    dataset's PCA arrays, and training would move them."""
    def t(a):
        return None if a is None else torch.tensor(a, dtype=torch.float32,
                                                   device=device)
    return Projector(t(arrays.components), t(arrays.norm_mean),
                     t(arrays.norm_std))


def _init_likelihood(d, projector, full_dim, device):
    if projector is None:
        return init_gaussian_likelihood(d, device=device)
    return ProjectedGaussianLikelihood(
        init_gaussian_likelihood(full_dim, device=device),
        make_projector(projector, device))


def build_gpode(generator: torch.Generator, args: ModelArgs,
                data_ys: np.ndarray, projector=None,
                full_dim: Optional[int] = None,
                device=None) -> gpode.GPODEParams:
    """Vanilla GPODE params for observed sequences (N, T, D_latent). With a
    projector (a `ProjectorArrays`) the likelihood is scored in the
    `full_dim`-D data space. `device` defaults to CUDA (see
    `resolve_device`)."""
    device = resolve_device(device)
    n, _, d = data_ys.shape
    gp_params = gp.init_svgp(generator, d, d, args.num_inducing,
                             dimwise=args.dimwise, q_diag=args.q_diag,
                             device=device)
    x0 = init_initial_state(generator, n, d, device)
    return gpode.GPODEParams(gp_params, x0,
                             _init_likelihood(d, projector, full_dim, device))


def build_shooting(generator: torch.Generator, args: ModelArgs,
                   data_ys: np.ndarray, projector=None,
                   full_dim: Optional[int] = None,
                   device=None) -> shooting.ShootingParams:
    """Shooting GPODE params: T-1 shooting states per sequence. `projector`
    is a `ProjectorArrays` (scores the likelihood in `full_dim`-D data
    space) or None. `device` defaults to CUDA (see `resolve_device`)."""
    device = resolve_device(device)
    n, t, d = data_ys.shape
    gp_params = gp.init_svgp(generator, d, d, args.num_inducing,
                             dimwise=args.dimwise, q_diag=args.q_diag,
                             device=device)
    states = init_shooting_states(generator, n, t - 1, d, device)
    likelihood = _init_likelihood(d, projector, full_dim, device)
    constraint = init_constraint(args.constraint_type, d=1,
                                 scale=args.constraint_initial_scale,
                                 device=device)
    return shooting.ShootingParams(gp_params, states, likelihood, constraint)


def gpode_loss_fn(args: ModelArgs, kernels: Optional[bool] = None):
    """loss(params, noise, ys, ts) -> (loss, ELBOTerms) for the vanilla
    model."""
    cfg = args.solver_config(kernels)

    def loss(params, noise, ys, ts):
        return gpode.elbo_loss(params, noise, ys, ts, cfg)

    return loss


def gpode_noise_fn(args: ModelArgs):
    """noise(params, generator) -> the `GPODEStepNoise` of one vanilla
    step."""

    def noise(params, generator):
        return gpode.sample_gpode_step_noise(params, args.num_features,
                                             generator)

    return noise


def constraint_annealer(args: ModelArgs):
    """itr -> the annealed constraint raw scale, or None when annealing is
    off.

    The scale decays geometrically from `constraint_anneal_start` to
    `constraint_initial_scale` over the first `constraint_anneal_iters`
    iterations and stays there: with f = clip(itr / horizon, 0, 1) the raw
    scale is invsoftplus(exp((1 - f) log start + f log final)), in the
    dtype of `itr` (a float32 device tensor the Trainer increments, so the
    step reads no host value)."""
    if args.constraint_anneal_iters <= 0:
        return None
    log_start = float(np.log(args.constraint_anneal_start))
    log_final = float(np.log(args.constraint_initial_scale))
    horizon = float(args.constraint_anneal_iters)

    def anneal(itr: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(itr / horizon, 0.0, 1.0)
        scale = torch.exp((1.0 - frac) * log_start + frac * log_final)
        return om.invsoftplus(scale, dtype=itr.dtype)

    return anneal


def shooting_loss_fn(args: ModelArgs, kernels: Optional[bool] = None,
                     mesh=None):
    """loss(params, noise, ys, ts) -> (loss, ShootingELBOTerms).

    With `constraint_anneal_iters > 0` the signature becomes
    loss(params, noise, itr, ys, ts) (the Trainer passes its device-side
    iteration counter): the constraint scale follows `constraint_annealer`
    instead of `params.constraint.raw_scale`. With a `mesh` the loss is the
    rank's part of the objective (`shooting.elbo_loss`)."""
    cfg = args.solver_config(kernels)
    anneal = constraint_annealer(args)
    if anneal is not None:

        def annealed(params, noise, itr, ys, ts):
            raw = anneal(itr).expand_as(params.constraint.raw_scale)
            return shooting.elbo_loss(params, noise, ys, ts, cfg,
                                      constraint_raw_scale=raw, mesh=mesh)

        return annealed

    def loss(params, noise, ys, ts):
        return shooting.elbo_loss(params, noise, ys, ts, cfg, mesh=mesh)

    return loss


def shooting_noise_fn(args: ModelArgs):
    """noise(params, generator) -> the `StepNoise` of one shooting step
    (with `segment_minibatch` segment indices when minibatching)."""

    def noise(params, generator):
        return shooting.sample_step_noise(
            params, args.num_features, args.num_samples, generator,
            segment_minibatch=args.segment_minibatch)

    return noise


def default_frozen_predicate(args: ModelArgs):
    """Which parameters stay fixed during training: the constraint scale
    unless `constraint_trainable`."""

    def predicate(path: str) -> bool:
        return ("constraint" in path) and not args.constraint_trainable

    return predicate
