"""Model wiring for the shooting GPODE. Counterpart of the shooting part of
`gpode_tpu/train/builders.py` (constraint annealing is not ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models import gp, shooting
from gpode_tpu_torch.models.constraints import init_constraint
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.likelihoods import (ProjectedGaussianLikelihood,
                                                Projector,
                                                init_gaussian_likelihood)
from gpode_tpu_torch.models.states import init_shooting_states


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
    num_samples: int = 5  # shooting MC draws per step
    constraint_type: str = "gauss"
    constraint_trainable: bool = False
    constraint_initial_scale: float = 1e-3

    def solver_config(self, kernels: Optional[bool] = None) -> SolverConfig:
        return SolverConfig(solver=self.solver, rtol=self.rtol, atol=self.atol,
                            ts_dense_scale=self.ts_dense_scale,
                            max_steps=self.max_steps,
                            first_step=self.first_step, kernels=kernels)


def make_projector(arrays, device) -> Projector:
    """A `Projector` module from the arrays of `latent_to_data_projector`."""
    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32,
                                                      device=device)
    return Projector(t(arrays.components), t(arrays.norm_mean),
                     t(arrays.norm_std))


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
    if projector is None:
        likelihood = init_gaussian_likelihood(d, device=device)
    else:
        likelihood = ProjectedGaussianLikelihood(
            init_gaussian_likelihood(full_dim, device=device),
            make_projector(projector, device))
    constraint = init_constraint(args.constraint_type, d=1,
                                 scale=args.constraint_initial_scale,
                                 device=device)
    return shooting.ShootingParams(gp_params, states, likelihood, constraint)


def shooting_loss_fn(args: ModelArgs, kernels: Optional[bool] = None):
    """loss(params, noise, ys, ts) -> (loss, ShootingELBOTerms)."""
    cfg = args.solver_config(kernels)

    def loss(params, noise, ys, ts):
        return shooting.elbo_loss(params, noise, ys, ts, cfg)

    return loss


def default_frozen_predicate(args: ModelArgs):
    """Which parameters stay fixed during training: the constraint scale
    unless `constraint_trainable`."""

    def predicate(path: str) -> bool:
        return ("constraint" in path) and not args.constraint_trainable

    return predicate
