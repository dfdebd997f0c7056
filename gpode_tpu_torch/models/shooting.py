"""Shooting GPODE: multiple-shooting ELBO with segment-parallel integration.

Counterpart of `gpode_tpu/models/shooting.py`: all S*N*T shooting segments
are flattened into one batch and integrated over the single uniform interval
`ts[:2]`. Five ELBO terms:

    loss = -( mean obs-loglik
              + sum_t mean_s constraint-loglik / num_obs
              + sum entropy(q(s)) / num_obs
              - KL(q(x0)) / num_obs
              - KL(q(u)) / num_obs )

The noise of one step is a :class:`StepNoise` of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.models.constraints import constraint_log_prob
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward
from gpode_tpu_torch.models.likelihoods import likelihood_log_prob
from gpode_tpu_torch.models.states import (initial_state_kl,
                                           sample_shooting_states,
                                           shooting_entropy)
from gpode_tpu_torch.ops.ode import ODEStats


class ShootingParams(nn.Module):
    """Trainable state of the shooting GPODE model. Parameter names follow
    the JAX package's leaf paths (`gp.kernel.raw_lengthscales`,
    `states.x0.mean`, `likelihood.projector.components`, ...)."""

    def __init__(self, gp_params: gp.SVGPParams, states: nn.Module,
                 likelihood: nn.Module, constraint: nn.Module):
        super().__init__()
        self.gp = gp_params
        self.states = states
        self.likelihood = likelihood
        self.constraint = constraint


@dataclasses.dataclass
class StepNoise:
    """Every random number one train step consumes.

    rff_weights (S_rff, D) and rff_freq (Din, S_rff, D) standard normals;
    rff_phase (1, S_rff, D) uniforms in [0, 1); inducing (M, D), x0
    (S, N, D) and states (S, N, T-1, D) standard normals.
    """

    rff_weights: torch.Tensor
    rff_freq: torch.Tensor
    rff_phase: torch.Tensor
    inducing: torch.Tensor
    x0: torch.Tensor
    states: torch.Tensor


def sample_step_noise(params: ShootingParams, num_features: int,
                      num_samples: int,
                      generator: torch.Generator) -> StepNoise:
    """Fill a :class:`StepNoise` from `generator` (on the params' device)."""
    dev = params.gp.z.device
    m, din = params.gp.z.shape
    d = params.gp.u_mean.shape[1]
    n, t1, _ = params.states.mean.shape
    kw = dict(generator=generator, device=dev)
    freq_shape = (din, num_features, d) if params.gp.dimwise else (din, num_features)
    phase_shape = (1, num_features, d) if params.gp.dimwise else (1, num_features)
    return StepNoise(
        rff_weights=torch.randn(num_features, d, **kw),
        rff_freq=torch.randn(*freq_shape, **kw),
        rff_phase=torch.rand(*phase_shape, **kw),
        inducing=torch.randn(m, d, **kw),
        x0=torch.randn(num_samples, n, d, **kw),
        states=torch.randn(num_samples, n, t1, d, **kw))


class ShootingELBOTerms(NamedTuple):
    """Per-step scalars: loss and its terms (tensors), solver stats (ints)."""

    loss: torch.Tensor
    observ_nll: torch.Tensor
    state_kl: torch.Tensor  # -(constraint loglik + entropy)
    x0_kl: torch.Tensor
    inducing_kl: torch.Tensor
    nfe: int
    natt: int
    ncov: int


def stack_segments(x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (prod(...), D)."""
    return x.reshape(-1, x.shape[-1])


def integrate_segments(gp_params: gp.SVGPParams, draw: gp.PosteriorDraw,
                       ss: torch.Tensor, ts_pair: torch.Tensor,
                       cfg: SolverConfig) -> tuple[torch.Tensor, ODEStats]:
    """Advance every shooting state one interval: (S, N, T, D) -> endpoints
    (S, N, T, D), as one flow call over the flattened segment batch."""
    xs, stats = flow_forward(gp_params, draw, stack_segments(ss), ts_pair, cfg)
    return xs[:, -1].reshape(ss.shape), stats


def elbo_loss(params: ShootingParams, noise: StepNoise, ys: torch.Tensor,
              ts: torch.Tensor, cfg: SolverConfig
              ) -> tuple[torch.Tensor, ShootingELBOTerms]:
    """Negative shooting ELBO; ys (N, T, D_obs), ts (T,) uniform grid. One GP
    function draw is shared by all state samples."""
    ss = sample_shooting_states(params.states, noise.x0, noise.states)
    draw = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                             noise.rff_phase, noise.inducing)
    pred, stats = integrate_segments(params.gp, draw, ss, ts[:2], cfg)

    lp = likelihood_log_prob(params.likelihood, pred, ys[None])
    observ_loglik = torch.mean(lp)
    num_obs = ys.numel()

    constr = constraint_log_prob(params.constraint, ss[:, :, 1:, :],
                                 pred[:, :, :-1, :]).sum(dim=3)  # (S,N,T-1)
    scaled_constr = torch.mean(constr, dim=0).sum() / num_obs
    scaled_entropy = shooting_entropy(params.states).sum() / num_obs
    x0_kl = initial_state_kl(params.states.x0) / num_obs
    ind_kl = gp.kl(params.gp) / num_obs

    loss = -(observ_loglik + scaled_constr + scaled_entropy - x0_kl - ind_kl)
    return loss, ShootingELBOTerms(
        loss=loss, observ_nll=-observ_loglik,
        state_kl=-(scaled_constr + scaled_entropy), x0_kl=x0_kl,
        inducing_kl=ind_kl, nfe=stats.num_rhs_evals,
        natt=stats.num_attempted, ncov=stats.num_covered)
