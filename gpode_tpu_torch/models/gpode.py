"""Vanilla GPODE: whole-trajectory ELBO and posterior-predictive sampling.

Counterpart of `gpode_tpu/models/gpode.py`. The ELBO of one step is

    loss = -( mean loglik - KL(q(x0)) / num_obs - KL(q(u)) / num_obs )

with one x0 sample and one GP function draw. Prediction over S posterior
draws is ONE batched solve (`flow.flow_forward_batched`): each draw has its
own function draw and, when x0 is not given, its own q(x0) sample.

Random numbers are inputs: a :class:`GPODEStepNoise` (one train step) or a
:class:`PredictNoise` (one prediction) carries every normal and uniform
consumed, filled from a `torch.Generator` or, in the tests, from the JAX
package's own keys.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.models.flow import (SolverConfig, flow_forward,
                                         flow_forward_batched)
from gpode_tpu_torch.models.likelihoods import likelihood_log_prob
from gpode_tpu_torch.models.states import (InitialStatePosterior,
                                           initial_state_kl,
                                           sample_initial_state)
from gpode_tpu_torch.utils.time_grids import insert_zero_t0


class GPODEParams(nn.Module):
    """Trainable state of the vanilla GPODE model: the SVGP vector field,
    q(x0) and the likelihood. Parameter names follow the JAX package's leaf
    paths (`gp.z`, `x0.mean`, `likelihood.base.raw_variance`, ...).

    A shooting model is scored through the view
    `GPODEParams(p.gp, p.states.x0, p.likelihood)`, which shares (does not
    copy) those submodules of `ShootingParams` `p`."""

    def __init__(self, gp_params: gp.SVGPParams, x0: InitialStatePosterior,
                 likelihood: nn.Module):
        super().__init__()
        self.gp = gp_params
        self.x0 = x0
        self.likelihood = likelihood


@dataclasses.dataclass
class GPODEStepNoise:
    """Every random number one vanilla train step consumes.

    rff_weights (S_rff, D) and rff_freq (Din, S_rff, D) standard normals
    ((Din, S_rff) when not dimwise); rff_phase (1, S_rff, D) uniforms in
    [0, 1) ((1, S_rff) when not dimwise); inducing (M, D) and x0 (N, D)
    standard normals.
    """

    rff_weights: torch.Tensor
    rff_freq: torch.Tensor
    rff_phase: torch.Tensor
    inducing: torch.Tensor
    x0: torch.Tensor


def sample_gpode_step_noise(params: GPODEParams, num_features: int,
                            generator: torch.Generator) -> GPODEStepNoise:
    """Fill a :class:`GPODEStepNoise` from `generator` (on the params'
    device)."""
    dev = params.gp.z.device
    m, din = params.gp.z.shape
    d = params.gp.u_mean.shape[1]
    kw = dict(generator=generator, device=dev)
    f, dimwise = num_features, params.gp.dimwise
    return GPODEStepNoise(
        rff_weights=torch.randn(f, d, **kw),
        rff_freq=torch.randn(*((din, f, d) if dimwise else (din, f)), **kw),
        rff_phase=torch.rand(*((1, f, d) if dimwise else (1, f)), **kw),
        inducing=torch.randn(m, d, **kw),
        x0=torch.randn(*params.x0.mean.shape, **kw))


class ELBOTerms(NamedTuple):
    """Per-step scalars: loss and its terms (tensors), solver stats (ints).
    ncov below T + 1 means the adaptive solver ran out of budget before the
    last observation time."""

    loss: torch.Tensor
    observ_nll: torch.Tensor
    x0_kl: torch.Tensor
    inducing_kl: torch.Tensor
    nfe: int
    natt: int
    ncov: int


def elbo_loss(params: GPODEParams, noise: GPODEStepNoise, ys: torch.Tensor,
              ts: torch.Tensor, cfg: SolverConfig,
              obs_mask: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, ELBOTerms]:
    """Negative ELBO of one step; ys (N, T, D_obs), ts (T,). One x0 sample
    and one GP function draw; the trajectory starts one interval before the
    first observation (`insert_zero_t0`).

    obs_mask (optional, (N, T) of {0, 1}) marks the observed time points:
    the others drop out of the likelihood and of the num_obs KL scaling.
    """
    x0 = sample_initial_state(params.x0, noise.x0[None])[0]      # (N, D)
    draw = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                             noise.rff_phase, noise.inducing,
                             kernels=cfg.kernels)
    xs, stats = flow_forward(params.gp, draw, x0, insert_zero_t0(ts), cfg)
    xs = xs[:, 1:]                                               # drop t=0

    lp = likelihood_log_prob(params.likelihood, xs, ys)
    if obs_mask is None:
        loglik = torch.mean(lp)
        num_obs = ys.numel()
    else:
        m = obs_mask[:, :, None].to(lp.dtype)
        num_obs = torch.sum(m) * lp.shape[-1]
        loglik = torch.sum(lp * m) / num_obs
    x0_kl = initial_state_kl(params.x0) / num_obs
    ind_kl = gp.kl(params.gp) / num_obs

    loss = -(loglik - x0_kl - ind_kl)
    return loss, ELBOTerms(loss=loss, observ_nll=-loglik, x0_kl=x0_kl,
                           inducing_kl=ind_kl, nfe=stats.num_rhs_evals,
                           natt=stats.num_attempted, ncov=stats.num_covered)


@dataclasses.dataclass
class PredictNoise:
    """Every random number one `predict` of S draws consumes.

    rff_weights (S, S_rff, D) and rff_freq (S, Din, S_rff, D) standard
    normals ((S, Din, S_rff) when not dimwise); rff_phase (S, 1, S_rff, D)
    uniforms in [0, 1) ((S, 1, S_rff) when not dimwise); inducing (S, M, D)
    standard normals; x0 (S, N, D) standard normals for the q(x0) samples,
    or None when the caller gives x0.
    """

    rff_weights: torch.Tensor
    rff_freq: torch.Tensor
    rff_phase: torch.Tensor
    inducing: torch.Tensor
    x0: Optional[torch.Tensor] = None


def sample_draw_noise(gp_params: gp.SVGPParams, num_features: int,
                      num_draws: int, generator: torch.Generator) -> PredictNoise:
    """The function-draw part of a :class:`PredictNoise` (x0 None) for
    `num_draws` draws of `gp_params`'s posterior, from `generator` (on the
    params' device)."""
    dev = gp_params.z.device
    m, din = gp_params.z.shape
    d = gp_params.u_mean.shape[1]
    kw = dict(generator=generator, device=dev)
    s, f = num_draws, num_features
    dimwise = gp_params.dimwise
    return PredictNoise(
        rff_weights=torch.randn(s, f, d, **kw),
        rff_freq=torch.randn(*((s, din, f, d) if dimwise else (s, din, f)), **kw),
        rff_phase=torch.rand(*((s, 1, f, d) if dimwise else (s, 1, f)), **kw),
        inducing=torch.randn(s, m, d, **kw))


def sample_predict_noise(params: GPODEParams, num_features: int,
                         num_draws: int, generator: torch.Generator,
                         sample_x0: bool = True) -> PredictNoise:
    """Fill a :class:`PredictNoise` for `num_draws` draws from `generator`
    (on the params' device): the function draws' noise, then the x0
    normals. `sample_x0=False` leaves out the x0 normals, for predictions
    from given start states."""
    noise = sample_draw_noise(params.gp, num_features, num_draws, generator)
    if sample_x0:
        noise.x0 = torch.randn(num_draws, *params.x0.mean.shape,
                               generator=generator, device=params.gp.z.device)
    return noise


def predict(params: GPODEParams, noise: PredictNoise, ts: torch.Tensor,
            cfg: SolverConfig, x0: Optional[torch.Tensor] = None,
            t0_shift: Optional[float] = None) -> torch.Tensor:
    """Posterior-predictive latent trajectories: (S, N, T, D), S the draws
    of `noise`.

    With x0=None each draw starts from its own q(x0) sample and ts is
    augmented with the t=0 point, which is then dropped; `t0_shift` pins the
    augmentation shift to the training grid's first interval. With a given
    x0 (N, D), ts is used as it is. All draws share one Cholesky of K(Z, Z).
    """
    chol = gp.precompute_chol(params.gp)
    draws = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                              noise.rff_phase, noise.inducing, chol)
    if x0 is None:
        if noise.x0 is None:
            raise ValueError("predict without x0 samples q(x0): the noise "
                             "needs its x0 normals (sample_x0=True)")
        starts = sample_initial_state(params.x0, noise.x0)
        xs, _ = flow_forward_batched(params.gp, draws, starts,
                                     insert_zero_t0(ts, t0_shift), cfg)
        return xs[:, :, 1:]
    starts = x0.expand(noise.inducing.shape[0], *x0.shape)
    xs, _ = flow_forward_batched(params.gp, draws, starts, ts, cfg)
    return xs
