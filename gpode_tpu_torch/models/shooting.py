"""Shooting GPODE: multiple-shooting ELBO with segment-parallel integration.

Counterpart of `gpode_tpu/models/shooting.py`: all S*N*T shooting segments
are flattened into one batch and integrated over the single uniform interval
`ts[:2]`. Five ELBO terms:

    loss = -( mean obs-loglik
              + sum_t mean_s constraint-loglik / num_obs
              + sum entropy(q(s)) / num_obs
              - KL(q(x0)) / num_obs
              - KL(q(u)) / num_obs )

The noise of one step is a :class:`StepNoise` of tensors; with segment
minibatching it also carries the step's segment indices.

Under a rank mesh (`gpode_tpu_torch/parallel/`) each rank integrates only
its own (S_l, N_l, T, D) block of the segments, in one flow call (so the
kernels take the rank's rows), and `elbo_loss` returns the rank's part of
the objective; `parallel/train.py` sums the parts and reduces the solver
statistics over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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
from gpode_tpu_torch.utils.profiling import span

# the span around the segments' solve, which `parallel/collective_audit.py`
# holds free of collectives under a mesh
SOLVE_RANGE = "gpode.segment_solve"


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
    (S, N, D) and states (S, N, T-1, D) standard normals; segment_idx (K,)
    distinct segment indices in [0, T) for a minibatched step, else None.
    """

    rff_weights: torch.Tensor
    rff_freq: torch.Tensor
    rff_phase: torch.Tensor
    inducing: torch.Tensor
    x0: torch.Tensor
    states: torch.Tensor
    segment_idx: Optional[torch.Tensor] = None


def sample_draw_noise(params: ShootingParams, num_features: int,
                      generator: torch.Generator) -> dict:
    """The posterior draw's part of a :class:`StepNoise` (rff_weights,
    rff_freq, rff_phase, inducing), from `generator` on the params'
    device: the first draws of a step."""
    dev = params.gp.z.device
    m, din = params.gp.z.shape
    d = params.gp.u_mean.shape[1]
    kw = dict(generator=generator, device=dev)
    freq_shape = (din, num_features, d) if params.gp.dimwise else (din, num_features)
    phase_shape = (1, num_features, d) if params.gp.dimwise else (1, num_features)
    return dict(rff_weights=torch.randn(num_features, d, **kw),
                rff_freq=torch.randn(*freq_shape, **kw),
                rff_phase=torch.rand(*phase_shape, **kw),
                inducing=torch.randn(m, d, **kw))


def sample_step_noise(params: ShootingParams, num_features: int,
                      num_samples: int, generator: torch.Generator,
                      segment_minibatch: int = 0) -> StepNoise:
    """Fill a :class:`StepNoise` from `generator` (on the params' device).
    With 0 < `segment_minibatch` = K < T the step integrates K segments
    drawn without replacement (`torch.randperm(T)[:K]`, drawn after the
    other noise, so the draws before it are those of a full step)."""
    n, t1, d = params.states.mean.shape
    kw = dict(generator=generator, device=params.gp.z.device)
    noise = StepNoise(**sample_draw_noise(params, num_features, generator),
                      x0=torch.randn(num_samples, n, d, **kw),
                      states=torch.randn(num_samples, n, t1, d, **kw))
    if 0 < segment_minibatch < t1 + 1:
        noise.segment_idx = torch.randperm(t1 + 1, **kw)[:segment_minibatch]
    return noise


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
              ts: torch.Tensor, cfg: SolverConfig,
              constraint_raw_scale: Optional[torch.Tensor] = None,
              obs_mask: Optional[torch.Tensor] = None, mesh=None
              ) -> tuple[torch.Tensor, ShootingELBOTerms]:
    """Negative shooting ELBO; ys (N, T, D_obs), ts (T,) uniform grid. One GP
    function draw is shared by all state samples.

    `noise.segment_idx` (K indices in [0, T)) integrates only those K
    segments, with an unbiased estimator of the full objective: the
    observation term is the subsample mean, the continuity term a
    Horvitz-Thompson sum (each segment's constraint weighted by T/K, the
    final segment, which has no successor, masked), and the entropy and
    both KLs are exact. `constraint_raw_scale` replaces the constraint's
    raw scale (constraint annealing, `train/builders.constraint_annealer`).

    `obs_mask` (optional, (N, T) of {0, 1}) marks the observed time points:
    the others drop out of the likelihood, which is normalised by the full
    observed count (scaled by T/K and taken at the step's segments under
    minibatching), and num_obs = (observed count) * D_obs scales the other
    terms. The shooting states and the continuity constraint still span the
    whole grid, so the posterior interpolates through the gaps.

    `mesh` (a `parallel.mesh.Mesh`, the counterpart of the JAX `seg_mesh`):
    the rank's part of the objective. `ys` is then the rank's sequences
    (its block over `dp`), `noise.x0` / `noise.states` the normals of its
    block of samples and sequences (S_l, N_l, ...), and the draw's noise
    and `segment_idx` are every rank's. The rank integrates its block in
    one flow call inside the profiler range `SOLVE_RANGE`. The observation
    and continuity terms are its local sums scaled to the global means;
    the entropy and both KLs, which read only the replicated parameters,
    count on rank 0 alone. So the returned loss and each term sum over the
    ranks to the single-device values, and so do the gradients of the
    losses; the solver statistics are the rank's own. `obs_mask` takes no
    mesh: its normaliser counts every rank's observations.
    """
    n_lo, n_hi = 0, params.states.mean.shape[0]
    if mesh is not None:
        if obs_mask is not None:
            raise ValueError("elbo_loss: obs_mask takes no mesh")
        n_lo, n_hi = mesh.sequence_block(n_hi)
        if ys.shape[0] != n_hi - n_lo:
            raise ValueError(f"ys holds {ys.shape[0]} sequences; this rank's "
                             f"block of the model's is {n_hi - n_lo}")
    with span("gpode.states"):
        ss = sample_shooting_states(params.states, noise.x0, noise.states,
                                    slice(n_lo, n_hi))
        t = ss.shape[2]
        idx = noise.segment_idx
        if idx is None:
            ss_batch, ys_batch = ss, ys
        else:
            k = idx.shape[0]
            ss_batch = ss.index_select(2, idx)                   # (S,N,K,D)
            ys_batch = ys.index_select(1, idx)
            # continuity partner: state idx+1 (the final segment has none)
            has_next = (idx < t - 1).to(ss.dtype)                 # (K,)
            ss_next = ss.index_select(2, torch.clamp(idx + 1, max=t - 1))
    draw = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                             noise.rff_phase, noise.inducing,
                             kernels=cfg.kernels)
    with span(SOLVE_RANGE):
        pred, stats = integrate_segments(params.gp, draw, ss_batch, ts[:2],
                                         cfg)

    with span("gpode.elbo"):
        lp = likelihood_log_prob(params.likelihood, pred, ys_batch[None])
        if obs_mask is None:
            observ_loglik = torch.mean(lp)
            num_obs = ys.numel()
        else:
            mask = obs_mask if idx is None else obs_mask.index_select(1, idx)
            m_total = torch.sum(obs_mask)
            batch_scale = 1.0 if idx is None else t / k
            m = mask[None, :, :, None].to(lp.dtype)
            observ_loglik = (batch_scale * torch.sum(lp * m)
                             / (ss.shape[0] * m_total * lp.shape[-1]))
            num_obs = m_total * lp.shape[-1]

        def constraint(loc, y):
            return constraint_log_prob(params.constraint, loc, y,
                                       constraint_raw_scale).sum(dim=3)

        if idx is None:
            # (S, N, T-1)
            constr = constraint(ss[:, :, 1:, :], pred[:, :, :-1, :])
            scaled_constr = torch.mean(constr, dim=0).sum() / num_obs
        else:
            constr = constraint(ss_next, pred)                    # (S,N,K)
            # Horvitz-Thompson: inclusion probability K/T per segment
            scaled_constr = ((t / k)
                             * torch.mean(constr * has_next, dim=0).sum()
                             / num_obs)
        if mesh is not None:
            # this block's share of the global means: 1 / (its share of the
            # samples and of the sequences), and of the mean over samples
            dp, mc = mesh.axis_size("dp"), mesh.axis_size("mc")
            num_obs = num_obs * dp
            observ_loglik = observ_loglik / (dp * mc)
            scaled_constr = scaled_constr / (dp * mc)
        if mesh is None or mesh.rank == 0:
            scaled_entropy = shooting_entropy(
                params.states, kernels=cfg.kernels).sum() / num_obs
            x0_kl = initial_state_kl(params.states.x0) / num_obs
            ind_kl = gp.kl(params.gp) / num_obs
        else:
            scaled_entropy = x0_kl = ind_kl = ss.new_zeros(())

        loss = -(observ_loglik + scaled_constr + scaled_entropy - x0_kl
                 - ind_kl)
    return loss, ShootingELBOTerms(
        loss=loss, observ_nll=-observ_loglik,
        state_kl=-(scaled_constr + scaled_entropy), x0_kl=x0_kl,
        inducing_kl=ind_kl, nfe=stats.num_rhs_evals,
        natt=stats.num_attempted, ncov=stats.num_covered)
