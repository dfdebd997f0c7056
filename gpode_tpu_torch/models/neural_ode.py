"""NeuralODE baseline: a deterministic MLP vector field on the shared solvers.

Counterpart of `gpode_tpu/models/neural_ode.py`: a Linear-Tanh-Linear-Tanh-
Linear network (H=128 by default) as dx/dt, an MSE loss from the observed
initial state, deterministic predictions. The MLP is three plain
`torch.matmul`s (the JAX package computes it outside any Pallas kernel);
`ops/ode.odeint` integrates it.

Parameter names are the JAX package's leaf paths (`mlp.w1` ... `mlp.b3`),
so a JAX checkpoint loads through `convert.py`. The model draws no noise in
training: its step noise is None.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.ops.ode import ODEStats, odeint


class MLPParams(nn.Module):
    """Three-layer tanh MLP: w1 (D, H), b1 (H,), w2 (H, H), b2 (H,),
    w3 (H, D), b3 (D,)."""

    def __init__(self, w1, b1, w2, b2, w3, b3):
        super().__init__()
        for name, value in zip(("w1", "b1", "w2", "b2", "w3", "b3"),
                               (w1, b1, w2, b2, w3, b3)):
            setattr(self, name, nn.Parameter(value))


class NeuralODEParams(nn.Module):
    def __init__(self, mlp: MLPParams):
        super().__init__()
        self.mlp = mlp


def init_neural_ode(generator: torch.Generator, d: int, hidden: int = 128,
                    device=None) -> NeuralODEParams:
    """Weights N(0, 0.1), zero biases. The normals come from `generator`
    (on the host) and are moved, so every device starts from the same
    values."""
    std = 0.1

    def normal(*shape):
        return (std * torch.randn(*shape, generator=generator)).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)

    return NeuralODEParams(MLPParams(
        w1=normal(d, hidden), b1=zeros(hidden),
        w2=normal(hidden, hidden), b2=zeros(hidden),
        w3=normal(hidden, d), b3=zeros(d)))


def mlp_rhs(params: NeuralODEParams, x: torch.Tensor) -> torch.Tensor:
    """dx/dt = MLP(x); (..., D) -> (..., D). Time-invariant."""
    m = params.mlp
    h = torch.tanh(torch.matmul(x, m.w1) + m.b1)
    h = torch.tanh(torch.matmul(h, m.w2) + m.b2)
    return torch.matmul(h, m.w3) + m.b3


def neural_ode_forward(params: NeuralODEParams, x0: torch.Tensor,
                       ts: torch.Tensor, cfg: SolverConfig
                       ) -> tuple[torch.Tensor, ODEStats]:
    """Integrate from x0 (N, D) over ts (T,): ((N, T, D), stats)."""
    xs, stats = odeint(lambda t, x: mlp_rhs(params, x), x0, ts,
                       solver=cfg.solver, rtol=cfg.rtol, atol=cfg.atol,
                       substeps=cfg.substeps, max_steps=cfg.max_steps)
    return torch.movedim(xs, 0, 1), stats


class NeuralODETerms(NamedTuple):
    """Per-step scalars in the Trainer's fields: the MSE is the loss and the
    observation term, the KL terms are zero; solver stats (ints)."""

    loss: torch.Tensor
    observ_nll: torch.Tensor
    x0_kl: torch.Tensor
    inducing_kl: torch.Tensor
    nfe: int
    natt: int
    ncov: int


def mse_loss(params: NeuralODEParams, noise, ys: torch.Tensor,
             ts: torch.Tensor, cfg: SolverConfig
             ) -> tuple[torch.Tensor, NeuralODETerms]:
    """MSE of the trajectory from the observed initial state ys[:, 0].
    `noise` keeps the Trainer's signature (the model draws none)."""
    del noise
    pred, stats = neural_ode_forward(params, ys[:, 0], ts, cfg)
    loss = torch.mean(torch.square(pred - ys))
    zero = torch.zeros((), device=ys.device)
    return loss, NeuralODETerms(loss=loss, observ_nll=loss, x0_kl=zero,
                                inducing_kl=zero, nfe=stats.num_rhs_evals,
                                natt=stats.num_attempted,
                                ncov=stats.num_covered)


def no_noise(params, generator):
    """The Trainer's noise function for the neural ODE: no noise."""
    return None


@torch.no_grad()
def predict(params: NeuralODEParams, y0: torch.Tensor, ts: torch.Tensor,
            cfg: SolverConfig) -> torch.Tensor:
    """Deterministic prediction from y0 (N, D) over ts: (N, T, D)."""
    pred, _ = neural_ode_forward(params, y0, ts, cfg)
    return pred
