"""Variational state posteriors: initial state q(x0) and shooting states.

Counterpart of `gpode_tpu/models/states.py`. Sampling takes its
standard-normal draws as tensors (random numbers are inputs).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gpode_tpu_torch.ops import math as om

# Initial scale of state Cholesky factors.
INITIAL_STATE_SCALE = 1e-1


class InitialStatePosterior(nn.Module):
    """q(x0) = N(mean, L L^T) per sequence: mean (N, D), tril_packed
    (N, D(D+1)/2)."""

    def __init__(self, mean, tril_packed):
        super().__init__()
        self.mean = nn.Parameter(mean)
        self.tril_packed = nn.Parameter(tril_packed)

    @property
    def dim_d(self) -> int:
        return self.mean.shape[-1]

    def tril(self) -> torch.Tensor:
        return om.fill_tril(self.tril_packed, self.dim_d)


class ShootingStatePosterior(nn.Module):
    """Factorized q over the T-1 shooting states plus embedded q(x0):
    mean (N, T-1, D), tril_packed (N, T-1, D(D+1)/2)."""

    def __init__(self, x0: InitialStatePosterior, mean, tril_packed):
        super().__init__()
        self.x0 = x0
        self.mean = nn.Parameter(mean)
        self.tril_packed = nn.Parameter(tril_packed)

    @property
    def dim_d(self) -> int:
        return self.mean.shape[-1]

    def tril(self) -> torch.Tensor:
        return om.fill_tril(self.tril_packed, self.dim_d)


def _eye_packed(dim_d, device):
    return om.pack_tril(INITIAL_STATE_SCALE * torch.eye(dim_d, device=device))


def init_initial_state(generator: torch.Generator, dim_n: int, dim_d: int,
                       device=None) -> InitialStatePosterior:
    mean = 1e-2 * torch.randn(dim_n, dim_d, generator=generator).to(device)
    tril = _eye_packed(dim_d, device).expand(dim_n, -1).clone()
    return InitialStatePosterior(mean, tril)


def init_shooting_states(generator: torch.Generator, dim_n: int, dim_t: int,
                         dim_d: int, device=None) -> ShootingStatePosterior:
    """dim_t = T - 1 shooting states per sequence."""
    x0 = init_initial_state(generator, dim_n, dim_d, device)
    mean = 1e-1 * torch.randn(dim_n, dim_t, dim_d, generator=generator).to(device)
    tril = _eye_packed(dim_d, device).expand(dim_n, dim_t, -1).clone()
    return ShootingStatePosterior(x0, mean, tril)


def sample_initial_state(p: InitialStatePosterior,
                         normals: torch.Tensor) -> torch.Tensor:
    """Reparameterized x0 samples (S, N, D) from normals (S, N, D)."""
    return torch.einsum("nij,snj->sni", p.tril(), normals) + p.mean[None]


def initial_state_kl(p: InitialStatePosterior) -> torch.Tensor:
    """KL( q(x0) || N(0, I) ) summed over sequences."""
    return om.kl_whitened_gaussian(p.mean, p.tril())


def sample_shooting_states(p: ShootingStatePosterior, x0_normals: torch.Tensor,
                           state_normals: torch.Tensor) -> torch.Tensor:
    """Samples of [x0, s_1, ..., s_{T-1}]: (S, N, T, D), from x0_normals
    (S, N, D) and state_normals (S, N, T-1, D)."""
    zs = torch.einsum("ntij,sntj->snti", p.tril(), state_normals)
    states = zs + p.mean[None]
    x0 = sample_initial_state(p.x0, x0_normals)[:, :, None, :]
    return torch.cat([x0, states], dim=2)


def _jittered_chol_from_scale(tril: torch.Tensor, jitter: float) -> torch.Tensor:
    """chol(L L^T + jitter I), batched."""
    return om.cholesky_jittered(torch.matmul(tril, tril.mT), jitter)


def shooting_entropy(p: ShootingStatePosterior,
                     jitter: float = om.DEFAULT_JITTER) -> torch.Tensor:
    """Entropy of the factorized shooting posterior: (N, T-1)."""
    d = p.dim_d
    logdet = om.tri_logdet_from_chol(_jittered_chol_from_scale(p.tril(), jitter))
    return 0.5 * (d * (1.0 + math.log(2.0 * math.pi)) + logdet)
