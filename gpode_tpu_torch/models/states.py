"""Variational state posteriors: initial state q(x0) and shooting states.

Counterpart of `gpode_tpu/models/states.py`. Sampling takes its
standard-normal draws as tensors (random numbers are inputs).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.cuda_kernels import STATE_ENTROPIES, state_entropy

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


def sample_initial_state(p: InitialStatePosterior, normals: torch.Tensor,
                         seqs: slice = slice(None)) -> torch.Tensor:
    """Reparameterized x0 samples (S, N, D) from normals (S, N, D), for
    the sequences `seqs` (all by default; N is then the block's length)."""
    return (torch.einsum("nij,snj->sni", p.tril()[seqs], normals)
            + p.mean[seqs][None])


def initial_state_kl(p: InitialStatePosterior) -> torch.Tensor:
    """KL( q(x0) || N(0, I) ) summed over sequences."""
    return om.kl_whitened_gaussian(p.mean, p.tril())


def initial_state_log_prob(p: InitialStatePosterior, x: torch.Tensor,
                           jitter: float = om.DEFAULT_JITTER) -> torch.Tensor:
    """log q(x0 = x) with the jittered covariance L L^T + jitter I;
    x (..., N, D) -> (..., N)."""
    return _mvn_log_prob(x, p.mean, p.tril(), jitter)


def sample_shooting_states(p: ShootingStatePosterior, x0_normals: torch.Tensor,
                           state_normals: torch.Tensor,
                           seqs: slice = slice(None)) -> torch.Tensor:
    """Samples of [x0, s_1, ..., s_{T-1}]: (S, N, T, D), from x0_normals
    (S, N, D) and state_normals (S, N, T-1, D). `seqs` samples only a block
    of the sequences (a rank's block over `dp`; the normals are then that
    block's, N its length)."""
    zs = torch.einsum("ntij,sntj->snti", p.tril()[seqs], state_normals)
    states = zs + p.mean[seqs][None]
    x0 = sample_initial_state(p.x0, x0_normals, seqs)[:, :, None, :]
    return torch.cat([x0, states], dim=2)


def _jittered_chol_from_scale(tril: torch.Tensor, jitter: float) -> torch.Tensor:
    """chol(L L^T + jitter I), batched. State dims are tiny (D <= 8 for
    every dataset), so the factorization takes the unrolled algorithm
    (`ops/math.cholesky_jittered_auto`), as in the JAX package."""
    return om.cholesky_jittered_auto(torch.matmul(tril, tril.mT), jitter)


def _mvn_log_prob(x, mean, tril, jitter):
    d = mean.shape[-1]
    chol = _jittered_chol_from_scale(tril, jitter)
    alpha = om.solve_lower(chol, (x - mean)[..., None])[..., 0]
    maha = torch.sum(torch.square(alpha), dim=-1)
    logdet = om.tri_logdet_from_chol(chol)
    return -0.5 * (d * math.log(2.0 * math.pi) + logdet + maha)


def state_entropy_on_device(tril_packed: torch.Tensor, dim_d: int,
                            kernels: Optional[bool] = None) -> bool:
    """Do the entropies of the packed scales tril_packed take the
    `state_entropy` kernels? Under a kernel rule `kernels` other than False
    (`SolverConfig.kernels`), float32 on a card at D <= SMALL_CHOL_MAX_DIM;
    else the unrolled chain (the CPU, float64, wider states, False)."""
    return (kernels is not False and tril_packed.device.type == "cuda"
            and tril_packed.dtype == torch.float32
            and dim_d <= om.SMALL_CHOL_MAX_DIM)


def shooting_entropy(p: ShootingStatePosterior,
                     jitter: float = om.DEFAULT_JITTER,
                     kernels: Optional[bool] = None) -> torch.Tensor:
    """Entropy of the factorized shooting posterior: (N, T-1). On a card
    where :func:`state_entropy_on_device` says so (`kernels` the solver's
    kernel rule), the `state_entropy` kernels; else the unrolled chain.
    Each call is counted in `cuda_kernels.STATE_ENTROPIES`."""
    d = p.dim_d
    if state_entropy_on_device(p.tril_packed, d, kernels):
        STATE_ENTROPIES["state_device"] += 1
        return state_entropy(p.tril_packed, d, jitter)
    STATE_ENTROPIES["state_unrolled"] += 1
    logdet = om.tri_logdet_from_chol(_jittered_chol_from_scale(p.tril(), jitter))
    return 0.5 * (d * (1.0 + math.log(2.0 * math.pi)) + logdet)


def shooting_log_prob(p: ShootingStatePosterior, x: torch.Tensor,
                      jitter: float = om.DEFAULT_JITTER) -> torch.Tensor:
    """log q(s = x) for x (..., N, T-1, D) -> (..., N, T-1)."""
    return _mvn_log_prob(x, p.mean, p.tril(), jitter)
