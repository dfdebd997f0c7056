"""Observation likelihoods: diagonal Gaussian and PCA-projected Gaussian.

Counterpart of `gpode_tpu/models/likelihoods.py`. The projector's arrays are
parameters, as they are leaves of the JAX package's parameter pytree: a train
step without a frozen mask updates them too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gpode_tpu_torch.ops import math as om


class GaussianLikelihood(nn.Module):
    """Diagonal Gaussian with softplus-constrained per-dim variance."""

    def __init__(self, raw_variance):
        super().__init__()
        self.raw_variance = nn.Parameter(raw_variance)

    @property
    def variance(self) -> torch.Tensor:
        return om.softplus(self.raw_variance)


def init_gaussian_likelihood(ndim: int, init_val: float = 0.25,
                             device=None) -> GaussianLikelihood:
    return GaussianLikelihood(torch.full((ndim,), float(om.invsoftplus(init_val)),
                                         device=device))


def gaussian_log_prob(p: GaussianLikelihood, f, y) -> torch.Tensor:
    return om.gaussian_logpdf(y, f, p.variance)


class Projector(nn.Module):
    """Latent/PCA space -> observation space linear map: optional inverse
    PCA-normalization (x * std + mean), then the PCA components. Faithful to
    the reference, the PCA data mean is not added back.

    components: (L, D_full); norm_mean / norm_std: (1, 1, L) or None.
    """

    def __init__(self, components, norm_mean: Optional[torch.Tensor] = None,
                 norm_std: Optional[torch.Tensor] = None):
        super().__init__()
        self.components = nn.Parameter(components)
        if norm_mean is not None:
            self.norm_mean = nn.Parameter(norm_mean)
            self.norm_std = nn.Parameter(norm_std)

    @property
    def normalized(self) -> bool:
        return "norm_mean" in self._parameters


def project(p: Projector, x: torch.Tensor) -> torch.Tensor:
    """(..., L) latents -> (..., D_full) observations."""
    if p.normalized:
        x = x * p.norm_std.reshape(-1) + p.norm_mean.reshape(-1)
    return torch.einsum("...l,ld->...d", x, p.components)


class ProjectedGaussianLikelihood(nn.Module):
    """Gaussian likelihood scored after a latent->data projection."""

    def __init__(self, base: GaussianLikelihood, projector: Projector):
        super().__init__()
        self.base = base
        self.projector = projector

    @property
    def variance(self) -> torch.Tensor:
        return self.base.variance


def likelihood_log_prob(p, f, y) -> torch.Tensor:
    """Elementwise log-likelihood; f in latent space for the projected one."""
    if isinstance(p, ProjectedGaussianLikelihood):
        return gaussian_log_prob(p.base, project(p.projector, f), y)
    return gaussian_log_prob(p, f, y)
