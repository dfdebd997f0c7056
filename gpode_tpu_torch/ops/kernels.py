"""RBF (squared-exponential) kernel. Counterpart of `gpode_tpu/ops/kernels.py`.

Shapes follow the reference convention:
  non-dimwise: lengthscales (Din,), variance (1,), K -> (N, M)
  dimwise:     lengthscales (D, Din), variance (D,), K -> (D, N, M)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gpode_tpu_torch.ops.math import invsoftplus, softplus


class RBFParams(nn.Module):
    """Unconstrained RBF kernel parameters (`raw_lengthscales`,
    `raw_variance`); `dimwise` is inferred from the lengthscale rank."""

    def __init__(self, raw_lengthscales: torch.Tensor, raw_variance: torch.Tensor):
        super().__init__()
        self.raw_lengthscales = nn.Parameter(raw_lengthscales)
        self.raw_variance = nn.Parameter(raw_variance)

    @property
    def dimwise(self) -> bool:
        return self.raw_lengthscales.ndim == 2

    @property
    def lengthscales(self) -> torch.Tensor:
        return softplus(self.raw_lengthscales)

    @property
    def variance(self) -> torch.Tensor:
        return softplus(self.raw_variance)


def init_rbf(d_in: int, d_out: Optional[int] = None, *, dimwise: bool = False,
             lengthscale: float = 1.3, variance: float = 0.5,
             device=None) -> RBFParams:
    """Constant initialization."""
    d_out = d_in if d_out is None else d_out
    ls_shape = (d_out, d_in) if dimwise else (d_in,)
    var_shape = (d_out,) if dimwise else (1,)
    raw_ls = torch.full(ls_shape, float(invsoftplus(lengthscale)), device=device)
    raw_var = torch.full(var_shape, float(invsoftplus(variance)), device=device)
    return RBFParams(raw_ls, raw_var)


def _sqdist(x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """||x_n - x2_m||^2 for pre-scaled inputs: (..., N, Din), (..., M, Din)
    -> (..., N, M), as one matmul plus rank-1 norm terms."""
    xs = torch.sum(torch.square(x), dim=-1)
    x2s = torch.sum(torch.square(x2), dim=-1)
    cross = torch.matmul(x, x2.transpose(-1, -2))
    return xs[..., :, None] - 2.0 * cross + x2s[..., None, :]


def rbf_K(params: RBFParams, x: torch.Tensor,
          x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram matrix K(x, x2): (N, M) non-dimwise or (D, N, M) dimwise.
    Leading batch dims of x and x2 broadcast in front: (..., N, M) or
    (..., D, N, M)."""
    if x2 is None:
        x2 = x
    ls = params.lengthscales
    var = params.variance
    if params.dimwise:
        sq = _sqdist(x[..., None, :, :] / ls[:, None, :],
                     x2[..., None, :, :] / ls[:, None, :])
        return var[:, None, None] * torch.exp(-0.5 * sq)
    return var * torch.exp(-0.5 * _sqdist(x / ls, x2 / ls))


def rbf_K_diag(params: RBFParams, x: torch.Tensor) -> torch.Tensor:
    """diag K(x, x): (N,) non-dimwise or (D, N) dimwise."""
    n = x.shape[0]
    var = params.variance
    if params.dimwise:
        return var[:, None].expand(var.shape[0], n)
    return var.expand(n)


def rbf_sample_freq(params: RBFParams, normals: torch.Tensor) -> torch.Tensor:
    """Spectral frequencies for random Fourier features from standard-normal
    draws: normals (Din, S, D) dimwise -> (Din, S, D); (Din, S) -> (Din, S)."""
    ls = params.lengthscales
    if params.dimwise:
        return normals / ls.T[:, None, :]
    return normals / ls[:, None]
