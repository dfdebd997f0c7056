"""Decoupled-sampling sparse variational GP (the ODE vector-field posterior).

Counterpart of `gpode_tpu/models/gp.py`: a posterior function draw is

    f(x) = f_prior(x) + K(x, Z) L^{-T} (v - L^{-1} f_prior(Z))

with f_prior a random-Fourier-feature prior sample, L = chol(K(Z,Z)) and v a
sample of the whitened inducing posterior q(v) = N(u_mean, S).

Random numbers are inputs: :func:`draw_posterior` takes the standard-normal
and uniform draws as tensors, so the training loop fills them from a
`torch.Generator` and the tests from the JAX package's own keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.cuda_kernels import fused_rhs
from gpode_tpu_torch.ops.kernels import RBFParams, init_rbf, rbf_K, rbf_sample_freq


class SVGPParams(nn.Module):
    """Trainable SVGP state.

    kernel:     RBF hyperparameters (dimwise inferred from shapes).
    z:          (M, Din) inducing locations.
    u_mean:     (M, D) whitened inducing posterior mean.
    u_tril:     (D, M(M+1)/2) packed Cholesky of the whitened posterior scale
                (full-rank mode), or
    u_diag_raw: (M, D) unconstrained diagonal scales (q_diag mode).
    """

    def __init__(self, kernel: RBFParams, z, u_mean, u_tril=None,
                 u_diag_raw=None):
        super().__init__()
        if (u_tril is None) == (u_diag_raw is None):
            raise ValueError("exactly one of u_tril / u_diag_raw is required")
        self.kernel = kernel
        self.z = nn.Parameter(z)
        self.u_mean = nn.Parameter(u_mean)
        if u_tril is not None:
            self.u_tril = nn.Parameter(u_tril)
        else:
            self.u_diag_raw = nn.Parameter(u_diag_raw)

    @property
    def q_diag(self) -> bool:
        return "u_diag_raw" in self._parameters

    @property
    def dimwise(self) -> bool:
        return self.kernel.dimwise

    @property
    def num_inducing(self) -> int:
        return self.z.shape[0]

    def u_scale_tril(self) -> torch.Tensor:
        """Dense (D, M, M) lower-triangular scale of q(v)."""
        return om.fill_tril(self.u_tril, self.num_inducing)

    def u_scale_diag(self) -> torch.Tensor:
        """(M, D) positive diagonal scales (q_diag mode)."""
        return om.softplus(self.u_diag_raw)


class PosteriorDraw(NamedTuple):
    """One pathwise sample of the posterior vector field.

    omega: RFF frequencies, (Din, S) or dimwise (Din, S, D).
    phase: RFF phases, (1, S) or dimwise (1, S, D).
    weights: RFF weights, (S, D).
    nu: pathwise-update coefficients L^{-T}(v - L^{-1} f_prior(Z)), (D, M).
    """

    omega: torch.Tensor
    phase: torch.Tensor
    weights: torch.Tensor
    nu: torch.Tensor


def init_svgp(generator: torch.Generator, d_in: int, d_out: int,
              num_inducing: int, *, dimwise: bool = True, q_diag: bool = False,
              device=None) -> SVGPParams:
    """z ~ N(0,1), u_mean ~ 0.1 N(0,1), scale = 1e-3 (identity Cholesky or
    diagonal). Draws come from `generator` (on the host) and are moved."""
    kernel = init_rbf(d_in, d_out, dimwise=dimwise, device=device)
    z = torch.randn(num_inducing, d_in, generator=generator).to(device)
    u_mean = 0.1 * torch.randn(num_inducing, d_out, generator=generator).to(device)
    if q_diag:
        raw = float(om.invsoftplus(1e-3))
        return SVGPParams(kernel, z, u_mean,
                          u_diag_raw=torch.full((num_inducing, d_out), raw,
                                                device=device))
    eye_packed = om.pack_tril(1e-3 * torch.eye(num_inducing, device=device))
    u_tril = eye_packed.expand(d_out, -1).clone()
    return SVGPParams(kernel, z, u_mean, u_tril=u_tril)


def precompute_chol(params: SVGPParams,
                    jitter: float = om.DEFAULT_JITTER) -> torch.Tensor:
    """Cholesky of K(Z,Z) + jitter I: (M, M) or dimwise (D, M, M)."""
    return om.cholesky_jittered(rbf_K(params.kernel, params.z), jitter)


def sample_inducing(params: SVGPParams, normals: torch.Tensor) -> torch.Tensor:
    """Reparameterized v ~ q(v) in whitened space from normals (M, D)."""
    if params.q_diag:
        zs = params.u_scale_diag() * normals
    else:
        zs = torch.einsum("dnm,md->nd", params.u_scale_tril(), normals)
    return zs + params.u_mean


# RFF scale: the canonical sqrt(2 var / S) (Rahimi & Recht 2007). The
# reference's sqrt(var / S) would give prior samples of variance var/2.
_RFF_SCALE_FACTOR = 2.0


def rff_eval(params: SVGPParams, omega, phase, weights, x) -> torch.Tensor:
    """RFF prior sample at x: (N, Din) -> (N, D);
    phi(x) = cos(x omega + phase) * sqrt(2 var / S), f = phi @ weights."""
    var = params.kernel.variance
    scale = torch.sqrt(_RFF_SCALE_FACTOR * var / weights.shape[0])
    if params.dimwise:
        xo = torch.einsum("nd,dfk->nfk", x, omega)
        phi = torch.cos(xo + phase) * scale
        return torch.einsum("nfk,fk->nk", phi, weights)
    phi = torch.cos(x @ omega + phase) * scale
    return phi @ weights


def draw_posterior(params: SVGPParams, weight_normals: torch.Tensor,
                   freq_normals: torch.Tensor, phase_uniforms: torch.Tensor,
                   inducing_normals: torch.Tensor,
                   chol_zz: Optional[torch.Tensor] = None) -> PosteriorDraw:
    """Build one posterior function draw from its noise:
    weight_normals (S, D), freq_normals (Din, S, D) [dimwise] or (Din, S),
    phase_uniforms in [0, 1) of shape (1, S, D) [dimwise] or (1, S),
    inducing_normals (M, D)."""
    weights = weight_normals
    omega = rbf_sample_freq(params.kernel, freq_normals)
    phase = 2.0 * math.pi * phase_uniforms
    v = sample_inducing(params, inducing_normals)             # (M, D)
    if chol_zz is None:
        chol_zz = precompute_chol(params)
    u_prior = rff_eval(params, omega, phase, weights, params.z)  # (M, D)
    if params.dimwise:
        a = om.solve_lower(chol_zz, u_prior.T[:, :, None])      # (D, M, 1)
        nu = om.solve_upper_from_lower(chol_zz, v.T[:, :, None] - a)[..., 0]
    else:
        a = om.solve_lower(chol_zz, u_prior)
        nu = om.solve_upper_from_lower(chol_zz, v - a).T
    return PosteriorDraw(omega=omega, phase=phase, weights=weights, nu=nu)


# Kernel dispatch seam: dimwise evaluations of at least this many rows take
# the fused CUDA rhs (`ops/cuda_kernels.fused_rhs`), smaller batches the
# plain tensor path — the JAX package's `_PALLAS_RHS_MIN_ROWS` rule.
_KERNEL_RHS_MIN_ROWS = 256


def kernel_rhs_active(params: SVGPParams, n_rows: int) -> bool:
    """Would `eval_draw` take the fused kernel at this batch size?"""
    return params.dimwise and n_rows >= _KERNEL_RHS_MIN_ROWS


def kernel_rff_weights(weights: torch.Tensor) -> torch.Tensor:
    """RFF weights for the kernels, which hardcode the canonical
    sqrt(2 var / S) feature scale; any other scale folds into the weights."""
    if _RFF_SCALE_FACTOR == 2.0:
        return weights
    return weights * math.sqrt(_RFF_SCALE_FACTOR / 2.0)


def eval_draw(params: SVGPParams, draw: PosteriorDraw, x: torch.Tensor,
              use_kernel: bool | None = None) -> torch.Tensor:
    """The sampled vector field f(x): (N, Din) -> (N, D).

    `use_kernel` overrides the auto rule (:func:`kernel_rhs_active`); the
    kernel is dimwise-only.
    """
    if use_kernel is None:
        use_kernel = kernel_rhs_active(params, x.shape[0])
    if use_kernel and params.dimwise:
        return fused_rhs(x, params.z, params.kernel.lengthscales,
                         params.kernel.variance, draw.omega, draw.phase,
                         kernel_rff_weights(draw.weights), draw.nu)
    f_prior = rff_eval(params, draw.omega, draw.phase, draw.weights, x)
    kuf = rbf_K(params.kernel, params.z, x)                  # (M,N) / (D,M,N)
    if params.dimwise:
        return f_prior + torch.einsum("dm,dmn->nd", draw.nu, kuf)
    return f_prior + torch.einsum("dm,mn->nd", draw.nu, kuf)


def kl(params: SVGPParams) -> torch.Tensor:
    """KL( q(v) || N(0, I) ) of the whitened inducing posterior."""
    if params.q_diag:
        return om.kl_whitened_gaussian_diag(params.u_mean.T,
                                            params.u_scale_diag().T)
    return om.kl_whitened_gaussian(params.u_mean.T, params.u_scale_tril())
