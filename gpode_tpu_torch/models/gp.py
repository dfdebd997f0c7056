"""Decoupled-sampling sparse variational GP (the ODE vector-field posterior).

Counterpart of `gpode_tpu/models/gp.py`: a posterior function draw is

    f(x) = f_prior(x) + K(x, Z) L^{-T} (v - L^{-1} f_prior(Z))

with f_prior a random-Fourier-feature prior sample, L = chol(K(Z,Z)) and v a
sample of the whitened inducing posterior q(v) = N(u_mean, S).

Random numbers are inputs: :func:`draw_posterior` takes the standard-normal
and uniform draws as tensors, so the training loop fills them from a
`torch.Generator` and the tests from the JAX package's own keys.

Several draws stack on a leading axis (what the JAX package gets from
`vmap`): with noise of shape (S, ...) :func:`draw_posterior` returns a
:class:`PosteriorDraw` whose leaves carry the draw axis, and
:func:`eval_draws` evaluates all S fields at once.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.cuda_kernels import (DRAW_SOLVES, draw_solve,
                                              draw_solve_refusal, fused_rhs,
                                              kernel_refusal, rbf_gram)
from gpode_tpu_torch.ops.kernels import (RBFParams, init_rbf, rbf_K, rbf_K_diag,
                                         rbf_sample_freq)
from gpode_tpu_torch.utils.profiling import span


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


def draw_solves_on_factor(chol, u_prior, v):
    """A draw's update coefficients on a given factor L of K(Z, Z),
    nu = L^{-T}(v - L^{-1} u_prior), by the library's two triangular solves:
    chol (D, M, M) for a dimwise GP (dim d's columns on factor d) or (M, M)
    shared; u_prior and v (..., M, D); returns nu (..., D, M)."""
    if chol.ndim == 3:
        a = om.solve_lower(chol, u_prior.mT[..., None])         # (..., D, M, 1)
        return om.solve_upper_from_lower(chol, v.mT[..., None] - a)[..., 0]
    a = om.solve_lower(chol, u_prior)
    return om.solve_upper_from_lower(chol, v - a).mT


def draw_solve_plain(kzz, u_prior, v, jitter=om.DEFAULT_JITTER):
    """`cuda_kernels.draw_solve` as the library chain, differentiated by
    autograd: `cholesky_jittered` of kzz (D, M, M) or (M, M), then
    :func:`draw_solves_on_factor`. The CPU path."""
    return draw_solves_on_factor(om.cholesky_jittered(kzz, jitter), u_prior, v)


def sample_inducing(params: SVGPParams, normals: torch.Tensor) -> torch.Tensor:
    """Reparameterized v ~ q(v) in whitened space from normals (..., M, D)."""
    if params.q_diag:
        zs = params.u_scale_diag() * normals
    else:
        zs = torch.einsum("dnm,...md->...nd", params.u_scale_tril(), normals)
    return zs + params.u_mean


# RFF scale: the canonical sqrt(2 var / S) (Rahimi & Recht 2007). The
# reference's sqrt(var / S) would give prior samples of variance var/2.
_RFF_SCALE_FACTOR = 2.0


def set_rff_reference_scale(enabled: bool):
    """True -> reproduce the reference's sqrt(var / S) RFF scaling (its prior
    samples carry variance var / 2); False (default) -> the canonical
    sqrt(2 var / S). Read at every call: nothing is cached."""
    global _RFF_SCALE_FACTOR
    _RFF_SCALE_FACTOR = 1.0 if enabled else 2.0


def rff_eval(params: SVGPParams, omega, phase, weights, x) -> torch.Tensor:
    """RFF prior sample at x: (..., N, Din) -> (..., N, D);
    phi(x) = cos(x omega + phase) * sqrt(2 var / S), f = phi @ weights.
    A leading draw axis of the draw's leaves and of x broadcasts."""
    var = params.kernel.variance
    scale = torch.sqrt(_RFF_SCALE_FACTOR * var / weights.shape[-2])
    if params.dimwise:
        xo = torch.einsum("...nd,...dfk->...nfk", x, omega)
        phi = torch.cos(xo + phase) * scale
        return torch.einsum("...nfk,...fk->...nk", phi, weights)
    phi = torch.cos(x @ omega + phase) * scale
    return phi @ weights


def draw_posterior(params: SVGPParams, weight_normals: torch.Tensor,
                   freq_normals: torch.Tensor, phase_uniforms: torch.Tensor,
                   inducing_normals: torch.Tensor,
                   chol_zz: Optional[torch.Tensor] = None,
                   kernels: Optional[bool] = None) -> PosteriorDraw:
    """Build posterior function draws from their noise:
    weight_normals (..., S, D), freq_normals (..., Din, S, D) [dimwise] or
    (..., Din, S), phase_uniforms in [0, 1) of shape (..., 1, S, D)
    [dimwise] or (..., 1, S), inducing_normals (..., M, D). A leading draw
    axis gives that many draws sharing one Cholesky of K(Z, Z). The draw is
    the span `gpode.draw`.

    Without `chol_zz` the draw factors K(Z, Z) itself: on a card, where
    :func:`draw_solve_on_device` says so (`kernels` the solver's kernel
    rule, `SolverConfig.kernels`: False keeps the library), the factor and
    both solves are the `draw_solve` kernels; else the library chain. A
    given `chol_zz` keeps the library's two solves on it. Each draw is
    counted in `cuda_kernels.DRAW_SOLVES`."""
    with span("gpode.draw"):
        weights = weight_normals
        omega = rbf_sample_freq(params.kernel, freq_normals)
        phase = 2.0 * math.pi * phase_uniforms
        v = sample_inducing(params, inducing_normals)           # (..., M, D)
        u_prior = rff_eval(params, omega, phase, weights,
                           params.z)                            # (..., M, D)
        if chol_zz is None:
            kzz = rbf_K(params.kernel, params.z)
            on_device = draw_solve_on_device(kzz, u_prior, kernels)
            DRAW_SOLVES["device" if on_device else "library"] += 1
            nu = (draw_solve if on_device else draw_solve_plain)(kzz, u_prior, v)
        else:
            DRAW_SOLVES["library"] += 1
            nu = draw_solves_on_factor(chol_zz, u_prior, v)
        return PosteriorDraw(omega=omega, phase=phase, weights=weights, nu=nu)


# Kernel dispatch seam: dimwise evaluations of at least this many rows take
# the fused CUDA rhs (`ops/cuda_kernels.fused_rhs`), smaller batches the
# plain tensor path — the JAX package's `_PALLAS_RHS_MIN_ROWS` rule.
_KERNEL_RHS_MIN_ROWS = 256

_logger = logging.getLogger(__name__)
_REFUSALS_LOGGED: set = set()


def kernel_rhs_active(params: SVGPParams, n_rows: int, num_features: int,
                      kernel: str = "fused_rhs") -> bool:
    """Would the solve take `kernel` ("fused_rhs", as `eval_draw` does, or
    the flow's "rk4_segment" / "dopri5_attempt") for `n_rows` rows of a draw
    with `num_features` features? A dimwise GP, at least 256 rows, and a
    shape that both directions of the kernel take
    (`ops/cuda_kernels.kernel_refusal`): decided from shapes alone, before
    any launch. A refusal (a width, thread or shared-memory limit of the
    kernel) is logged once per reason and sends the call to the plain path.
    """
    if not (params.dimwise and n_rows >= _KERNEL_RHS_MIN_ROWS):
        return False
    reason = kernel_refusal(kernel, n_rows, params.z.shape[1],
                            params.u_mean.shape[1], params.num_inducing,
                            num_features)
    if reason is None:
        return True
    if reason not in _REFUSALS_LOGGED:
        _REFUSALS_LOGGED.add(reason)
        _logger.warning("the %s kernels refuse this shape (%s): taking the "
                        "plain path", kernel, reason)
    return False


def draw_solve_on_device(kzz: torch.Tensor, u_prior: torch.Tensor,
                         kernels: Optional[bool] = None) -> bool:
    """Does a draw on its own factor of kzz = K(Z, Z), with prior values
    u_prior (..., M, D), take the `draw_solve` kernels? Under a kernel rule
    `kernels` other than False, a card's tensors in a dtype and shape both
    kernels take (`cuda_kernels.draw_solve_refusal`: float32, M <= 256, the
    R columns in shared memory): decided before any launch.
    A refusal is logged once per reason and sends the draw to the library's
    factorisation and solves."""
    if kernels is False or kzz.device.type != "cuda":
        return False
    reason = draw_solve_refusal(kzz, u_prior)
    if reason is None:
        return True
    if reason not in _REFUSALS_LOGGED:
        _REFUSALS_LOGGED.add(reason)
        _logger.warning("the draw_solve kernels refuse this draw (%s): taking "
                        "the library's factorisation and solves", reason)
    return False


class _KernelView(NamedTuple):
    lengthscales: torch.Tensor
    variance: torch.Tensor

    @property
    def dimwise(self) -> bool:
        return self.lengthscales.ndim == 2


class FieldView(NamedTuple):
    """What an evaluation of the field (`eval_draw` with an explicit
    `use_kernel`) reads of the GP: the kernel's constrained hyperparameters
    and Z, as plain tensors. The continuous adjoint evaluates the field on
    detached leaves through it."""

    kernel: _KernelView
    z: torch.Tensor

    @property
    def dimwise(self) -> bool:
        return self.kernel.dimwise


def field_view(raw_lengthscales: torch.Tensor, raw_variance: torch.Tensor,
               z: torch.Tensor) -> FieldView:
    """A :class:`FieldView` from the kernel's unconstrained leaves."""
    return FieldView(_KernelView(om.softplus(raw_lengthscales),
                                 om.softplus(raw_variance)), z)


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
        use_kernel = kernel_rhs_active(params, x.shape[0],
                                       draw.weights.shape[-2])
    if use_kernel and params.dimwise:
        return fused_rhs(x, params.z, params.kernel.lengthscales,
                         params.kernel.variance, draw.omega, draw.phase,
                         kernel_rff_weights(draw.weights), draw.nu)
    return _eval_plain(params, draw, x)


def _eval_plain(params: SVGPParams, draw: PosteriorDraw,
                x: torch.Tensor) -> torch.Tensor:
    """The rhs as tensor ops; a leading draw axis of `draw` and x (S, N, Din)
    evaluates every draw in the same few batched operations."""
    f_prior = rff_eval(params, draw.omega, draw.phase, draw.weights, x)
    kuf = rbf_K(params.kernel, params.z, x)      # (..., M, N) / (..., D, M, N)
    if params.dimwise:
        return f_prior + torch.einsum("...dm,...dmn->...nd", draw.nu, kuf)
    return f_prior + torch.einsum("...dm,...mn->...nd", draw.nu, kuf)


def eval_draws(params: SVGPParams, draws: PosteriorDraw, x: torch.Tensor,
               use_kernel: bool | None = None) -> torch.Tensor:
    """S sampled fields at once: draws with a leading axis S, x (S, N, Din)
    -> (S, N, D).

    The kernel gate is decided per draw's row count N, as under the JAX
    package's `vmap` (`use_kernel` overrides it). Below the gate all draws
    go through one batched plain evaluation; at or above it, through the
    fused kernel once per draw.
    """
    if use_kernel is None:
        use_kernel = kernel_rhs_active(params, x.shape[-2],
                                       draws.weights.shape[-2])
    if use_kernel and params.dimwise:
        return torch.stack([
            eval_draw(params, PosteriorDraw(*(leaf[i] for leaf in draws)),
                      x[i], True) for i in range(x.shape[0])])
    return _eval_plain(params, draws, x)


def _needs_grad(params: SVGPParams, x: torch.Tensor) -> bool:
    """Would autograd record K(Z, x)? (grad mode on and x, Z or a kernel
    hyperparameter requires grad)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, params.z, params.kernel.raw_lengthscales,
                                  params.kernel.raw_variance))


def cross_gram(params: SVGPParams, x: torch.Tensor) -> torch.Tensor:
    """K(Z, x): (M, N) or dimwise (D, M, N).

    Dispatch rule: a dimwise GP whose Gram needs no gradient (grad mode off,
    or neither x, Z nor a kernel hyperparameter requires grad) takes the
    forward-only `rbf_gram` kernel, transposed to (D, M, N); every other
    case takes `rbf_K`, which autograd can differentiate. A shape the kernel
    refuses raises before any launch; nothing catches a failed launch."""
    if params.dimwise and not _needs_grad(params, x):
        return rbf_gram(x, params.z, params.kernel.lengthscales,
                        params.kernel.variance).mT
    return rbf_K(params.kernel, params.z, x)


def conditional(params: SVGPParams, x: torch.Tensor, *, full_cov: bool = False,
                jitter: float = om.DEFAULT_JITTER):
    """Exact conditional q(f(x)) = N(mean, var) of the vector field at x
    (N, Din): (mean (N, D), var (N, D)), or with `full_cov`
    (mean, var (D, N, N)).

    K(Z, x) comes from :func:`cross_gram`: the `rbf_gram` kernel when the GP
    is dimwise and no input needs a gradient, else `rbf_K`. In `q_diag` mode
    S = diag(s^2), so the conditional moments match the decoupled-sampling
    moments (the reference builds the rank-1 s s^T there)."""
    chol_zz = precompute_chol(params, jitter)               # (M,M) / (D,M,M)
    a = om.solve_lower(chol_zz, cross_gram(params, x))

    m = params.num_inducing
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    if params.q_diag:
        sk = torch.diag_embed(torch.square(params.u_scale_diag().T)) - eye
    else:
        us = params.u_scale_tril()                          # (D, M, M)
        sk = torch.einsum("dmk,dek->dme", us, us) - eye
    a_d = (a if params.dimwise else a[None]).expand(sk.shape[0], -1, -1)
    b = torch.einsum("dme,den->dmn", sk, a_d)               # (D, M, N)

    if full_cov:
        kff = rbf_K(params.kernel, x)
        var = (kff if params.dimwise else kff[None]) + torch.einsum(
            "dme,dmn->den", a_d, b)                         # (D, N, N)
    else:
        kff = rbf_K_diag(params.kernel, x)                  # (D, N) / (N,)
        var = ((kff if params.dimwise else kff[None])
               + torch.sum(a_d * b, dim=1)).T               # (N, D)

    if params.dimwise:
        mean = torch.einsum("dmn,md->nd", a, params.u_mean)
    else:
        mean = torch.einsum("mn,md->nd", a, params.u_mean)
    return mean, var


def kl(params: SVGPParams) -> torch.Tensor:
    """KL( q(v) || N(0, I) ) of the whitened inducing posterior."""
    if params.q_diag:
        return om.kl_whitened_gaussian_diag(params.u_mean.T,
                                            params.u_scale_diag().T)
    return om.kl_whitened_gaussian(params.u_mean.T, params.u_scale_tril())
