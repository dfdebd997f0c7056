"""Data-driven model initialization. Counterpart of `gpode_tpu/models/init.py`:

  * inducing locations at k-means cluster centers of the observed states,
    whitened inducing means from a kernel ridge regression onto empirical
    time-difference gradients;
  * the initial-state mean (of the shooting model's or the vanilla model's
    q(x0)) by integrating the freshly initialized ODE backward one
    observation interval from the first observation, averaged over
    posterior draws; the shooting-state means at the observed values;
  * observation-noise and kernel hyperparameter setters.

K-means runs on the host, under the JAX package's branch rule: the native
host library (`utils/native.py`) where it loads, scipy's `kmeans2` where it
does not; each consumes the `RandomState` as its JAX counterpart does. The
solves and the backward integration
run on the parameters' device. Random numbers are inputs: the backward
integration takes its draws' noise as a `gpode.PredictNoise`. The
initializers update the module in place and return it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.cluster.vq import kmeans2

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward_sampled
from gpode_tpu_torch.models.gpode import PredictNoise
from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.kernels import rbf_K
from gpode_tpu_torch.utils import native


def _safe_cholesky(mat: torch.Tensor, jitter: float, max_tries: int = 6):
    """Cholesky with escalating jitter: K(Z,Z) from k-means centers can be
    numerically indefinite in float32 at large M."""
    for _ in range(max_tries):
        chol = om.cholesky_jittered(mat, jitter)
        if bool(torch.all(torch.isfinite(chol))):
            return chol
        jitter *= 100.0
    raise FloatingPointError("Cholesky failed for inducing-init whitening "
                             f"even at jitter={jitter}")


@torch.no_grad()
def initialize_inducing(gp_params: gp.SVGPParams, data_ys: np.ndarray,
                        ts_max: float, data_noise: float = 1e-1,
                        rng: Optional[np.random.RandomState] = None,
                        max_obs: int = 1000) -> gp.SVGPParams:
    """Inducing locations at k-means centers; whitened inducing means from
    empirical gradients via kernel ridge regression.

    data_ys: (N, T, D) observed sequences starting at t=0; ts_max: last
    observation time.
    """
    rng = np.random.RandomState() if rng is None else rng
    n, t, d = data_ys.shape
    f_xt = (data_ys[:, 1:, :] - data_ys[:, :-1, :]).reshape(-1, d) * (t / ts_max)
    xs = data_ys[:, :-1, :].reshape(-1, d)

    m = gp_params.num_inducing
    if native.available():
        z_np = native.kmeans(xs, m, seed=int(rng.randint(2 ** 31)))
    else:
        z_np = kmeans2(xs, k=m, minit="points", seed=rng)[0].astype(np.float32)
    keep = rng.choice(xs.shape[0], min(max_obs, xs.shape[0]), replace=False)

    dev = gp_params.z.device
    xs_sub = torch.as_tensor(xs[keep], dtype=torch.float32, device=dev)
    f_sub = torch.as_tensor(f_xt[keep], dtype=torch.float32, device=dev)
    z = torch.as_tensor(z_np, device=dev)

    kern = gp_params.kernel
    kxx = rbf_K(kern, xs_sub)
    kxz = rbf_K(kern, xs_sub, z)
    lxx = om.cholesky_jittered(kxx, data_noise)
    lzz = _safe_cholesky(rbf_K(kern, z), 1e-6)

    if gp_params.dimwise:
        alpha = om.solve_lower(lxx, f_sub.T[:, :, None])            # (D,n,1)
        alpha = om.solve_upper_from_lower(lxx, alpha)[..., 0]       # (D,n)
        f_update = torch.einsum("dnm,dn->md", kxz, alpha)
        u_mean = om.solve_lower(lzz, f_update.T[:, :, None])[..., 0].T
    else:
        alpha = om.solve_upper_from_lower(lxx, om.solve_lower(lxx, f_sub))
        u_mean = om.solve_lower(lzz, torch.einsum("nm,nd->md", kxz, alpha))

    gp_params.z.copy_(z)
    gp_params.u_mean.copy_(u_mean)
    return gp_params


@torch.no_grad()
def initialize_kernel_parameters(gp_params: gp.SVGPParams,
                                 lengthscale_value: float = 1.25,
                                 variance_value: float = 0.5) -> gp.SVGPParams:
    """Set the kernel hyperparameters to constants."""
    gp_params.kernel.raw_lengthscales.fill_(float(om.invsoftplus(lengthscale_value)))
    gp_params.kernel.raw_variance.fill_(float(om.invsoftplus(variance_value)))
    return gp_params


@torch.no_grad()
def estimate_x0_backward(gp_params: gp.SVGPParams, noise: PredictNoise,
                         y_first: torch.Tensor, ts: torch.Tensor,
                         cfg: SolverConfig) -> torch.Tensor:
    """x0 estimate: integrate backward one interval from the first
    observation y_first (N, D) over [ts[1], ts[0]], averaged over the draws
    of `noise` (its leading axis; its x0 normals are not used). Under the
    `insert_zero_t0` convention x(0) evolves one interval into y(t_0).

    Each draw is its own solve, as under the JAX package's `vmap`: an
    adaptive solver then keeps one step controller per draw (the batched
    solve of `predict` shares one)."""
    ts_back = torch.stack([ts[1], ts[0]])
    chol = gp.precompute_chol(gp_params)
    ends = [flow_forward_sampled(gp_params, noise.rff_weights[i],
                                 noise.rff_freq[i], noise.rff_phase[i],
                                 noise.inducing[i], y_first, ts_back, cfg,
                                 chol)[0][:, -1]
            for i in range(noise.inducing.shape[0])]
    return torch.mean(torch.stack(ends), dim=0)


@torch.no_grad()
def initialize_latents_with_data(params, noise: PredictNoise,
                                 data_ys: np.ndarray, data_ts: np.ndarray,
                                 cfg: SolverConfig):
    """Vanilla init: the q(x0) mean of a `GPODEParams` by backward
    integration over the draws of `noise` (the JAX package takes 20).
    data_ys (N, T, D), data_ts (T,)."""
    dev = params.x0.mean.device
    ys = torch.as_tensor(np.asarray(data_ys, np.float32), device=dev)
    ts = torch.as_tensor(np.asarray(data_ts, np.float32), device=dev)
    params.x0.mean.copy_(estimate_x0_backward(params.gp, noise, ys[:, 0], ts,
                                              cfg))
    return params


@torch.no_grad()
def initialize_shooting_states_with_data(params, noise: PredictNoise,
                                         data_ys: np.ndarray,
                                         data_ts: np.ndarray,
                                         cfg: SolverConfig):
    """Shooting init: the x0 mean by backward integration over the draws of
    `noise` (the JAX package takes 50), the shooting-state means at the
    observed values y_0 .. y_{T-2}. data_ys (N, T, D), data_ts (T,)."""
    dev = params.states.mean.device
    ys = torch.as_tensor(np.asarray(data_ys, np.float32), device=dev)
    ts = torch.as_tensor(np.asarray(data_ts, np.float32), device=dev)
    params.states.x0.mean.copy_(
        estimate_x0_backward(params.gp, noise, ys[:, 0], ts, cfg))
    params.states.mean.copy_(ys[:, :-1])
    return params


@torch.no_grad()
def initialize_noisevar(likelihood, init_noisevar):
    """Set the observation-noise variance (a float or a per-dim array) of a
    Gaussian likelihood, or of the base of a projected one."""
    base = getattr(likelihood, "base", likelihood)
    raw = om.invsoftplus(torch.as_tensor(np.asarray(init_noisevar, np.float32)))
    base.raw_variance.copy_(raw.to(base.raw_variance.device).expand_as(
        base.raw_variance))
    return likelihood
