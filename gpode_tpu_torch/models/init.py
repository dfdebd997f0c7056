"""Data-driven model initialization. Counterpart of the kernel and inducing
initializers of `gpode_tpu/models/init.py`.

K-means runs on the host (scipy); the ridge regression and whitening solves
run on the parameters' device. Both functions update the module in place and
return it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.cluster.vq import kmeans2

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.kernels import rbf_K


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
