"""Plain reference of the vanilla GP-ODE (arXiv:2106.10905, sec. 3): one
q(x0) sample and one field draw per step, the whole trajectory solved from
one interval before the first observation with adaptive dopri5 (Hairer's
starting step), and the negative ELBO of the observations.

Parameter values come as a dict of tensors under the program's leaf names
(`gp.z`, `x0.mean`, `likelihood.raw_variance`, ...).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (Arith, Field, dopri5_solve, fill_tril,
                                        gaussian_logpdf, kl_to_standard,
                                        softplus)


def gp_leaves(values: dict) -> dict:
    return {"raw_lengthscales": values["gp.kernel.raw_lengthscales"],
            "raw_variance": values["gp.kernel.raw_variance"],
            "z": values["gp.z"], "u_mean": values["gp.u_mean"],
            "u_tril": values["gp.u_tril"]}


def train_loss(values: dict, noise: dict, inputs: dict, config: dict,
               ar: Arith, fault: str | None = None) -> torch.Tensor:
    """Negative ELBO of one step. `fault="half_batch"` scores half of the
    observation times."""
    sol = config["model_args"]
    ys, ts = inputs["ys"], [float(t) for t in inputs["ts"]]
    n, t, d = ys.shape
    m = values["gp.z"].shape[0]
    lx0 = fill_tril(values["x0.tril_packed"], d)
    x0 = ar.einsum("nij,nj->ni", lx0, noise["x0"]) + values["x0.mean"]
    field = Field(gp_leaves(values), noise, ar)
    shift = ts[1] - ts[0]
    grid = [0.0] + [tk + shift for tk in ts]
    xs, _ = dopri5_solve(field, x0, grid, sol["rtol"], sol["atol"],
                         sol["max_steps"], sol["first_step"])
    xs = torch.movedim(xs[1:], 0, 1)                               # (N, T, D)
    lp = gaussian_logpdf(ys, xs, softplus(values["likelihood.raw_variance"]))
    if fault == "half_batch":
        lp = lp[:, : t // 2]
    num_obs = ys.numel()
    x0_kl = kl_to_standard(values["x0.mean"], lx0) / num_obs
    u_kl = kl_to_standard(values["gp.u_mean"].T,
                          fill_tril(values["gp.u_tril"], m)) / num_obs
    return -(lp.mean() - x0_kl - u_kl)
