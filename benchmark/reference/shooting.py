"""Plain reference of the multiple-shooting GP-ODE (arXiv:2106.10905, sec.
4): its negative ELBO, and the posterior-predictive scores of a validation
request (whole trajectories from observed start states, scored as a
Gaussian mixture in the data space).

Parameter values come as a dict of tensors under the program's leaf names
(`gp.z`, `states.mean`, `likelihood.projector.components`, ...); the
benchmark made them, and the data, and hands the same to the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.common import (STATE_JITTER, Arith, Field,
                                        dopri5_solve, fill_tril,
                                        gaussian_logpdf, kl_to_standard,
                                        max_rms_over_draws, softplus,
                                        whole_span_segments)


def gp_leaves(values: dict) -> dict:
    return {"raw_lengthscales": values["gp.kernel.raw_lengthscales"],
            "raw_variance": values["gp.kernel.raw_variance"],
            "z": values["gp.z"], "u_mean": values["gp.u_mean"],
            "u_tril": values["gp.u_tril"]}


def project(values: dict, x: torch.Tensor, ar: Arith,
            prefix: str = "likelihood.projector.") -> torch.Tensor:
    """Latents (..., L) -> data space (..., D_full): x * std + mean, then
    the PCA components (the data mean is not added back)."""
    x = (x * values[prefix + "norm_std"].reshape(-1)
         + values[prefix + "norm_mean"].reshape(-1))
    return ar.einsum("...l,lk->...k", x, values[prefix + "components"])


def train_loss(values: dict, noise: dict, inputs: dict, config: dict,
               ar: Arith, fault: str | None = None) -> torch.Tensor:
    """Negative shooting ELBO of one step: every state sample advanced one
    interval by one dopri5 attempt (whole span) over all segment rows, the
    likelihood of the projected endpoints, the Gaussian continuity term,
    the states' entropy and the two KLs, each over the observation count.
    `fault="half_batch"` scores the observations of half the sequences."""
    sol = config["model_args"]
    ys, ts = inputs["ys"], inputs["ts"]
    n, t1, d = values["states.mean"].shape
    m = values["gp.z"].shape[0]
    lx0 = fill_tril(values["states.x0.tril_packed"], d)            # (N, D, D)
    x0 = (ar.einsum("nij,snj->sni", lx0, noise["x0"])
          + values["states.x0.mean"])
    lst = fill_tril(values["states.tril_packed"], d)               # (N, T-1, D, D)
    st = ar.einsum("ntij,sntj->snti", lst, noise["states"]) + values["states.mean"]
    ss = torch.cat([x0[:, :, None], st], dim=2)                    # (S, N, T, D)

    field = Field(gp_leaves(values), noise, ar)
    dt = float(ts[1] - ts[0])
    x1, _ = whole_span_segments(field, ss.reshape(-1, d), dt, sol["rtol"],
                                sol["atol"], sol["max_steps"])
    pred = x1.reshape(ss.shape)

    var = softplus(values["likelihood.base.raw_variance"])
    lp = gaussian_logpdf(ys[None], project(values, pred, ar), var)
    if fault == "half_batch":
        lp = lp[:, : n // 2]
    num_obs = ys.numel()
    observ = lp.mean()
    scale = softplus(values["constraint.raw_scale"])
    constr = gaussian_logpdf(pred[:, :, :-1], ss[:, :, 1:], scale ** 2).sum(3)
    constr = constr.mean(0).sum() / num_obs
    cov = (ar.einsum("ntij,ntkj->ntik", lst, lst)
           + STATE_JITTER * torch.eye(d, dtype=lst.dtype, device=lst.device))
    chol = torch.linalg.cholesky(cov)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    entropy = (0.5 * (d * (1.0 + math.log(2.0 * math.pi)) + logdet)).sum() / num_obs
    x0_kl = kl_to_standard(values["states.x0.mean"], lx0) / num_obs
    u_kl = kl_to_standard(values["gp.u_mean"].T,
                          fill_tril(values["gp.u_tril"], m)) / num_obs
    return -(observ + constr + entropy - x0_kl - u_kl)


def predict_scores(values: dict, noise: dict, inputs: dict, config: dict,
                   ar: Arith, fault: str | None = None):
    """One validation request: S draws (the noise's leading axis), each
    solved from the observed start states over the split's grid as ONE
    batched adaptive solve (Hairer's starting step; the step controlled by
    the largest per-draw error RMS), projected to the data space and scored
    as the S-component mixture: (mean log-likelihood, MSE of the mean).
    `fault`: "half_batch" scores half the draws; "answer" shifts one draw's
    trajectory a step late."""
    sol = dict(config["model_args"], **config["eval"])
    x0, ts, ys = inputs["x0"], inputs["ts"], inputs["ys"]
    s = noise["inducing"].shape[0]
    field = Field(gp_leaves(values), noise, ar)
    starts = x0.expand(s, *x0.shape)
    xs, _ = dopri5_solve(field, starts, [float(t) for t in ts], sol["rtol"],
                         sol["atol"], sol["max_steps"], sol["first_step"],
                         norm=max_rms_over_draws)
    zs = torch.movedim(xs, 0, 2)                                   # (S, N, T, D)
    if fault == "half_batch":
        zs = zs[: s // 2]
    elif fault == "answer":
        zs = torch.cat([torch.cat([zs[:1, :, :1], zs[:1, :, :-1]], 2), zs[1:]])
    pred = project(inputs["projector"], zs, ar, prefix="")
    nv = softplus(values["likelihood.base.raw_variance"]) + 1e-8
    lik = -0.5 * torch.log(2.0 * math.pi * nv) - 0.5 * (ys[None] - pred) ** 2 / nv
    mll = torch.mean(torch.logsumexp(lik, 0) - math.log(pred.shape[0]))
    mse = torch.mean((ys - pred.mean(0)) ** 2)
    return float(mll), float(mse)
