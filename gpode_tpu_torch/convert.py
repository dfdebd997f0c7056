"""Parameters to and from plain arrays keyed by dotted path.

The keys are the JAX package's `ShootingParams` leaf paths
(`gp.kernel.raw_lengthscales`, `states.x0.tril_packed`,
`likelihood.projector.components`, `constraint.raw_scale`, ...), which are
also the port's parameter names, so both packages can compute the same step
from the same weights. The port itself never sees JAX: callers flatten the
JAX pytree to this dict.
"""

from __future__ import annotations

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models import gp, shooting
from gpode_tpu_torch.models.constraints import (GaussianConstraint,
                                                LaplaceConstraint)
from gpode_tpu_torch.models.likelihoods import (GaussianLikelihood,
                                                ProjectedGaussianLikelihood,
                                                Projector)
from gpode_tpu_torch.models.states import (InitialStatePosterior,
                                           ShootingStatePosterior)
from gpode_tpu_torch.ops.kernels import RBFParams


def params_from_numpy(flat: dict[str, np.ndarray], args,
                      device=None) -> shooting.ShootingParams:
    """Build `ShootingParams` from {dotted path: array}; `args.constraint_type`
    picks the constraint family. `device` defaults to CUDA."""
    device = resolve_device(device)
    unused = set(flat)

    def t(name):
        if name not in flat:
            return None
        unused.discard(name)
        return torch.tensor(np.asarray(flat[name], dtype=np.float32),
                            device=device)

    gp_params = gp.SVGPParams(
        RBFParams(t("gp.kernel.raw_lengthscales"), t("gp.kernel.raw_variance")),
        t("gp.z"), t("gp.u_mean"), u_tril=t("gp.u_tril"),
        u_diag_raw=t("gp.u_diag_raw"))
    states = ShootingStatePosterior(
        InitialStatePosterior(t("states.x0.mean"), t("states.x0.tril_packed")),
        t("states.mean"), t("states.tril_packed"))
    if "likelihood.base.raw_variance" in flat:
        likelihood = ProjectedGaussianLikelihood(
            GaussianLikelihood(t("likelihood.base.raw_variance")),
            Projector(t("likelihood.projector.components"),
                      t("likelihood.projector.norm_mean"),
                      t("likelihood.projector.norm_std")))
    else:
        likelihood = GaussianLikelihood(t("likelihood.raw_variance"))
    kind = {"gauss": GaussianConstraint, "laplace": LaplaceConstraint}
    constraint = kind[args.constraint_type](t("constraint.raw_scale"))
    if unused:
        raise KeyError(f"arrays not used by ShootingParams: {sorted(unused)}")
    return shooting.ShootingParams(gp_params, states, likelihood, constraint)


def params_to_numpy(params: torch.nn.Module) -> dict[str, np.ndarray]:
    """{dotted path: float32 array} of every parameter."""
    return {name: p.detach().cpu().numpy()
            for name, p in params.named_parameters()}
