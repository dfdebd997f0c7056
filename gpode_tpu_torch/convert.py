"""Parameters to and from plain arrays keyed by dotted path.

The keys are the JAX package's leaf paths — of `ShootingParams`
(`gp.kernel.raw_lengthscales`, `states.x0.tril_packed`,
`likelihood.projector.components`, `constraint.raw_scale`, ...) and of
`GPODEParams` (`gp.z`, `x0.mean`, `likelihood.base.raw_variance`, ...) and
of the neural ODE's `NeuralODEParams` (`mlp.w1` ... `mlp.b3`) —
which are also the port's parameter names, so both packages can compute the
same step from the same weights. The port itself never sees JAX: callers
flatten the JAX pytree to this dict.
"""

from __future__ import annotations

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models import gp, gpode, neural_ode, shooting
from gpode_tpu_torch.models.constraints import (GaussianConstraint,
                                                LaplaceConstraint)
from gpode_tpu_torch.models.likelihoods import (GaussianLikelihood,
                                                ProjectedGaussianLikelihood,
                                                Projector)
from gpode_tpu_torch.models.states import (InitialStatePosterior,
                                           ShootingStatePosterior)
from gpode_tpu_torch.ops.kernels import RBFParams


class _Arrays:
    """Tensors from {dotted path: array} on `device`; `done()` raises on
    arrays no parameter took."""

    def __init__(self, flat: dict[str, np.ndarray], device):
        self.flat, self.device, self.unused = flat, device, set(flat)

    def __call__(self, name):
        if name not in self.flat:
            return None
        self.unused.discard(name)
        return torch.tensor(np.asarray(self.flat[name], dtype=np.float32),
                            device=self.device)

    def gp(self) -> gp.SVGPParams:
        return gp.SVGPParams(
            RBFParams(self("gp.kernel.raw_lengthscales"),
                      self("gp.kernel.raw_variance")),
            self("gp.z"), self("gp.u_mean"), u_tril=self("gp.u_tril"),
            u_diag_raw=self("gp.u_diag_raw"))

    def likelihood(self):
        if "likelihood.base.raw_variance" in self.flat:
            return ProjectedGaussianLikelihood(
                GaussianLikelihood(self("likelihood.base.raw_variance")),
                Projector(self("likelihood.projector.components"),
                          self("likelihood.projector.norm_mean"),
                          self("likelihood.projector.norm_std")))
        return GaussianLikelihood(self("likelihood.raw_variance"))

    def done(self, what):
        if self.unused:
            raise KeyError(f"arrays not used by {what}: {sorted(self.unused)}")


def params_from_numpy(flat: dict[str, np.ndarray], args,
                      device=None) -> shooting.ShootingParams:
    """Build `ShootingParams` from {dotted path: array}; `args.constraint_type`
    picks the constraint family. `device` defaults to CUDA."""
    t = _Arrays(flat, resolve_device(device))
    states = ShootingStatePosterior(
        InitialStatePosterior(t("states.x0.mean"), t("states.x0.tril_packed")),
        t("states.mean"), t("states.tril_packed"))
    kind = {"gauss": GaussianConstraint, "laplace": LaplaceConstraint}
    params = shooting.ShootingParams(
        t.gp(), states, t.likelihood(),
        kind[args.constraint_type](t("constraint.raw_scale")))
    t.done("ShootingParams")
    return params


def gpode_params_from_numpy(flat: dict[str, np.ndarray],
                            device=None) -> gpode.GPODEParams:
    """Build `GPODEParams` from {dotted path: array} (the JAX
    `GPODEParams` leaf paths). `device` defaults to CUDA."""
    t = _Arrays(flat, resolve_device(device))
    params = gpode.GPODEParams(
        t.gp(), InitialStatePosterior(t("x0.mean"), t("x0.tril_packed")),
        t.likelihood())
    t.done("GPODEParams")
    return params


def neural_ode_params_from_numpy(flat: dict[str, np.ndarray],
                                 device=None) -> neural_ode.NeuralODEParams:
    """Build `NeuralODEParams` from {dotted path: array} (the JAX
    `NeuralODEParams` leaf paths `mlp.w1` ... `mlp.b3`). `device` defaults
    to CUDA."""
    t = _Arrays(flat, resolve_device(device))
    params = neural_ode.NeuralODEParams(neural_ode.MLPParams(
        *(t(f"mlp.{n}") for n in ("w1", "b1", "w2", "b2", "w3", "b3"))))
    t.done("NeuralODEParams")
    return params


def params_like(template: torch.nn.Module, flat: dict[str, np.ndarray],
                args=None) -> torch.nn.Module:
    """Parameters of `template`'s model (`ShootingParams`, whose constraint
    family `args.constraint_type` names, `GPODEParams` or
    `NeuralODEParams`) from
    {dotted path: array}, on the template's device: how a checkpoint's
    parameters load (`utils/checkpoint.load_checkpoint`), the port's or a
    JAX one's flattened. Every name and shape must be the template's, so a
    checkpoint from a run with other model or data flags fails loudly."""
    want = {n: tuple(p.shape) for n, p in template.named_parameters()}
    got = {n: tuple(np.shape(a)) for n, a in flat.items()}
    if want != got:
        diff = sorted(n for n in set(want) | set(got)
                      if want.get(n) != got.get(n))
        raise ValueError("the arrays do not match the model's parameters "
                         f"(name: model shape, array shape): "
                         f"{[(n, want.get(n), got.get(n)) for n in diff]}")
    device = next(template.parameters()).device
    if isinstance(template, shooting.ShootingParams):
        return params_from_numpy(flat, args, device)
    if isinstance(template, neural_ode.NeuralODEParams):
        return neural_ode_params_from_numpy(flat, device)
    return gpode_params_from_numpy(flat, device)


def params_to_numpy(params: torch.nn.Module) -> dict[str, np.ndarray]:
    """{dotted path: float32 array} of every parameter."""
    return {name: p.detach().cpu().numpy()
            for name, p in params.named_parameters()}
