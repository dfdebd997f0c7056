"""Shooting continuity-constraint densities: Gaussian and Laplace.

Counterpart of `gpode_tpu/models/constraints.py`. Whether the scale trains
is an optimizer-mask concern (`train/trainer.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from gpode_tpu_torch.ops import math as om


class GaussianConstraint(nn.Module):
    def __init__(self, raw_scale):
        super().__init__()
        self.raw_scale = nn.Parameter(raw_scale)

    @property
    def scale(self) -> torch.Tensor:
        return om.softplus(self.raw_scale)


class LaplaceConstraint(GaussianConstraint):
    pass


def init_constraint(kind: str, d: int = 1, scale: float = 1.0, device=None):
    """kind in {"gauss", "laplace"}."""
    raw = torch.full((d,), float(om.invsoftplus(scale)), device=device)
    if kind == "gauss":
        return GaussianConstraint(raw)
    if kind == "laplace":
        return LaplaceConstraint(raw)
    raise ValueError("invalid constraint kind; options are gauss/laplace")


def constraint_log_prob(c, loc, y, raw_scale=None) -> torch.Tensor:
    """Elementwise log p(y; loc, scale); `raw_scale` replaces the
    constraint's own (an annealed scale)."""
    scale = c.scale if raw_scale is None else om.softplus(raw_scale)
    if isinstance(c, LaplaceConstraint):
        return om.laplace_logpdf(y, loc, scale)
    return om.gaussian_logpdf(y, loc, torch.square(scale))
