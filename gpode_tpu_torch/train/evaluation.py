"""Device-side evaluation: predict -> project -> mixture metrics.

Counterpart of `gpode_tpu/train/evaluation.py`: the posterior predictive
(`gpode.predict`, the batched-draw solve), the latent->data projection and
the mixture LL/MSE reduction all run on the device, and the scorer returns
two 0-d tensors, so only two scalars reach the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.data.mocap import ProjectorArrays
from gpode_tpu_torch.models import gpode
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.likelihoods import project
from gpode_tpu_torch.train.builders import make_projector
from gpode_tpu_torch.train.metrics import mixture_summary_device
from gpode_tpu_torch.utils.profiling import span


def make_projected_scorer(eval_cfg: SolverConfig,
                          projector: Optional[ProjectorArrays],
                          ys_true: np.ndarray, ts: np.ndarray,
                          x0: Optional[np.ndarray],
                          t0_shift: Optional[float] = None, device=None):
    """Build `scorer(vparams, noise) -> (ll, mse)`, 0-d tensors on the
    device.

    vparams: a `gpode.GPODEParams` (for a shooting model, the view
    `GPODEParams(p.gp, p.states.x0, p.likelihood)`); noise: a
    `gpode.PredictNoise`, whose draw count and feature count the prediction
    takes. ys_true: ground truth in observation space — (N, T, D_full) when
    a projector is given, latent space otherwise. x0: (N, D) start states,
    or None to sample q(x0) (the noise then needs its x0 normals).
    `device` defaults to CUDA and raises without a card.

    A call is the span `gpode.predict`, holding the draw and the solve
    (`gpode.draw`, `gpode.solve`); the projection and the score are its
    own time.
    """
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, dtype=np.float32), device=device)

    ys_true, ts, x0 = t(ys_true), t(ts), t(x0)
    proj = None if projector is None else make_projector(projector, device)

    @torch.no_grad()
    def scorer(vparams: gpode.GPODEParams, noise: gpode.PredictNoise):
        with span("gpode.predict"):
            zs = gpode.predict(vparams, noise, ts, eval_cfg, x0=x0,
                               t0_shift=t0_shift)
            ys_pred = zs if proj is None else project(proj, zs)
            return mixture_summary_device(ys_true, ys_pred,
                                          vparams.likelihood.variance)

    return scorer
