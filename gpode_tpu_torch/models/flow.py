"""Flow: numerical integration of a sampled GP vector field.

Counterpart of `gpode_tpu/models/flow.py` (`flow_forward`): `odeint` applied
to `eval_draw` of a fixed :class:`~gpode_tpu_torch.models.gp.PosteriorDraw`,
with the whole-span dopri5 attempt kernel for one-interval shooting
segments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.ops.cuda_kernels import fused_dopri5_attempt
from gpode_tpu_torch.ops.ode import (FIRST_STEP_SPAN, ODEStats,
                                     dopri5_controller, odeint)
from gpode_tpu_torch.utils.time_grids import substeps_from_dense_scale


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver knobs. `ts_dense_scale`: fixed-step solvers take
    `ts_dense_scale - 1` sub-steps per interval; dopri5 ignores it.
    `first_step`: None -> Hairer's heuristic, FIRST_STEP_SPAN -> the whole
    span. `kernels`: None -> the auto rule (dimwise batches of at least 256
    rows take the fused kernels), False -> plain tensor path everywhere,
    True -> the kernels for any dimwise batch (the JAX `pallas` override)."""

    solver: str = "dopri5"
    rtol: float = 1e-6
    atol: float = 1e-6
    ts_dense_scale: int = 1
    max_steps: int = 256
    first_step: Optional[float] = None
    kernels: Optional[bool] = None

    @property
    def substeps(self) -> int:
        return substeps_from_dense_scale(self.ts_dense_scale)


def _kernels_active(cfg: SolverConfig, gp_params: gp.SVGPParams,
                    n_rows: int) -> bool:
    if cfg.kernels is None:
        return gp.kernel_rhs_active(gp_params, n_rows)
    return cfg.kernels and gp_params.dimwise


def flow_forward(gp_params: gp.SVGPParams, draw: gp.PosteriorDraw,
                 x0: torch.Tensor, ts: torch.Tensor,
                 cfg: SolverConfig) -> tuple[torch.Tensor, ODEStats]:
    """Integrate dx/dt = f_draw(x) from x0 (N, D) over ts (T,).
    Returns ((N, T, D), stats)."""
    use_kernel = _kernels_active(cfg, gp_params, x0.shape[0])

    def rhs(t, x):
        del t  # time-invariant ODE
        return gp.eval_draw(gp_params, draw, x, use_kernel)

    # dopri5 whole-span shooting segments: one attempt kernel computes f0,
    # the six stages and the scaled embedded error for every row. The accept
    # test is ONE global RMS over the batch, decided on the host (one sync
    # per call); a rejected attempt falls back to the adaptive solver with
    # the plain rhs, seeded with the controller-shrunk dt. An accepted
    # whole-span attempt IS that solver's first accepted step.
    if (cfg.solver == "dopri5" and ts.shape[0] == 2
            and cfg.first_step == FIRST_STEP_SPAN and use_kernel):
        dt = (ts[1] - ts[0]).detach().reshape(1)
        x5, err_scaled = fused_dopri5_attempt(
            x0, dt, gp_params.z, gp_params.kernel.lengthscales,
            gp_params.kernel.variance, draw.omega, draw.phase,
            gp.kernel_rff_weights(draw.weights), draw.nu, cfg.rtol, cfg.atol)
        err_ratio = float(torch.sqrt(torch.mean(torch.square(err_scaled))))
        if err_ratio <= 1.0:
            return torch.stack([x0, x5], dim=1), ODEStats(7, 1, 1, 2)

        dt_shrunk = np.float32(dt.item()) * min(
            dopri5_controller(err_ratio, accepted=False), np.float32(1.0))

        def rhs_plain(t, x):
            del t
            return gp.eval_draw(gp_params, draw, x, False)

        xs, st = odeint(rhs_plain, x0, ts, solver="dopri5", rtol=cfg.rtol,
                        atol=cfg.atol, max_steps=cfg.max_steps,
                        first_step=float(dt_shrunk))
        # the rejected attempt's 7 kernel evaluations still happened
        return torch.stack([x0, xs[-1]], dim=1), ODEStats(
            st.num_rhs_evals + 7, st.num_accepted, st.num_attempted + 1,
            st.num_covered)

    xs, stats = odeint(rhs, x0, ts, solver=cfg.solver, rtol=cfg.rtol,
                       atol=cfg.atol, substeps=cfg.substeps,
                       max_steps=cfg.max_steps, first_step=cfg.first_step)
    return torch.movedim(xs, 0, 1), stats
