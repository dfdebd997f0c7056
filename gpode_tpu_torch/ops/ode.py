"""ODE integration: fixed-step Runge-Kutta and adaptive dopri5.

Counterpart of the main-path subset of `gpode_tpu/ops/ode.py`. PyTorch runs
eagerly, so the adaptive solver's accept/reject decisions are host-side
Python control flow (one host sync per attempt) instead of a bounded
`lax.scan` with masked no-op steps; the semantics are the same:

  * `max_steps` is an attempt budget; once the span is covered the loop ends;
  * steps never overshoot the end, and the clamped final step lands on the
    end exactly, so a shooting segment's endpoint is an actual RK step;
  * the step-size controller is non-differentiable (plain host floats) and
    accepted steps never shrink (torchdiffeq's rule);
  * observation times inside a step come from cubic-Hermite dense output;
    times left uncovered by an exhausted budget fall back to the final state.

Controller scalars are kept in float32 (numpy) so they round as the JAX
solver's device-side float32 scalars do.

Returns `(xs (T, *x0.shape), ODEStats)` like the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

_SAFETY = 0.9
_IFACTOR = 10.0
_DFACTOR = 0.2
_ORDER = 5.0  # dopri5 error-control order

# `first_step` sentinel: attempt the whole integration span as the first step.
FIRST_STEP_SPAN = -1.0

# Dormand-Prince 5(4) tableau. The ONE copy in the port: the CUDA attempt
# kernels receive these coefficients from here (`ops/cuda_kernels.py`), so an
# accepted whole-span attempt IS this solver's first accepted step.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)

_F32 = np.float32


class ODEStats(NamedTuple):
    """Solver diagnostics (host integers)."""

    num_rhs_evals: int
    num_accepted: int
    num_attempted: int
    # Observation times produced by real integration or dense output;
    # num_covered < len(ts) flags an exhausted step budget.
    num_covered: int


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def max_rms_over_axis0(r: torch.Tensor) -> torch.Tensor:
    """Error norm for a batch of independent solves stacked on axis 0: the
    RMS of each member, reduced by max, so shared step control is at least
    as strict as each member's own controller would be (the batched-draw
    eval path, `models/gpode.predict`)."""
    return torch.max(torch.sqrt(torch.mean(
        torch.square(r.reshape(r.shape[0], -1)), dim=1)))


# ---------------------------------------------------------------------------
# Fixed-step solvers
# ---------------------------------------------------------------------------

def _euler_step(f, t, x, dt):
    return x + dt * f(t, x)


def _midpoint_step(f, t, x, dt):
    k1 = f(t, x)
    return x + dt * f(t + 0.5 * dt, x + 0.5 * dt * k1)


def _rk4_step(f, t, x, dt):
    k1 = f(t, x)
    k2 = f(t + 0.5 * dt, x + 0.5 * dt * k1)
    k3 = f(t + 0.5 * dt, x + 0.5 * dt * k2)
    k4 = f(t + dt, x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_FIXED_STEPPERS = {"euler": (_euler_step, 1), "midpoint": (_midpoint_step, 2),
                   "rk4": (_rk4_step, 4)}


def odeint_fixed(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
                 solver: str = "rk4", substeps: int = 1):
    """Fixed-step integration hitting every entry of `ts` exactly, with
    `substeps` equal steps per observation interval."""
    if solver not in _FIXED_STEPPERS:
        raise ValueError(f"unknown fixed-step solver {solver!r}")
    stepper, evals = _FIXED_STEPPERS[solver]
    t_host = ts.detach().cpu().numpy().astype(_F32)
    xs = [x0]
    x = x0
    for k in range(len(t_host) - 1):
        dt = _F32((t_host[k + 1] - t_host[k]) / _F32(substeps))
        for j in range(substeps):
            x = stepper(f, float(t_host[k] + dt * _F32(j)), x, float(dt))
        xs.append(x)
    steps = (len(t_host) - 1) * substeps
    return torch.stack(xs), ODEStats(steps * evals, steps, steps, len(t_host))


# ---------------------------------------------------------------------------
# Adaptive dopri5
# ---------------------------------------------------------------------------

def _dopri5_step(f, t, x, dt, k1):
    """One Dormand-Prince step; FSAL: k1 = f(t, x) supplied, k7 returned.

    Returns (x5, err, k7): 5th-order solution, embedded error estimate, last
    stage evaluation (equal to f(t+dt, x5)). 6 fresh rhs evaluations.
    """
    ks = [k1]
    for i in range(1, 7):
        xi = x + dt * sum(a * k for a, k in zip(_DP_A[i], ks))
        ks.append(f(t + _DP_C[i] * dt, xi))
    x5 = x + dt * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)
    err = dt * sum((b5 - b4) * k for b5, b4, k in zip(_DP_B5, _DP_B4, ks))
    return x5, err, ks[6]


def _initial_step(f, x0, f0, rtol, atol, norm=_rms) -> np.float32:
    """Hairer's initial step-size heuristic (torchdiffeq
    `_select_initial_step`), evaluated under no_grad on host floats."""
    with torch.no_grad():
        scale = atol + torch.abs(x0) * rtol
        d0 = _F32(norm(x0 / scale).item())
        d1 = _F32(norm(f0 / scale).item())
        h0 = _F32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else _F32(0.01) * d0 / d1
        f1 = f(float(h0), x0 + float(h0) * f0)
        d2 = _F32(norm((f1 - f0) / scale).item()) / h0
    dmax = max(d1, d2)
    h1 = (max(_F32(1e-6), h0 * _F32(1e-3)) if dmax <= 1e-15
          else _F32((_F32(0.01) / dmax) ** _F32(1.0 / _ORDER)))
    return _F32(min(_F32(100.0) * h0, h1))


def _hermite(t, t0, t1, x0, f0, x1, f1):
    """Cubic Hermite interpolant on [t0, t1] at host time t."""
    h = _F32(t1 - t0)
    h = _F32(1.0) if h == 0.0 else h
    s = _F32((t - t0) / h)
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    return (float(h00) * x0 + float(h10 * h) * f0 + float(h01) * x1
            + float(h11 * h) * f1)


def dopri5_controller(err_ratio: float, accepted: bool) -> np.float32:
    """Step-size factor after an attempt: safety * err^(-1/5), never below 1
    on an accepted step, clipped to [_DFACTOR, _IFACTOR]."""
    factor = _F32(_SAFETY) * _F32(_F32(err_ratio) + _F32(1e-30)) ** _F32(-1.0 / _ORDER)
    if accepted:
        factor = max(factor, _F32(1.0))
    return _F32(min(max(factor, _F32(_DFACTOR)), _F32(_IFACTOR)))


def odeint_dopri5(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
                  rtol: float = 1e-6, atol: float = 1e-6,
                  max_steps: int = 256, first_step: float | None = None,
                  norm: Callable[[torch.Tensor], torch.Tensor] = _rms):
    """Adaptive Dormand-Prince 5(4) with dense output at `ts`.

    `first_step`: None -> Hairer's heuristic; FIRST_STEP_SPAN -> the whole
    span (shooting segments); a positive float -> that dt (e.g. the
    controller-shrunk step seeding the rejected-attempt fallback in
    `models/flow.py`). `ts` may be increasing or decreasing.
    """
    t_host = ts.detach().cpu().numpy().astype(_F32)
    direction = _F32(np.sign(t_host[-1] - t_host[0]))
    taus = direction * (t_host - t_host[0])
    tau_final = taus[-1]

    def f_tau(tau, x):
        return float(direction) * f(float(t_host[0] + direction * _F32(tau)), x)

    f0 = f_tau(0.0, x0)
    if first_step is None:
        dt = _initial_step(f_tau, x0, f0, rtol, atol, norm)
        nfe = 2  # f0 + the heuristic's probe evaluation
    else:
        if first_step <= 0.0 and first_step != FIRST_STEP_SPAN:
            raise ValueError(
                f"first_step must be positive or the FIRST_STEP_SPAN "
                f"sentinel ({FIRST_STEP_SPAN}); got {first_step}")
        dt = tau_final if first_step == FIRST_STEP_SPAN else _F32(first_step)
        dt = _F32(min(dt, tau_final))
        nfe = 1  # f0 only (FSAL seed)

    out = [x0 if tau_j <= 0.0 else None for tau_j in taus]
    tau, x, k1 = _F32(0.0), x0, f0
    nacc = natt = 0
    for _ in range(max_steps):
        if tau >= tau_final:
            break
        remaining = _F32(tau_final - tau)
        dt_step = _F32(min(dt, remaining))
        x_new, err, k7 = _dopri5_step(f_tau, float(tau), x, float(dt_step), k1)
        with torch.no_grad():
            scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x_new))
            err_ratio = float(norm(err / scale))
        accept = err_ratio <= 1.0
        tau_end = tau_final if dt_step >= remaining else _F32(tau + dt_step)
        if accept:
            for j, tau_j in enumerate(taus):
                if out[j] is None and tau_j <= tau_end:
                    out[j] = _hermite(tau_j, tau, tau_end, x, k1, x_new, k7)
            tau, x, k1 = tau_end, x_new, k7
            nacc += 1
        dt = _F32(dt_step * dopri5_controller(err_ratio, accept))
        nfe += 6
        natt += 1

    covered = sum(o is not None for o in out)
    out = [x if o is None else o for o in out]
    return torch.stack(out), ODEStats(nfe, nacc, natt, covered)


def odeint(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
           solver: str = "dopri5", rtol: float = 1e-6, atol: float = 1e-6,
           substeps: int = 1, max_steps: int = 256,
           first_step: float | None = None,
           norm: Callable[[torch.Tensor], torch.Tensor] = _rms):
    """Entry point over the ported solvers (dopri5, rk4, midpoint, euler)."""
    if solver == "dopri5":
        return odeint_dopri5(f, x0, ts, rtol=rtol, atol=atol,
                             max_steps=max_steps, first_step=first_step,
                             norm=norm)
    if solver not in _FIXED_STEPPERS:
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet (dopri5, rk4, midpoint, "
            f"euler are)")
    return odeint_fixed(f, x0, ts, solver=solver, substeps=substeps)
