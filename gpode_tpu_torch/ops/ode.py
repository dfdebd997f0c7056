"""ODE integration: fixed-step Runge-Kutta, the multistep and implicit
solvers, and adaptive dopri5 and VCABM.

Counterpart of `gpode_tpu/ops/ode.py`, with all nine of its solver names
(`SOLVERS`; torchdiffeq's name map, see :func:`odeint`). PyTorch runs
eagerly, so the adaptive solvers' accept/reject decisions are host-side
Python control flow (one host sync per attempt) instead of a bounded
`lax.scan` with masked no-op steps; the semantics are the same:

  * `max_steps` is an attempt budget; once the span is covered the loop ends;
  * steps never overshoot the end, and the clamped final step lands on the
    end exactly, so a shooting segment's endpoint is an actual RK step;
  * the step-size controller is non-differentiable (plain host floats) and
    accepted steps never shrink (torchdiffeq's rule);
  * observation times inside a step come from cubic-Hermite dense output;
    times left uncovered by an exhausted budget fall back to the final state.

Controller scalars are numpy scalars so they round as the JAX solvers'
device-side scalars do: float32 for dopri5 whatever the state, the state's
dtype for the VCABM and the fixed-step multistep solvers (JAX runs those in
float64 under x64).

Returns `(xs (T, *x0.shape), ODEStats)` like the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gpode_tpu_torch.utils.profiling import clocked, span

SOLVERS = ("dopri5", "rk4", "midpoint", "euler", "explicit_adams",
           "fixed_adams", "adams", "implicit_adams", "bdf")

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

# Dense output points of the adaptive solvers, by where they were formed: on
# the host (`_hermite`, a few tensor ops a point) or on the device (an
# attempt that commits its accepted steps there, `models/flow.CapturedAttempt`).
DENSE_POINTS = {"host": 0, "device": 0}


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


def _rk4_step(f, t, x, dt, k1=None):
    k1 = f(t, x) if k1 is None else k1  # callers with f(t, x) in hand reuse it
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
# Fixed-step multistep and implicit solvers
# ---------------------------------------------------------------------------

_AB4 = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)
_AM4 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)


def _host_dtype(x: torch.Tensor):
    """The numpy scalar type of the state's dtype (host step arithmetic)."""
    return np.float64 if x.dtype == torch.float64 else _F32


def _intervals(ts: torch.Tensor, x0: torch.Tensor, substeps: int):
    """(t0, uniform sub-step h) of every observation interval, host scalars
    of the state's dtype."""
    dt = _host_dtype(x0)
    t_host = ts.detach().cpu().numpy().astype(dt)
    return [(t_host[k], (t_host[k + 1] - t_host[k]) / dt(substeps))
            for k in range(len(t_host) - 1)]


def _multistep(f, x0, ts, substeps, advance):
    """Run `advance(t, x, h, hist) -> x` over every sub-step; each interval
    restarts the method (uniform h), bootstrapping its first three sub-steps
    with rk4. `hist` holds f at the last sub-steps, newest first."""
    xs, x = [x0], x0
    for t, h in _intervals(ts, x0, substeps):
        hist = []
        for i in range(substeps):
            f0 = f(float(t), x)
            hist = [f0] + hist[:3]
            if i < 3:
                x = _rk4_step(f, float(t), x, float(h), k1=f0)
            else:
                x = advance(t, x, h, hist)
            t = t + h
        xs.append(x)
    return torch.stack(xs)


def _fixed_stats(ts, substeps, per_interval) -> ODEStats:
    steps = (len(ts) - 1) * substeps
    return ODEStats((len(ts) - 1) * per_interval, steps, steps, len(ts))


def odeint_adams(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
                 substeps: int = 4):
    """Fixed-step 4th-order Adams-Bashforth (torchdiffeq's `explicit_adams`).
    Multistep methods need a uniform step, so the method restarts at every
    observation interval: the first three sub-steps are rk4, the rest AB4.
    With substeps < 4 it is rk4."""
    def ab4(t, x, h, hist):
        return x + float(h) * sum(b * fk for b, fk in zip(_AB4, hist))

    xs = _multistep(f, x0, ts, substeps, ab4)
    return xs, _fixed_stats(ts, substeps,
                            4 * min(3, substeps) + max(0, substeps - 3))


def odeint_adams_moulton(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
                         substeps: int = 4, corrector_iters: int = 1):
    """Implicit 4th-order Adams-Bashforth-Moulton predictor-corrector (PECE;
    torchdiffeq's `fixed_adams` / `implicit_adams`): the AB4 predictor, then
    `corrector_iters` sweeps of the AM4 corrector
        y_{n+1} = y_n + h (9 f(y_{n+1}) + 19 f_n - 5 f_{n-1} + f_{n-2}) / 24,
    restarting per observation interval as :func:`odeint_adams` does."""
    def pece(t, x, h, hist):
        pred = x + float(h) * sum(b * fk for b, fk in zip(_AB4, hist))
        for _ in range(corrector_iters):
            f_new = f(float(t + h), pred)
            pred = x + float(h) * (_AM4[0] * f_new + sum(
                b * fk for b, fk in zip(_AM4[1:], hist[:3])))
        return pred

    xs = _multistep(f, x0, ts, substeps, pece)
    return xs, _fixed_stats(ts, substeps, 4 * min(3, substeps) + max(
        0, substeps - 3) * (1 + corrector_iters))


def _newton_implicit_step(f, t_new, y_guess, rhs_const, gamma_h,
                          newton_iters):
    """Solve y = rhs_const + gamma_h * f(t_new, y) by full Newton.

    The field applies rowwise to a (..., D) state, so its Jacobian is
    block-diagonal: D pullbacks of cotangent e_i give row i of every block
    at once. With grad mode on the Jacobian is built with `create_graph`,
    so gradients flow through the unrolled iterations — a second
    derivative of f, which the kernels' autograd rules do not have (the
    flow pins BDF to the plain rhs). The iterations are built on detached
    values when grad mode is off or nothing upstream needs a gradient: the
    callers' guesses are functions of f, so they carry the graph of the
    field's parameters whenever there is one."""
    d = y_guess.shape[-1]
    eye = torch.eye(d, dtype=y_guess.dtype, device=y_guess.device)
    taped = torch.is_grad_enabled() and (y_guess.requires_grad
                                         or rhs_const.requires_grad)
    y = y_guess
    for _ in range(newton_iters):
        with torch.enable_grad():
            yy = y if (taped and y.requires_grad) else y.detach().requires_grad_()
            fy = f(t_new, yy)
            rows = [torch.autograd.grad(fy, yy, eye[i].expand_as(fy),
                                        retain_graph=True,
                                        create_graph=taped)[0]
                    for i in range(d)]
        jac = torch.stack(rows, dim=-2)                 # (..., D, D)
        if not taped:
            fy, jac = fy.detach(), jac.detach()
        g = y - gamma_h * fy - rhs_const                # residual
        a = eye - gamma_h * jac                         # Newton matrix
        y = y - torch.linalg.solve(a, g[..., None])[..., 0]
    return y


def odeint_bdf(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
               substeps: int = 4, newton_iters: int = 3):
    """Fixed-step BDF2 with batched Newton solves (A-stable; stiff fields).
    Per observation interval `substeps` uniform steps: the first is BDF1
    (backward Euler from an explicit-Euler guess), the rest BDF2
        y_{n+1} = (4 y_n - y_{n-1}) / 3 + (2h/3) f(y_{n+1}),
    each resolved by `newton_iters` Newton iterations with exact
    block-diagonal Jacobians (:func:`_newton_implicit_step`)."""
    dt = _host_dtype(x0)
    xs, x = [x0], x0
    for t, h in _intervals(ts, x0, substeps):
        x_prev = x  # y_{n-1} for BDF2; seeded by the BDF1 step
        for i in range(substeps):
            t_new = float(t + h)
            if i == 0:
                guess = x + float(h) * f(float(t), x)
                x_new = _newton_implicit_step(f, t_new, guess, x, float(h),
                                              newton_iters)
            else:
                guess = 2.0 * x - x_prev  # linear extrapolation predictor
                rhs_const = (4.0 * x - x_prev) / 3.0
                x_new = _newton_implicit_step(f, t_new, guess, rhs_const,
                                              float(dt(2.0) * h / dt(3.0)),
                                              newton_iters)
            x_prev, x = x, x_new
            t = t + h
        xs.append(x)
    # the JAX package's count: per implicit sub-step newton_iters * (1
    # residual eval + D pullbacks at ~2 evals), plus each interval's
    # predictor eval
    per_step = newton_iters * (1 + 2 * x0.shape[-1])
    steps = (len(ts) - 1) * substeps
    return torch.stack(xs), ODEStats((len(ts) - 1) * (substeps * per_step + 1),
                                     steps, steps, len(ts))


# ---------------------------------------------------------------------------
# Adaptive dopri5
# ---------------------------------------------------------------------------

def _dopri5_step(f, t, x, dt, k1):
    """One Dormand-Prince step; FSAL: k1 = f(t, x) supplied, k7 returned.

    Returns (x5, err, k7): 5th-order solution, embedded error estimate, last
    stage evaluation (equal to f(t+dt, x5)). 6 fresh rhs evaluations. `t`
    None: a time-invariant `f`, called with t None at every stage.
    """
    ks = [k1]
    for i in range(1, 7):
        xi = x + dt * sum(a * k for a, k in zip(_DP_A[i], ks))
        ks.append(f(None if t is None else t + _DP_C[i] * dt, xi))
    x5 = x + dt * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)
    err = dt * sum((b5 - b4) * k for b5, b4, k in zip(_DP_B5, _DP_B4, ks))
    return x5, err, ks[6]


def _initial_step(f, x0, f0, rtol, atol, norm=_rms, dtype=_F32):
    """Hairer's initial step-size heuristic (torchdiffeq
    `_select_initial_step`), evaluated under no_grad on host scalars of
    `dtype`."""
    with torch.no_grad():
        scale = atol + torch.abs(x0) * rtol
        d0 = dtype(norm(x0 / scale).item())
        d1 = dtype(norm(f0 / scale).item())
        h0 = dtype(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else dtype(0.01) * d0 / d1
        f1 = f(float(h0), x0 + float(h0) * f0)
        d2 = dtype(norm((f1 - f0) / scale).item()) / h0
    dmax = max(d1, d2)
    h1 = (max(dtype(1e-6), h0 * dtype(1e-3)) if dmax <= 1e-15
          else dtype((dtype(0.01) / dmax) ** dtype(1.0 / _ORDER)))
    return dtype(min(dtype(100.0) * h0, h1))


def _hermite(t, t0, t1, x0, f0, x1, f1, dtype=_F32):
    """Cubic Hermite interpolant on [t0, t1] at host time t."""
    h = dtype(t1 - t0)
    h = dtype(1.0) if h == 0.0 else h
    s = dtype((t - t0) / h)
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    return (float(h00) * x0 + float(h10 * h) * f0 + float(h01) * x1
            + float(h11 * h) * f1)


def dopri5_attempt(f: Callable, *, rtol: float, atol: float,
                   norm: Callable[[torch.Tensor], torch.Tensor] = _rms):
    """`odeint_dopri5`'s attempt function on `f`: `attempt(t, x, k1, dt) ->
    (x_new, ratio, k7)`, the step from `x` (FSAL `k1`) and its error norm,
    a 0-d tensor that accepts the step at <= 1. `t` and `dt` are host
    floats; or `t` is None and `dt` a 0-d device tensor, for a
    time-invariant `f`, as a captured attempt runs it
    (`models/flow.CapturedAttempt`). The step's end `t_end` is not read."""
    def attempt(t, x, k1, dt, t_end=None):
        del t_end
        x_new, err, k7 = _dopri5_step(f, t, x, dt, k1)
        with torch.no_grad():
            scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x_new))
            ratio = norm(err / scale)
        return x_new, ratio, k7

    return attempt


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
                  norm: Callable[[torch.Tensor], torch.Tensor] = _rms,
                  attempt: Optional[Callable] = None):
    """Adaptive Dormand-Prince 5(4) with dense output at `ts`.

    `first_step`: None -> Hairer's heuristic; FIRST_STEP_SPAN -> the whole
    span (shooting segments); a positive float -> that dt (e.g. the
    controller-shrunk step seeding the rejected-attempt fallback in
    `models/flow.py`). `ts` may be increasing or decreasing.

    `attempt`: None -> :func:`dopri5_attempt` on `f`; else a function with
    its signature and results, called with host floats, the step's end
    among them. Where it has a `dense_output(taus, x0)` method, which
    returns a (T, *x0.shape) buffer, the attempt commits its accepted
    steps itself (`models/flow.CapturedAttempt`, which replays a CUDA
    graph): it writes the dense output at the output times in (tau,
    tau_end] into that buffer and hands the step over into the state and
    FSAL value it returns; the host forms no point and returns a copy of
    the buffer.
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

    if attempt is None:
        attempt = dopri5_attempt(f_tau, rtol=rtol, atol=atol, norm=norm)
    dense_output = getattr(attempt, "dense_output", None)
    dense = None if dense_output is None else dense_output(taus, x0)
    out = [x0 if tau_j <= 0.0 else None for tau_j in taus]
    tau, x, k1 = _F32(0.0), x0, f0
    nacc = natt = 0
    for _ in range(max_steps):
        if tau >= tau_final:
            break
        with clocked("gpode.solve.attempt"):
            remaining = _F32(tau_final - tau)
            dt_step = _F32(min(dt, remaining))
            tau_end = (tau_final if dt_step >= remaining
                       else _F32(tau + dt_step))
            x_new, ratio, k7 = attempt(float(tau), x, k1, float(dt_step),
                                       float(tau_end))
            with clocked("gpode.solve.error_read"):
                err_ratio = float(ratio)
            accept = err_ratio <= 1.0
            if accept:
                if dense is None:
                    for j, tau_j in enumerate(taus):
                        if out[j] is None and tau_j <= tau_end:
                            out[j] = _hermite(tau_j, tau, tau_end, x, k1,
                                              x_new, k7)
                            DENSE_POINTS["host"] += 1
                tau, x, k1 = tau_end, x_new, k7
                nacc += 1
            dt = _F32(dt_step * dopri5_controller(err_ratio, accept))
            nfe += 6
            natt += 1

    if dense is not None:
        # the accepted steps cover (0, tau] and each wrote its points; the
        # points at or before the start hold x0, those past tau the last x
        covered = int(np.count_nonzero(taus <= tau))
        DENSE_POINTS["device"] += covered - int(np.count_nonzero(taus <= 0.0))
        xs = dense.clone()
        for j in np.flatnonzero(taus > tau):
            xs[j] = x
        return xs, ODEStats(nfe, nacc, natt, covered)
    covered = sum(o is not None for o in out)
    out = [x if o is None else o for o in out]
    return torch.stack(out), ODEStats(nfe, nacc, natt, covered)


# ---------------------------------------------------------------------------
# Adaptive variable-coefficient Adams-Bashforth-Moulton (torchdiffeq `adams`)
# ---------------------------------------------------------------------------

_VCABM_MAX_ORDER = 12  # torchdiffeq's _MAX_ORDER


def _gamma_star_table(n: int):
    """Adams-Moulton error constants gamma*_0..gamma*_n from the recurrence
    sum_{i=0..m} gamma*_i / (m - i + 1) = 0 (m >= 1), gamma*_0 = 1 (Hairer
    I, III.1): 1, -1/2, -1/12, -1/24, -19/720, -3/160, ..."""
    from fractions import Fraction
    g = [Fraction(1)]
    for m in range(1, n + 1):
        g.append(-sum(g[i] / (m - i + 1) for i in range(m)))
    return [float(v) for v in g]


def odeint_adams_adaptive(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
                          rtol: float = 1e-6, atol: float = 1e-6,
                          max_steps: int = 256,
                          first_step: float | None = None,
                          max_order: int = _VCABM_MAX_ORDER,
                          norm: Callable[[torch.Tensor], torch.Tensor] = _rms):
    """Adaptive variable-order, variable-step Adams-Bashforth-Moulton
    (torchdiffeq's `adams`: the Shampine-Gordon / Hairer III.5 modified
    divided differences), the order ramping 1 -> max_order.

    One attempt at order k, with phi_j the divided differences of f at the
    accepted points t_n, t_{n-1}, ...:

      beta_j = prod_{i<j} (t_{n+1} - t_{n-i}) / (t_n - t_{n-1-i}),
      ephi_j = beta_j phi_j,  g_j from the Shampine-Gordon c-recurrence;
      PREDICT  p = x_n + h sum_{j<k} g_j ephi_j;  f_p = f(t_{n+1}, p);
      CORRECT  y = p + h g_k phi^p_k  (phi^p_j = phi^p_{j-1} - ephi_{j-1});
      err_k = norm(h (g_k - g_{k-1}) phi^p_k / scale), accept if <= 1;
      f_c = f(t_{n+1}, y) builds the next step's differences.

    Order selection on accept: while fewer than 5 points are in the history
    or k < 3 the order ramps (k+1, at most 3); afterwards it drops to k-1 if
    min(err_{k-1}, err_{k-2}) < err_k, rises to k+1 if
    err_{k+1} = norm(h gamma*_{k+1} phi^c_{k+1} / scale) < err_k. Step
    size: halved on reject; on accept kept when the order rose, else
    h * clip(0.9 err_k^(-1/(k+1)), 0.2, 10).

    Host control as in :func:`odeint_dopri5`: the order is a Python int, the
    history a list of the valid differences (no masked lanes), and the
    decisions are numpy scalars of the state's dtype, read in one sync per
    attempt (f_c is evaluated before it, so a rejected attempt's f_c is
    work thrown away). `num_rhs_evals` counts torchdiffeq-equivalent
    evaluations, two per accepted attempt and one per rejected, as the JAX
    package counts. Dense output, no overshoot and budget semantics are
    those of dopri5.
    """
    if not 1 <= max_order <= _VCABM_MAX_ORDER:
        raise ValueError(f"max_order must be in [1, {_VCABM_MAX_ORDER}]")
    K = max_order
    dt_ = _host_dtype(x0)
    gamma = [dt_(v) for v in _gamma_star_table(K + 1)]
    t_host = ts.detach().cpu().numpy().astype(dt_)
    direction = dt_(np.sign(t_host[-1] - t_host[0]))
    taus = direction * (t_host - t_host[0])
    tau_final = taus[-1]

    def f_tau(tau, x):
        return float(direction) * f(float(t_host[0] + direction * dt_(tau)), x)

    f0 = f_tau(0.0, x0)
    if first_step is None:
        h0 = _initial_step(f_tau, x0, f0, rtol, atol, norm, dt_)
        nfe = 2
    else:
        if first_step <= 0.0 and first_step != FIRST_STEP_SPAN:
            raise ValueError(
                f"first_step must be positive or the FIRST_STEP_SPAN "
                f"sentinel ({FIRST_STEP_SPAN}); got {first_step}")
        h0 = tau_final if first_step == FIRST_STEP_SPAN else dt_(first_step)
        nfe = 1
    dt = max(dt_(h0), dt_(1e-12))

    out = [x0 if tau_j <= 0.0 else None for tau_j in taus]
    tau, x = dt_(0.0), x0
    prev_t = [dt_(0.0)] * (K + 1)   # accepted times, newest first
    phi = [f0]                      # valid divided differences
    order, hist_len = 1, 1
    nacc = natt = 0
    for _ in range(max_steps):
        if tau >= tau_final:
            break
        remaining = dt_(tau_final - tau)
        b = min(dt, remaining)          # this attempt's step
        next_t = dt_(tau + b)

        # the history's times are distinct accepted points, so no divisor
        # below is 0 (the JAX version guards its masked lanes)
        n_e = min(len(phi), K + 1)
        ephi, beta = [phi[0]], dt_(1.0)
        for j in range(1, n_e):
            beta = dt_(beta * dt_(next_t - prev_t[j - 1])
                       / dt_(prev_t[0] - prev_t[j]))
            ephi.append(float(beta) * phi[j])
        c = dt_(1.0) / np.arange(1, K + 3, dtype=dt_)
        g = [dt_(1.0)]
        for j in range(1, order + 1):
            factor = dt_(1.0) if j == 1 else b / dt_(next_t - prev_t[j - 1])
            c = c[:-1] - c[1:] * factor
            g.append(c[0])

        p = x
        for j in range(order):
            p = p + float(b * g[j]) * ephi[j]
        phi_p = [f_tau(next_t, p)]
        for j in range(1, order + 1):
            phi_p.append(phi_p[j - 1] - ephi[j - 1])
        g_k, g_km1 = g[order], g[order - 1]
        y1 = p + float(b * g_k) * phi_p[order]
        f_c = f_tau(next_t, y1)
        phi_c = [f_c]
        for j in range(1, n_e + 1):
            phi_c.append(phi_c[j - 1] - ephi[j - 1])

        ramping = hist_len <= 4 or order < 3
        with torch.no_grad():
            scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(y1))
            errs = [norm(float(b * (g_k - g_km1)) * phi_p[order] / scale)]
            if not ramping:
                errs += [
                    norm(float(b * (g_km1 - g[order - 2]))
                         * phi_p[order - 1] / scale),
                    norm(float(b * (g[order - 2] - g[order - 3]))
                         * phi_p[order - 2] / scale),
                    norm(float(b * gamma[order + 1]) * phi_c[order + 1] / scale)]
            errs = torch.stack(errs).cpu().numpy()   # the attempt's one sync
        err_k = errs[0]
        accept = err_k <= 1.0
        if ramping:
            next_order = min(order + 1, 3, K)
        elif min(errs[1], errs[2]) < err_k and order > 1:
            next_order = order - 1
        elif errs[3] < err_k and order < K:
            next_order = order + 1
        else:
            next_order = order
        factor = dt_(_SAFETY) * (err_k + dt_(1e-30)) ** (
            dt_(-1.0) / (dt_(order) + dt_(1.0)))
        factor = min(max(factor, dt_(_DFACTOR)), dt_(_IFACTOR))
        dt_acc = b if next_order > order else dt_(b * factor)
        dt = dt_acc if accept else dt_(b * dt_(0.5))

        tau_end = tau_final if b >= remaining else next_t
        if accept:
            for j, tau_j in enumerate(taus):
                if out[j] is None and tau_j <= tau_end:
                    out[j] = _hermite(tau_j, tau, tau_end, x, phi[0], y1, f_c,
                                      dt_)
                    DENSE_POINTS["host"] += 1
            tau, x = tau_end, y1
            prev_t = [tau_end] + prev_t[:-1]
            phi = phi_c[:K + 2]
            order = next_order
            hist_len = min(hist_len + 1, K + 2)
            nacc += 1
            nfe += 2
        else:
            nfe += 1
        natt += 1

    covered = sum(o is not None for o in out)
    out = [x if o is None else o for o in out]
    return torch.stack(out), ODEStats(nfe, nacc, natt, covered)


def odeint(f: Callable, x0: torch.Tensor, ts: torch.Tensor, *,
           solver: str = "dopri5", rtol: float = 1e-6, atol: float = 1e-6,
           substeps: int = 1, max_steps: int = 256,
           first_step: float | None = None,
           norm: Callable[[torch.Tensor], torch.Tensor] = _rms,
           attempt: Optional[Callable] = None):
    """Entry point over all solvers (`SOLVERS`). torchdiffeq's name map, as
    the JAX package's: `adams` is the adaptive VCABM, `explicit_adams` the
    fixed AB4, `fixed_adams` / `implicit_adams` the fixed PECE, `bdf` the
    fixed BDF2; the multistep solvers take at least 4 sub-steps per
    interval and BDF at least 2. The solve is the span `gpode.solve`; each
    attempt of the adaptive dopri5 loop is a `gpode.solve.attempt` inside
    it, with its host read of the error norm a `gpode.solve.error_read`
    (both counted and timed on the host's clock when no profiler is
    active: `profiling.UNTRACED`). `attempt` is dopri5's
    (:func:`odeint_dopri5`); the other solvers take none."""
    with span("gpode.solve"):
        if solver == "dopri5":
            return odeint_dopri5(f, x0, ts, rtol=rtol, atol=atol,
                                 max_steps=max_steps, first_step=first_step,
                                 norm=norm, attempt=attempt)
        if solver == "adams":
            return odeint_adams_adaptive(f, x0, ts, rtol=rtol, atol=atol,
                                         max_steps=max_steps,
                                         first_step=first_step, norm=norm)
        if solver == "explicit_adams":
            return odeint_adams(f, x0, ts, substeps=max(substeps, 4))
        if solver in ("fixed_adams", "implicit_adams"):
            return odeint_adams_moulton(f, x0, ts, substeps=max(substeps, 4))
        if solver == "bdf":
            return odeint_bdf(f, x0, ts, substeps=max(substeps, 2))
        return odeint_fixed(f, x0, ts, solver=solver, substeps=substeps)
