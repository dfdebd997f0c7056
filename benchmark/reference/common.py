"""The plain reference's shared parts: the decoupled-sampling GP field draw,
the Dormand-Prince solver, the Gaussian densities and Adam.

Written from the published model (arXiv:2106.10905, Hegde et al. 2022) and
the solver's textbook form, in plain PyTorch on any device and in any float
dtype. It imports nothing of the program: the benchmark hands it the same
data, initial parameter values and noise tensors that the program gets, and
it works out everything else again.

`Arith` carries the precision. The reference runs in float64; its control
runs in float32 with every matrix product's operands rounded to TF32 (10
mantissa bits, round to nearest even), which is what a tensor core does with
float32 inputs when TF32 is on, so the control reads the same on a card and
on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SOFTPLUS_FLOOR = 1e-12
GP_JITTER = 1e-5
STATE_JITTER = 1e-5

# Dormand-Prince 5(4): nodes, stage coefficients, 5th- and 4th-order weights
DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
         187 / 2100, 1 / 40)
SAFETY, MIN_FACTOR, MAX_FACTOR, ORDER = 0.9, 0.2, 10.0, 5.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10 mantissa bits (nearest, ties to
    even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + (0xFFF + ((bits >> 13) & 1))
    return (bits & -8192).view(torch.float32)


class Arith:
    """The precision of a reference run: `dtype`, and with `tf32` every
    einsum's operands rounded to TF32 (the control)."""

    def __init__(self, dtype: torch.dtype = torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype = dtype
        self.tf32 = tf32

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            ops = tuple(round_tf32(o) for o in ops)
        return torch.einsum(eq, *ops)


def softplus(x):
    return F.softplus(x) + SOFTPLUS_FLOOR


def fill_tril(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n(n+1)/2) row-major lower triangle -> (..., n, n)."""
    rows, cols = torch.tril_indices(n, n, device=packed.device)
    out = packed.new_zeros(packed.shape[:-1] + (n, n))
    out[..., rows, cols] = packed
    return out


def eye_like(m: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=ref.dtype, device=ref.device)


def gaussian_logpdf(y, mean, var):
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(var)
                   + (y - mean) ** 2 / var)


def kl_to_standard(mean: torch.Tensor, scale_tril: torch.Tensor):
    """sum over the batch of KL(N(mean, L L^T) || N(0, I)); mean (..., k),
    L (..., k, k); log|diag| floored at 1e-20 as the model states."""
    k = mean.shape[-1]
    lo = torch.tril(scale_tril)
    diag = torch.diagonal(lo, dim1=-2, dim2=-1)
    return 0.5 * torch.sum(torch.sum(mean ** 2, -1) + torch.sum(lo ** 2, (-2, -1))
                           - 2.0 * torch.sum(torch.log(diag.abs() + 1e-20), -1)
                           - k)


# ---------------------------------------------------------------------------
# the GP vector field: f(x) = f_prior(x) + nu^T K(Z, x), one draw per noise
# ---------------------------------------------------------------------------

class Field:
    """One posterior draw (or a batch of draws on leading axes) of the
    dimwise SVGP vector field, built from its noise.

    gp: dict of the GP's leaves (raw_lengthscales (D, Din), raw_variance
    (D,), z (M, Din), u_mean (M, D), u_tril (D, M(M+1)/2)); noise: dict with
    rff_weights (..., S, D), rff_freq (..., Din, S, D), rff_phase
    (..., 1, S, D), inducing (..., M, D)."""

    def __init__(self, gp: dict, noise: dict, ar: Arith):
        self.ar = ar
        self.ls = softplus(gp["raw_lengthscales"])               # (D, Din)
        self.var = softplus(gp["raw_variance"])                  # (D,)
        self.z = gp["z"]
        m = self.z.shape[0]
        self.omega = noise["rff_freq"] / self.ls.T[:, None, :]   # (..., Din, S, D)
        self.phase = 2.0 * math.pi * noise["rff_phase"]          # (..., 1, S, D)
        self.w = noise["rff_weights"]                            # (..., S, D)
        q = fill_tril(gp["u_tril"], m)                           # (D, M, M)
        v = ar.einsum("dmk,...kd->...md", q, noise["inducing"]) + gp["u_mean"]
        kzz = self.gram(self.z) + GP_JITTER * eye_like(m, self.z)
        chol = torch.linalg.cholesky(kzz)                        # (D, M, M)
        batch = noise["inducing"].shape[:-2]
        u_prior = self.prior(self.z.expand(*batch, *self.z.shape))   # (..., M, D)
        a = torch.linalg.solve_triangular(chol, u_prior.mT[..., None],
                                          upper=False)
        self.nu = torch.linalg.solve_triangular(
            chol.mT, v.mT[..., None] - a, upper=True)[..., 0]    # (..., D, M)

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        """K(Z, x) per output dim: x (..., N, Din) -> (..., D, M, N)."""
        xs = x[..., None, :, :] / self.ls[:, None, :]            # (..., D, N, Din)
        zs = self.z[None] / self.ls[:, None, :]                  # (D, M, Din)
        sq = torch.sum((zs[:, :, None, :] - xs[..., :, None, :, :]) ** 2, -1)
        return self.var[:, None, None] * torch.exp(-0.5 * sq)

    def prior(self, x: torch.Tensor) -> torch.Tensor:
        """The random-Fourier-feature prior draw at x (..., N, Din) ->
        (..., N, D), features scaled by sqrt(2 var / S)."""
        s = self.w.shape[-2]
        xo = self.ar.einsum("...ni,...isd->...nsd", x, self.omega)
        phi = torch.cos(xo + self.phase) * torch.sqrt(2.0 * self.var / s)
        return self.ar.einsum("...nsd,...sd->...nd", phi, self.w)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.prior(x) + self.ar.einsum("...dm,...dmn->...nd", self.nu,
                                              self.gram(x))


# ---------------------------------------------------------------------------
# Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

def dopri5_step(f, x, dt: float, k1):
    """One step from x with f(x) = k1 in hand: (x5, err, k7)."""
    ks = [k1]
    for i in range(1, 6):
        ks.append(f(x + dt * sum(a * k for a, k in zip(DP_A[i], ks))))
    x5 = x + dt * sum(b * k for b, k in zip(DP_B5, ks) if b != 0.0)
    ks.append(f(x5))
    err = dt * sum((b5 - b4) * k for b5, b4, k in zip(DP_B5, DP_B4, ks))
    return x5, err, ks[6]


def rms(r: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(r ** 2))


def max_rms_over_draws(r: torch.Tensor) -> torch.Tensor:
    """The error norm of independent solves stacked on axis 0: each one's
    RMS, then the largest."""
    return torch.max(torch.sqrt(torch.mean(r.reshape(r.shape[0], -1) ** 2, 1)))


def step_factor(ratio: float, accepted: bool) -> float:
    """safety * ratio^(-1/5), at least 1 after an accepted step, within
    [0.2, 10]."""
    factor = SAFETY * (ratio + 1e-30) ** (-1.0 / ORDER)
    if accepted:
        factor = max(factor, 1.0)
    return min(max(factor, MIN_FACTOR), MAX_FACTOR)


def _initial_step(f, x0, f0, rtol, atol, norm) -> float:
    """Hairer, Norsett and Wanner's starting step (Solving ODEs I, II.4)."""
    with torch.no_grad():
        scale = atol + rtol * x0.abs()
        d0 = float(norm(x0 / scale))
        d1 = float(norm(f0 / scale))
        h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
        f1 = f(x0 + h0 * f0)
        d2 = float(norm((f1 - f0) / scale)) / h0
    dmax = max(d1, d2)
    h1 = (max(1e-6, h0 * 1e-3) if dmax <= 1e-15
          else (0.01 / dmax) ** (1.0 / ORDER))
    return min(100.0 * h0, h1)


def _hermite(tau, t0, t1, x0, f0, x1, f1):
    h = t1 - t0
    h = 1.0 if h == 0.0 else h
    s = (tau - t0) / h
    return ((2 * s ** 3 - 3 * s ** 2 + 1) * x0 + (s ** 3 - 2 * s ** 2 + s) * h * f0
            + (-2 * s ** 3 + 3 * s ** 2) * x1 + (s ** 3 - s ** 2) * h * f1)


def dopri5_solve(f, x0, ts, rtol, atol, max_steps, first_step=None,
                 norm=rms):
    """Adaptive dopri5 for a time-invariant field over the increasing host
    times `ts`: (xs (T, *x0.shape), attempts).

    `max_steps` attempts at most; a step never passes the end, and the one
    that reaches it lands on it; observations inside a step come from the
    cubic Hermite interpolant of its ends; observations past an exhausted
    budget take the last state. `first_step`: None -> Hairer's starting
    step, -1 -> the whole span, else that step."""
    taus = [t - ts[0] for t in ts]
    end = taus[-1]
    f0 = f(x0)
    if first_step is None:
        dt = _initial_step(f, x0, f0, rtol, atol, norm)
    else:
        dt = min(end if first_step == -1.0 else first_step, end)
    out = [x0 if tau <= 0.0 else None for tau in taus]
    tau, x, k1 = 0.0, x0, f0
    attempts = 0
    for _ in range(max_steps):
        if tau >= end:
            break
        remaining = end - tau
        h = min(dt, remaining)
        x_new, err, k7 = dopri5_step(f, x, h, k1)
        with torch.no_grad():
            scale = atol + rtol * torch.maximum(x.abs(), x_new.abs())
            ratio = float(norm(err / scale))
        accepted = ratio <= 1.0
        tau_end = end if h >= remaining else tau + h
        if accepted:
            for j, tj in enumerate(taus):
                if out[j] is None and tj <= tau_end:
                    out[j] = _hermite(tj, tau, tau_end, x, k1, x_new, k7)
            tau, x, k1 = tau_end, x_new, k7
        dt = h * step_factor(ratio, accepted)
        attempts += 1
    return torch.stack([x if o is None else o for o in out]), attempts


def whole_span_segments(f, x0, dt: float, rtol, atol, max_steps):
    """Every row of x0 advanced over one interval dt: one dopri5 attempt
    over the whole span, accepted when the RMS of its scaled error over all
    rows is at most 1; otherwise the adaptive solve from the controller's
    shrunk step (the attempt counts as its first). Returns (x1, attempts)."""
    f0 = f(x0)
    x5, err, _ = dopri5_step(f, x0, dt, f0)
    with torch.no_grad():
        ratio = float(rms(err / (atol + rtol * torch.maximum(x0.abs(), x5.abs()))))
    if ratio <= 1.0:
        return x5, 1
    first = dt * min(step_factor(ratio, False), 1.0)
    xs, attempts = dopri5_solve(f, x0, [0.0, dt], rtol, atol, max_steps, first)
    return xs[-1], attempts + 1


# ---------------------------------------------------------------------------
# Adam (Kingma and Ba 2015; eps outside the square root)
# ---------------------------------------------------------------------------

class Adam:
    def __init__(self, values: dict, lr, b1, b2, eps, frozen=()):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.frozen = set(frozen)
        self.m = {k: torch.zeros_like(v) for k, v in values.items()}
        self.v = {k: torch.zeros_like(v) for k, v in values.items()}
        self.t = 0

    def grads(self, values: dict, grads: dict) -> dict:
        return {k: (torch.zeros_like(values[k]) if k in self.frozen
                    or grads.get(k) is None else grads[k]) for k in values}

    @torch.no_grad()
    def update(self, values: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, v in values.items():
            g = grads[k]
            self.m[k] = (1 - self.b1) * g + self.b1 * self.m[k]
            self.v[k] = (1 - self.b2) * g * g + self.b2 * self.v[k]
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            out[k] = v - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out


def train(loss_fn, values: dict, noises: list, opt: dict, frozen_names,
          fault: str | None = None, replay_from: int | None = None):
    """Run len(noises) Adam steps of loss_fn(values, noise) from `values`.
    Returns (losses (floats), every step's gradients as the optimizer takes
    them, the values after the last step). `fault` plants one of the faults
    the comparison has to catch: "unchanged" (the update leaves the values
    as they are); for a step captured at step `replay_from` (counted from
    1) and replayed after it, "stale_noise" (every later step gets that
    step's noise, as if a replay's inputs were not copied in) and
    "stuck_count" (the update count stops advancing after the step after
    it, so later updates take that step's bias corrections)."""
    adam = Adam(values, opt["lr"], opt["b1"], opt["b2"], opt["eps"],
                frozen_names)
    losses, all_grads = [], []
    for i, noise in enumerate(noises):
        if fault == "stale_noise" and i >= replay_from:
            noise = noises[replay_from - 1]
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in values.items()}
        loss = loss_fn(leaves, noise)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = adam.grads(values, dict(zip(names, grads)))
        losses.append(float(loss.detach()))
        all_grads.append(grads)
        if fault == "stuck_count" and i > replay_from:
            adam.t -= 1
        if fault != "unchanged":
            values = adam.update(values, grads)
    return losses, all_grads, values
