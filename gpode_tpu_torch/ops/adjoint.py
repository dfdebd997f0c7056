"""Continuous-adjoint gradients: O(1)-memory reverse mode through the solver.

Counterpart of `gpode_tpu/ops/adjoint.py`. :func:`odeint_adjoint` solves
the IVP forward without taping the solver, and its backward integrates the
augmented system

    d/dt [x, a, g] = [f(t, x), -a^T df/dx, -a^T df/dtheta]

backward between observation times, adding the output cotangent into `a`
at each observation. The augmented state is raveled to one vector, as the
JAX package ravels it, so the solvers' RMS error norm sees the same values.

Memory is O(state) instead of O(steps x state), at the cost of a second
(backward) solve and gradients that are exact for the continuous problem
rather than the discretized one.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from gpode_tpu_torch.ops.cuda_kernels import first_order_only
from gpode_tpu_torch.ops.ode import ODEStats, odeint


def _augmented_dynamics(f, params, state_shape):
    """The augmented rhs over z = [x, a, g_params] (one flat vector).

    The VJP of f is `torch.autograd.grad` on detached leaves of the
    parameters (and of x when z carries no graph). When grad mode is on and
    z requires grad (the implicit solver's Newton Jacobian), the VJP is
    built with `create_graph` so the dynamics stay differentiable in z."""
    n = 1
    for s in state_shape:
        n *= s
    zeros = [torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
             for p in params]

    def aug(t, z):
        x = z[:n].reshape(state_shape)
        a = z[n:2 * n].reshape(state_shape)
        taped = torch.is_grad_enabled() and z.requires_grad
        with torch.enable_grad():
            x_ = x if taped else x.detach().requires_grad_()
            p_ = [p.detach().requires_grad_() for p in params]
            dx = f(p_, t, x_)
            cots = torch.autograd.grad(dx, [x_, *p_], a, allow_unused=True,
                                       create_graph=taped)
        dp = [zero if c is None else c.reshape(-1)
              for c, zero in zip(cots[1:], zeros)]
        dx = dx if taped else dx.detach()
        return torch.cat([dx.reshape(-1), -cots[0].reshape(-1), -torch.cat(dp)])

    return aug, n


class _OdeintAdjointFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, opts, stats_out, x0, ts, *params):
        xs, stats = odeint(lambda t, x: f(params, t, x), x0, ts, **opts)
        stats_out.append(stats)
        ctx.f, ctx.opts = f, opts
        ctx.save_for_backward(xs, ts, *params)
        return xs

    @staticmethod
    @first_order_only
    def backward(ctx, g):
        xs, ts, *params = ctx.saved_tensors
        # first_step tunes the forward segment solves; each adjoint interval
        # takes Hairer's first step
        opts = {k: v for k, v in ctx.opts.items() if k != "first_step"}
        aug, n = _augmented_dynamics(ctx.f, params, xs.shape[1:])
        a = torch.zeros_like(xs[0])
        gp = torch.zeros(sum(p.numel() for p in params), dtype=xs.dtype,
                         device=xs.device)
        for idx in range(xs.shape[0] - 1, 0, -1):
            a = a + g[idx]  # the cotangent of the observation at ts[idx]
            z0 = torch.cat([xs[idx].reshape(-1), a.reshape(-1), gp])
            zs, _ = odeint(aug, z0, torch.stack([ts[idx], ts[idx - 1]]),
                           **opts)
            a = zs[-1, n:2 * n].reshape(a.shape)
            gp = zs[-1, 2 * n:]
        a = a + g[0]  # the cotangent of the initial observation
        grads, o = [], 0
        for p in params:
            grads.append(gp[o:o + p.numel()].reshape(p.shape))
            o += p.numel()
        return (None, None, None, a, None, *grads)


def odeint_adjoint(f: Callable, params: Sequence[torch.Tensor],
                   x0: torch.Tensor, ts: torch.Tensor, *,
                   solver: str = "dopri5", rtol: float = 1e-6,
                   atol: float = 1e-6, substeps: int = 1,
                   max_steps: int = 256,
                   first_step: Optional[float] = None
                   ) -> tuple[torch.Tensor, ODEStats]:
    """Integrate dx/dt = f(params, t, x) from x0 over ts; gradients of x0
    and of every tensor in `params` via the continuous adjoint. Returns
    (xs (T, *x0.shape), ODEStats) — the FORWARD solve's counters; the
    backward solves' evaluations are not counted. The backward is first
    order only (a double backward raises)."""
    opts = dict(solver=solver, rtol=rtol, atol=atol, substeps=substeps,
                max_steps=max_steps, first_step=first_step)
    stats: list = []
    xs = _OdeintAdjointFn.apply(f, opts, stats, x0, ts, *params)
    return xs, stats[0]
