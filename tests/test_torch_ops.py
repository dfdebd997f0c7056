"""Parity of the port's math, kernel, GP, rhs-kernel, dopri5 and flow layers
against the JAX package, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both packages. The port
runs its kernels' plain versions here (CPU tensors); the JAX side runs its
own CPU route (XLA path / `_rhs_reference_jnp`), never interpret mode.
Tolerances: forward values rtol 1e-5; cotangents rtol 1e-4 with atol
1e-5 * max|g| (the two frameworks sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.models import gp as jgp
from gpode_tpu.models.flow import SolverConfig as JSolverConfig
from gpode_tpu.models.flow import flow_forward as jflow_forward
from gpode_tpu.ops import math as jom
from gpode_tpu.ops.kernels import RBFParams as JRBFParams
from gpode_tpu.ops.kernels import rbf_K as jrbf_K
from gpode_tpu.ops.kernels import rbf_K_diag as jrbf_K_diag
from gpode_tpu.ops.ode import _dopri5_step as j_dopri5_step
from gpode_tpu.ops.ode import _initial_step as j_initial_step
from gpode_tpu.ops.ode import odeint_dopri5 as jodeint_dopri5
from gpode_tpu.ops.ode import odeint_fixed as jodeint_fixed
from gpode_tpu.ops.pallas_kernels import _rhs_reference_jnp

from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import math as tom
from gpode_tpu_torch.ops.kernels import RBFParams, rbf_K, rbf_K_diag
from gpode_tpu_torch.ops.ode import FIRST_STEP_SPAN, odeint_dopri5, odeint_fixed
from gpode_tpu_torch.ops.ode import _initial_step as t_initial_step

torch.set_num_threads(1)

RTOL_FWD = 1e-5
RTOL_GRAD = 1e-4
NAMES = ("x", "z", "lengthscales", "variance", "omega", "phase", "weights", "nu")


def _close(a, b, rtol=RTOL_FWD, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_grad(a, b, msg=""):
    b = np.asarray(b)
    _close(a, b, rtol=RTOL_GRAD, atol=1e-5 * float(np.max(np.abs(b))), msg=msg)


def _rhs_inputs(n=50, m=8, din=3, d=3, s=32, seed=0):
    """x, z, constrained lengthscales/variance, omega, phase, weights, nu."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ls = rng.uniform(0.8, 1.6, size=(d, din)).astype(f32)
    return (rng.normal(size=(n, din)).astype(f32),
            rng.normal(size=(m, din)).astype(f32),
            ls,
            rng.uniform(0.3, 0.8, size=(d,)).astype(f32),
            (rng.normal(size=(din, s, d)) / ls.T[:, None, :]).astype(f32),
            (2 * np.pi * rng.uniform(size=(1, s, d))).astype(f32),
            rng.normal(size=(s, d)).astype(f32),
            (0.5 * rng.normal(size=(d, m))).astype(f32))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# ops/math.py, ops/kernels.py
# ---------------------------------------------------------------------------

def test_math_substrate_matches_jax():
    rng = np.random.default_rng(1)
    y = rng.uniform(1e-3, 5.0, size=(7,)).astype(np.float32)
    _close(tom.invsoftplus(_t(y)), jom.invsoftplus(y))
    _close(tom.softplus(_t(y - 2)), jom.softplus(jnp.asarray(y - 2)))
    packed = rng.normal(size=(2, 3, 10)).astype(np.float32)
    _close(tom.fill_tril(_t(packed), 4), jom.fill_tril(jnp.asarray(packed), 4))
    _close(tom.pack_tril(tom.fill_tril(_t(packed), 4)), packed)
    mean = rng.normal(size=(3, 4)).astype(np.float32)
    _close(tom.kl_whitened_gaussian(_t(mean), tom.fill_tril(_t(packed[0]), 4)),
           jom.kl_whitened_gaussian(mean, jom.fill_tril(packed[0], 4)))
    scale = rng.uniform(0.1, 2.0, size=(3, 4)).astype(np.float32)
    _close(tom.kl_whitened_gaussian_diag(_t(mean), _t(scale)),
           jom.kl_whitened_gaussian_diag(mean, scale))
    a = rng.normal(size=(3, 5, 5)).astype(np.float32)
    spd = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    lt, lj = tom.cholesky_jittered(_t(spd)), jom.cholesky_jittered(spd)
    _close(lt, lj, rtol=1e-4, atol=1e-5)
    b = rng.normal(size=(3, 5, 2)).astype(np.float32)
    _close(tom.solve_lower(lt, _t(b)), jom.solve_lower(lj, b), rtol=1e-4, atol=1e-5)
    _close(tom.solve_upper_from_lower(lt, _t(b)),
           jom.solve_upper_from_lower(lj, b), rtol=1e-4, atol=1e-5)
    _close(tom.tri_logdet_from_chol(lt), jom.tri_logdet_from_chol(lj), rtol=1e-4)
    loc, sc = rng.normal(size=(6,)).astype(np.float32), y[:6]
    _close(tom.gaussian_logpdf(_t(y[:6]), _t(loc), _t(sc)),
           jom.gaussian_logpdf(y[:6], loc, sc))
    _close(tom.laplace_logpdf(_t(y[:6]), _t(loc), _t(sc)),
           jom.laplace_logpdf(y[:6], loc, sc))


@pytest.mark.parametrize("dimwise", [True, False])
def test_rbf_K_matches_jax(dimwise):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    z = rng.normal(size=(8, 3)).astype(np.float32)
    shape = ((4, 3), (4,)) if dimwise else ((3,), (1,))
    raw_ls = rng.normal(size=shape[0]).astype(np.float32)
    raw_var = rng.normal(size=shape[1]).astype(np.float32)
    want = jrbf_K(JRBFParams(raw_ls, raw_var), x, z)
    got = rbf_K(RBFParams(_t(raw_ls), _t(raw_var)), _t(x), _t(z))
    _close(got.detach(), want, atol=1e-6)
    _close(rbf_K_diag(RBFParams(_t(raw_ls), _t(raw_var)), _t(x)).detach(),
           jrbf_K_diag(JRBFParams(raw_ls, raw_var), x))


# ---------------------------------------------------------------------------
# models/gp.py: draw_posterior with the JAX key's noise, eval_draw
# ---------------------------------------------------------------------------

def _gp_pair(m=8, d=3, seed=3):
    """The same SVGP params in both packages."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    raw_ls = rng.normal(0.5, 0.1, size=(d, d)).astype(f32)
    raw_var = rng.normal(0.0, 0.1, size=(d,)).astype(f32)
    z = rng.normal(size=(m, d)).astype(f32)
    u_mean = (0.3 * rng.normal(size=(m, d))).astype(f32)
    tril = np.tril(0.05 * rng.normal(size=(d, m, m)) + 0.2 * np.eye(m))
    u_tril = tril[:, np.tril_indices(m)[0], np.tril_indices(m)[1]].astype(f32)
    jp = jgp.SVGPParams(JRBFParams(raw_ls, raw_var), z, u_mean, u_tril, None)
    tp = tgp.SVGPParams(RBFParams(_t(raw_ls), _t(raw_var)), _t(z), _t(u_mean),
                        u_tril=_t(u_tril))
    return jp, tp


def _draw_noise(key, jp, s):
    """The normals/uniforms `gpode_tpu.models.gp.draw_posterior` draws from
    `key` (its split order: weights, omega, phase, inducing)."""
    m, d = jp.u_mean.shape
    k_w, k_omega, k_phase, k_u = jax.random.split(key, 4)
    return tuple(np.asarray(a) for a in (
        jax.random.normal(k_w, (s, d)),
        jax.random.normal(k_omega, (jp.d_in, s, d)),
        jax.random.uniform(k_phase, (1, s, d)),
        jax.random.normal(k_u, (m, d))))


def test_draw_posterior_and_eval_draw_match_jax():
    jp, tp = _gp_pair()
    key = jax.random.PRNGKey(7)
    jdraw = jgp.draw_posterior(key, jp, 32)
    tdraw = tgp.draw_posterior(tp, *map(_t, _draw_noise(key, jp, 32)))
    for name in jdraw._fields:
        want = np.asarray(getattr(jdraw, name))
        _close(getattr(tdraw, name).detach(), want, rtol=RTOL_FWD,
               atol=1e-5 * float(np.max(np.abs(want))), msg=name)
    x = np.random.default_rng(4).normal(size=(40, 3)).astype(np.float32)
    want = jgp.eval_draw(jp, jdraw, x)
    for use_kernel in (False, True):  # plain path, and the kernel wrapper's CPU path
        got = tgp.eval_draw(tp, tdraw, _t(x), use_kernel)
        _close(got.detach(), want, atol=1e-5, msg=f"use_kernel={use_kernel}")
    _close(tgp.kl(tp).detach(), jgp.kl(jp), rtol=1e-5)


# ---------------------------------------------------------------------------
# fused_rhs: plain forward and autograd vs the JAX reference and jax.vjp
# ---------------------------------------------------------------------------

def test_fused_rhs_plain_forward_matches_reference():
    args = _rhs_inputs()
    want = _rhs_reference_jnp(*map(jnp.asarray, args))
    _close(ck.fused_rhs(*map(_t, args)), want, atol=1e-5)


def test_fused_rhs_cotangents_match_jax_vjp():
    args = _rhs_inputs(seed=5)
    g = np.random.default_rng(6).normal(size=(args[0].shape[0], 3)).astype(np.float32)
    _, pullback = jax.vjp(_rhs_reference_jnp, *map(jnp.asarray, args))
    want = pullback(jnp.asarray(g))
    targs = [_t(a, grad=True) for a in args]
    torch.autograd.backward(ck.fused_rhs(*targs), _t(g))
    for name, a, b in zip(NAMES, targs, want):
        _close_grad(a.grad, b, msg=name)


def test_kernel_cotangent_layout_round_trip():
    """The backward kernels write parameter cotangents as per-dim slabs
    [domega (Din*S) | dphase (S) | dw (S) | dnu (M) | dls (Din) | dvar] plus
    dz (M*Din); the wrapper must unpack them into the public layouts."""
    din, d, m, s = 3, 4, 5, 6
    rng = np.random.default_rng(8)
    domega = rng.normal(size=(din, s, d)).astype(np.float32)
    dphase = rng.normal(size=(1, s, d)).astype(np.float32)
    dw = rng.normal(size=(s, d)).astype(np.float32)
    dnu = rng.normal(size=(d, m)).astype(np.float32)
    dls = rng.normal(size=(d, din)).astype(np.float32)
    dvar = rng.normal(size=(d,)).astype(np.float32)
    dz = rng.normal(size=(m, din)).astype(np.float32)
    slabs = np.concatenate([np.moveaxis(domega, -1, 0).reshape(d, -1),
                            dphase[0].T, dw.T, dnu, dls, dvar[:, None]], axis=1)
    assert slabs.shape[1] == ck._main_slab(din, m, s)
    got = ck._unpack_param_cotangents(_t(slabs), _t(dz.ravel()), din, d, m, s)
    for name, a, b in zip(NAMES[1:], got, (dz, dls, dvar, domega, dphase, dw, dnu)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    # and the forward operand layout is the D-major one the kernels index
    x, z, ls, var, omega, phase, w, nu = map(_t, _rhs_inputs(din=din, d=d, s=s, m=m))
    ops = ck._kernel_operands(z, ls, var, omega, phase, w, nu)
    np.testing.assert_array_equal(ops[3][1, 2].numpy(), omega[2, :, 1].numpy())
    np.testing.assert_array_equal(ops[4][1].numpy(), phase[0, :, 1].numpy())
    np.testing.assert_array_equal(ops[5][1].numpy(), w[:, 1].numpy())
    assert all(o.is_contiguous() for o in ops)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    args = [_t(a) for a in _rhs_inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        ck._check(*args)
    with pytest.raises(TypeError):
        ck._check(args[0].double(), *args[1:])


# ---------------------------------------------------------------------------
# fused_dopri5_attempt: plain version vs the JAX dopri5 step
# ---------------------------------------------------------------------------

def _jax_attempt(x, dt, z, ls, var, omega, phase, w, nu, rtol, atol):
    def f(t, xx):
        return _rhs_reference_jnp(xx, z, ls, var, omega, phase, w, nu)
    x5, err, _ = j_dopri5_step(f, 0.0, x, dt, f(0.0, x))
    return x5, err / (atol + rtol * jnp.maximum(jnp.abs(x), jnp.abs(x5)))


def test_fused_dopri5_attempt_plain_matches_jax_step():
    args = _rhs_inputs(seed=9)
    # a span long enough that the embedded error stands far above float32
    # rounding (at dt=0.05 it is ~1e-10 of |x|, i.e. pure rounding noise)
    dt = np.float32(0.5)
    x5_j, err_j = _jax_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    x5, err = ck.fused_dopri5_attempt(_t(args[0]), _t(dt), *map(_t, args[1:]),
                                      1e-6, 1e-6)
    _close(x5, x5_j, atol=1e-6)
    # the embedded error is a difference of near-equal stage sums: compare
    # it on the scale of its largest entry
    err_j = np.asarray(err_j)
    _close(err, err_j, rtol=1e-3, atol=1e-4 * float(np.max(np.abs(err_j))))
    assert not err.requires_grad


def test_fused_dopri5_attempt_cotangents_match_jax_vjp():
    args = _rhs_inputs(seed=10)
    dt = np.float32(0.05)
    g = np.random.default_rng(11).normal(size=(args[0].shape[0], 3)).astype(np.float32)
    _, pullback = jax.vjp(lambda *a: _jax_attempt(a[0], dt, *a[1:], 1e-6, 1e-6)[0],
                          *map(jnp.asarray, args))
    want = pullback(jnp.asarray(g))
    targs = [_t(a, grad=True) for a in args]
    x5, _ = ck.fused_dopri5_attempt(targs[0], _t(dt), *targs[1:], 1e-6, 1e-6)
    torch.autograd.backward(x5, _t(g))
    for name, a, b in zip(NAMES, targs, want):
        _close_grad(a.grad, b, msg=name)


# ---------------------------------------------------------------------------
# ops/ode.py and models/flow.py vs the JAX solver and flow
# ---------------------------------------------------------------------------

def test_odeint_dopri5_dense_output_matches_jax():
    """Multi-time grid: several accepted steps and a rejected one, Hermite
    dense output at interior times, exact landing on the end. The first step
    is given: the initial-step heuristic is compared on its own, since a
    one-ulp difference in it (pow rounds differently in XLA and numpy) moves
    every later step boundary."""
    args = _rhs_inputs(n=20, seed=12)
    ts = np.linspace(0.0, 1.5, 5).astype(np.float32)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(_t, args))

    def jf(t, xx):
        return _rhs_reference_jnp(xx, *jargs[1:])

    def tf(t, xx):
        return ck.fused_rhs_plain(xx, *targs[1:])

    want, jst = jodeint_dopri5(jf, jargs[0], jnp.asarray(ts), rtol=1e-5,
                               atol=1e-5, max_steps=64, first_step=0.05)
    got, st = odeint_dopri5(tf, targs[0], _t(ts), rtol=1e-5, atol=1e-5,
                            max_steps=64, first_step=0.05)
    _close(got, want, atol=2e-6)
    assert (st.num_accepted, st.num_attempted, st.num_covered) == (
        int(jst.num_accepted), int(jst.num_attempted), int(jst.num_covered))
    assert st.num_attempted > st.num_accepted > 2
    h_j = j_initial_step(jf, 0.0, jargs[0], jf(0.0, jargs[0]), 1.0, 1e-5, 1e-5)
    h_t = t_initial_step(tf, targs[0], tf(0.0, targs[0]), 1e-5, 1e-5)
    _close(h_t, h_j, rtol=1e-5)


@pytest.mark.parametrize("solver", ["rk4", "midpoint", "euler"])
def test_odeint_fixed_matches_jax(solver):
    """The plain solvers behind flow_forward for the fixed-step recipes."""
    args = _rhs_inputs(n=20, seed=16)
    ts = np.linspace(0.0, 0.6, 4).astype(np.float32)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(_t, args))
    want, jst = jodeint_fixed(lambda t, xx: _rhs_reference_jnp(xx, *jargs[1:]),
                              jargs[0], jnp.asarray(ts), solver=solver,
                              substeps=3)
    got, st = odeint_fixed(lambda t, xx: ck.fused_rhs_plain(xx, *targs[1:]),
                           targs[0], _t(ts), solver=solver, substeps=3)
    _close(got, want, atol=1e-5)
    assert st.num_rhs_evals == int(jst.num_rhs_evals)


@pytest.mark.parametrize("case", ["accepted", "rejected"])
def test_flow_forward_attempt_path_matches_jax(case):
    """The port's attempt branch (kernels=True; plain versions on the CPU)
    against the JAX flow on the CPU, which runs the bounded dopri5 scan. A
    whole-span attempt at tight tolerance over a long span rejects and takes
    the fallback seeded with the shrunk dt."""
    jp, tp = _gp_pair(m=8, d=3, seed=13)
    key = jax.random.PRNGKey(14)
    jdraw = jgp.draw_posterior(key, jp, 32)
    # the draw's leaves are inputs of their own, as on the JAX side
    tdraw = tgp.PosteriorDraw(*(a.detach().requires_grad_() for a in
                                tgp.draw_posterior(tp, *map(_t, _draw_noise(key, jp, 32)))))
    x0 = np.random.default_rng(15).normal(size=(30, 3)).astype(np.float32)
    span, tol = (0.05, 1e-6) if case == "accepted" else (1.0, 1e-7)
    ts = np.array([0.0, span], np.float32)
    kw = dict(solver="dopri5", first_step=FIRST_STEP_SPAN, max_steps=64,
              rtol=tol, atol=tol)

    jloss = lambda p, dr, x: jnp.sum(jnp.sin(
        jflow_forward(p, dr, x, jnp.asarray(ts), JSolverConfig(**kw))[0][:, -1]))
    want_x, jst = jflow_forward(jp, jdraw, jnp.asarray(x0), jnp.asarray(ts),
                                JSolverConfig(**kw))
    jg_p, jg_dr, jg_x = jax.grad(jloss, argnums=(0, 1, 2))(jp, jdraw, jnp.asarray(x0))

    tx0 = _t(x0, grad=True)
    got_x, st = flow_forward(tp, tdraw, tx0, _t(ts), SolverConfig(kernels=True, **kw))
    _close(got_x.detach(), want_x, rtol=1e-4, atol=1e-5)
    if case == "accepted":
        assert (st.num_rhs_evals, st.num_attempted) == (7, 1) == (
            int(jst.num_rhs_evals), int(jst.num_attempted))
    else:
        # the fallback re-evaluates f0 after the attempt (as the TPU path
        # does): one more rhs evaluation than the single JAX scan
        assert st.num_attempted == int(jst.num_attempted) > 1
        assert st.num_rhs_evals == int(jst.num_rhs_evals) + 1
        assert st.num_covered == int(jst.num_covered) == 2
    torch.sum(torch.sin(got_x[:, -1])).backward()
    _close_grad(tx0.grad, jg_x, msg="x0")
    _close_grad(tp.z.grad, jg_p.z, msg="z")
    _close_grad(tp.kernel.raw_lengthscales.grad, jg_p.kernel.raw_lengthscales,
                msg="raw_lengthscales")
    for name in tdraw._fields:
        _close_grad(getattr(tdraw, name).grad, getattr(jg_dr, name), msg=name)
