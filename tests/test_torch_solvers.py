"""The port's integrator layer against the JAX package, on the CPU: the
multistep and implicit solvers, the adaptive VCABM, the continuous adjoint,
rematerialized solves, `flow_inverse`, the `scale` preset's step, and the
first-order-only rule of the kernels' autograd.

Inputs are made with numpy from a seed and handed to both packages: a
Van der Pol-sized GP field (D=2, M=8, 16 RFF features, 3 sequences) whose
draw comes from the JAX package's key. The port's kernel wrappers run their
plain versions on CPU tensors. Tolerances: states rtol 1e-5 in float32;
gradients ("grads") rtol 1e-3 with atol 1e-3 * max|g| per leaf; the float64
VCABM at equal nfe, states rtol 1e-9; the adjoint against the port's own
taped solve on the shooting ELBO rtol 5e-2, atol 5e-4 (the class of
tests/test_adjoint.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.data.mocap import MocapDataset as JMocapDataset
from gpode_tpu.data.mocap import latent_to_data_projector as j_projector
from gpode_tpu.models import gp as jgp
from gpode_tpu.models.flow import SolverConfig as JSolverConfig
from gpode_tpu.models.flow import flow_forward as jflow_forward
from gpode_tpu.models.flow import flow_inverse as jflow_inverse
from gpode_tpu.models.init import initialize_kernel_parameters
from gpode_tpu.ops import ode as jode
from gpode_tpu.ops.kernels import RBFParams as JRBFParams
from gpode_tpu.train import bench_setup as jbench
from gpode_tpu.train import builders as jb

from gpode_tpu_torch.convert import params_from_numpy
from gpode_tpu_torch.models import flow as tflow
from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.shooting import StepNoise
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import ode as tode
from gpode_tpu_torch.ops.adjoint import odeint_adjoint
from gpode_tpu_torch.ops.kernels import RBFParams
from gpode_tpu_torch.train import bench_setup as tbench
from gpode_tpu_torch.train import builders as tb

torch.set_num_threads(1)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mocap")
D, M, S_RFF = 2, 8, 16
TS = np.linspace(0.0, 1.0, 4).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close_grad(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(np.max(np.abs(want))),
                               err_msg=msg)


@pytest.fixture(scope="module")
def field():
    """The same SVGP params and posterior draw in both packages, and three
    start states."""
    rng = np.random.default_rng(3)
    f32 = np.float32
    raw_ls = rng.normal(0.5, 0.1, size=(D, D)).astype(f32)
    raw_var = rng.normal(0.0, 0.1, size=(D,)).astype(f32)
    z = rng.normal(size=(M, D)).astype(f32)
    u_mean = (0.3 * rng.normal(size=(M, D))).astype(f32)
    tril = np.tril(0.05 * rng.normal(size=(D, M, M)) + 0.2 * np.eye(M))
    u_tril = tril[:, np.tril_indices(M)[0], np.tril_indices(M)[1]].astype(f32)
    jp = jgp.SVGPParams(JRBFParams(raw_ls, raw_var), z, u_mean, u_tril, None)
    key = jax.random.PRNGKey(4)
    k_w, k_omega, k_phase, k_u = jax.random.split(key, 4)
    noise = [np.asarray(a) for a in (
        jax.random.normal(k_w, (S_RFF, D)),
        jax.random.normal(k_omega, (D, S_RFF, D)),
        jax.random.uniform(k_phase, (1, S_RFF, D)),
        jax.random.normal(k_u, (M, D)))]
    jdraw = jgp.draw_posterior(key, jp, S_RFF)
    x0 = rng.normal(size=(3, D)).astype(f32)
    return dict(raw_ls=raw_ls, raw_var=raw_var, z=z, u_mean=u_mean,
                u_tril=u_tril, noise=noise, jp=jp, jdraw=jdraw, x0=x0)


def _port_field(fd):
    """Fresh port params, a draw whose leaves are inputs of their own (as on
    the JAX side), and x0 requiring grad."""
    tp = tgp.SVGPParams(RBFParams(_t(fd["raw_ls"]), _t(fd["raw_var"])),
                        _t(fd["z"]), _t(fd["u_mean"]), u_tril=_t(fd["u_tril"]))
    tdraw = tgp.PosteriorDraw(*(a.detach().requires_grad_() for a in
                                tgp.draw_posterior(tp, *map(_t, fd["noise"]))))
    return tp, tdraw, _t(fd["x0"], grad=True)


def _flow_pair(fd, kw, flow=(jflow_forward, tflow.flow_forward), ts=TS,
               port_kw=None, grads=True):
    """States, stats and the gradients of sum(sin(xs)) through both flows
    (with `grads`; the JAX side under one `jit`)."""
    jflow, pflow = flow

    def jloss(p, dr, x):
        xs, st = jflow(p, dr, x, jnp.asarray(ts), JSolverConfig(**kw))
        return jnp.sum(jnp.sin(xs)), (xs, st)

    jargs = (fd["jp"], fd["jdraw"], jnp.asarray(fd["x0"]))
    if grads:
        (_, (jx, jst)), (jgp_, jgd, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(*jargs)
    else:
        jx, jst = jloss(*jargs)[1]
    tp, tdraw, tx0 = _port_field(fd)
    xs, st = pflow(tp, tdraw, tx0, _t(ts), SolverConfig(**(port_kw or kw)))
    got = (xs.detach().numpy(), tuple(st))
    want = (np.asarray(jx), tuple(int(v) for v in jst))
    if not grads:
        return got, want, {}
    torch.sum(torch.sin(xs)).backward()
    grads = {"x0": (tx0.grad, jgx), "z": (tp.z.grad, jgp_.z),
             "raw_lengthscales": (tp.kernel.raw_lengthscales.grad,
                                  jgp_.kernel.raw_lengthscales),
             "raw_variance": (tp.kernel.raw_variance.grad,
                              jgp_.kernel.raw_variance)}
    grads.update({n: (getattr(tdraw, n).grad, getattr(jgd, n))
                  for n in tdraw._fields})
    return got, want, grads


def _check_pair(got, want, grads, rtol=1e-5, stats=True):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want[0]))))
    if stats:
        assert got[1] == want[1]
    for name, (g, w) in grads.items():
        _close_grad(g.numpy(), w, msg=name)


# ---------------------------------------------------------------------------
# ops/ode.py: the fixed multistep and implicit solvers, the full dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["explicit_adams", "implicit_adams", "bdf"])
def test_fixed_multistep_solvers_match_jax(field, solver):
    """Through `flow_forward` on the plain rhs: states rtol 1e-5, the
    solver's counts equal, and grads (BDF differentiates its Newton
    Jacobian a second time)."""
    _check_pair(*_flow_pair(field, dict(solver=solver, ts_dense_scale=3)))


@pytest.mark.parametrize("solver", jode.SOLVERS)
def test_odeint_takes_every_solver_name(solver):
    """All nine names of the JAX package, on a linear field: the same
    states (rtol 1e-5) and counts, the substep floors included."""
    a = np.array([[-0.5, 0.3], [-0.2, -0.7]], np.float32)
    x0 = np.array([[1.0, -1.0], [0.3, 0.8]], np.float32)
    ts = np.linspace(0.0, 1.0, 3).astype(np.float32)
    kw = dict(solver=solver, rtol=1e-6, atol=1e-6, substeps=1, max_steps=64)
    jx, jst = jode.odeint(lambda t, x: x @ jnp.asarray(a).T, jnp.asarray(x0),
                          jnp.asarray(ts), **kw)
    tx, st = tode.odeint(lambda t, x: x @ _t(a).T, _t(x0), _t(ts), **kw)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    if solver not in ("dopri5", "adams"):  # float32 controllers may differ
        assert tuple(st) == tuple(int(v) for v in jst)
    assert tode.SOLVERS == jode.SOLVERS == tuple(tb.SOLVERS)
    with pytest.raises(ValueError):
        tode.odeint(lambda t, x: x, _t(x0), _t(ts), solver="nope")


def _fhn_t(t, y):
    v, w = y[..., 0], y[..., 1]
    return torch.stack([v - v ** 3 / 3.0 - w + 0.5,
                        0.08 * (v + 0.7 - 0.8 * w)], dim=-1)


def _fhn_j(t, y):
    v, w = y[..., 0], y[..., 1]
    return jnp.stack([v - v ** 3 / 3.0 - w + 0.5,
                      0.08 * (v + 0.7 - 0.8 * w)], axis=-1)


def _vdp(stack, mu=0.5):
    def f(t, y):
        x, v = y[..., 0], y[..., 1]
        return stack([v, -x + mu * v * (1 - x ** 2)], -1)
    return f


@pytest.mark.parametrize("system,y0,t_end", [("vdp", [-1.5, 2.5], 7.0),
                                             ("fhn", [-1.0, 1.0], 20.0)])
def test_vcabm_float64_takes_the_jax_decisions(system, y0, t_end):
    """The problems of tests/test_ode.py's VCABM parity test, in float64 at
    tolerances 1e-4, 1e-6 and 1e-8 with the first step pinned: the same
    rhs-evaluation, accepted and attempted counts as the JAX solver under
    x64, and states rtol 1e-9."""
    ft = _vdp(torch.stack) if system == "vdp" else _fhn_t
    fj = _vdp(jnp.stack) if system == "vdp" else _fhn_j
    for tol in (1e-4, 1e-6, 1e-8):
        kw = dict(rtol=tol, atol=tol, max_steps=4096, first_step=1e-3 * t_end)
        jax.config.update("jax_enable_x64", True)
        try:
            jx, jst = jode.odeint_adams_adaptive(
                fj, jnp.asarray([y0], dtype=jnp.float64),
                jnp.asarray([0.0, t_end], dtype=jnp.float64), **kw)
            jx, jst = np.asarray(jx), tuple(int(v) for v in jst)
        finally:
            jax.config.update("jax_enable_x64", False)
        tx, st = tode.odeint_adams_adaptive(
            ft, torch.tensor([y0], dtype=torch.float64),
            torch.tensor([0.0, t_end], dtype=torch.float64), **kw)
        assert tuple(st) == jst, (system, tol)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-9, atol=1e-12)
    assert tode._gamma_star_table(12) == jode._gamma_star_table(12)


def test_vcabm_float32_matches_jax():
    """The VCABM in float32 (states rtol 1e-4; the float32 controllers may
    round a decision apart): interior observation times from dense output,
    decreasing ts (from inside the limit cycle, where the reversed field
    stays bounded), and an
    exhausted budget falling back to the last state, as in JAX."""
    f = _vdp(torch.stack)
    fj = _vdp(jnp.stack)
    y0 = np.array([[0.5, 0.2]], np.float32)  # inside the limit cycle
    for ts, steps in ((np.linspace(0.0, 3.0, 7), 256),
                      (np.linspace(1.0, 0.0, 5), 256),
                      (np.linspace(0.0, 3.0, 4), 6)):
        ts = ts.astype(np.float32)
        kw = dict(rtol=1e-5, atol=1e-6, max_steps=steps, first_step=0.01)
        jx, jst = jode.odeint_adams_adaptive(fj, jnp.asarray(y0),
                                             jnp.asarray(ts), **kw)
        tx, st = tode.odeint_adams_adaptive(f, _t(y0), _t(ts), **kw)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                                   atol=1e-5)
        assert st.num_covered == int(jst.num_covered)
    assert st.num_covered < len(ts)


# ---------------------------------------------------------------------------
# ops/adjoint.py and the flow's adjoint branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels,solver", [(False, "dopri5"), (True, "rk4")],
                         ids=["plain_dopri5", "fused_rhs_rk4"])
def test_adjoint_matches_jax(field, kernels, solver):
    """`use_adjoint` through `flow_forward` (4 observations; dopri5 with
    Hairer's first step, or rk4 at 2 substeps): forward rtol 1e-5, the
    forward solve's counts, grads. kernels=True evaluates the field through
    `fused_rhs` (its plain version here, whose sums run in another order:
    with a fixed-step solver no controller decision can part) on the
    adjoint's detached leaves."""
    kw = dict(solver=solver, use_adjoint=True, rtol=1e-6, atol=1e-6,
              ts_dense_scale=3)
    _check_pair(*_flow_pair(field, kw, port_kw=dict(kw, kernels=kernels)))


def test_odeint_adjoint_on_a_linear_field_matches_jax():
    """`ops/adjoint.odeint_adjoint` itself against the JAX one, and against
    the port's taped solve (tests/test_adjoint.py's problem)."""
    from gpode_tpu.ops.adjoint import odeint_adjoint as j_odeint_adjoint
    a = np.array([[-0.5, 0.3], [-0.2, -0.7]], np.float32)
    x0 = np.array([[1.0, -1.0], [0.3, 0.8]], np.float32)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)

    def jloss(p, x):
        xs, _ = j_odeint_adjoint(lambda q, t, y: y @ q["A"].T, p, x,
                                 jnp.asarray(ts), "dopri5", 1e-7, 1e-9, 1, 128)
        return jnp.sum((xs - 1.0) ** 2)

    jga, jgx = jax.grad(jloss, argnums=(0, 1))({"A": jnp.asarray(a)},
                                              jnp.asarray(x0))
    ta, tx0 = _t(a, grad=True), _t(x0, grad=True)
    xs, st = odeint_adjoint(lambda p, t, y: y @ p[0].T, (ta,), tx0, _t(ts),
                            solver="dopri5", rtol=1e-7, atol=1e-9,
                            max_steps=128)
    assert st.num_rhs_evals > 0
    torch.sum((xs - 1.0) ** 2).backward()
    _close_grad(ta.grad.numpy(), jga["A"], "A")
    _close_grad(tx0.grad.numpy(), jgx, "x0")
    ta2, tx2 = _t(a, grad=True), _t(x0, grad=True)
    xs2, _ = tode.odeint(lambda t, y: y @ ta2.T, tx2, _t(ts), rtol=1e-7,
                         atol=1e-9, max_steps=128)
    torch.sum((xs2 - 1.0) ** 2).backward()
    np.testing.assert_allclose(ta.grad.numpy(), ta2.grad.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_adjoint_shooting_elbo_matches_the_taped_solve():
    """tests/test_adjoint.py:115's config on the port: the shooting ELBO
    with `use_adjoint` against the taped solve, loss rtol 1e-5, every
    gradient leaf rtol 5e-2, atol 5e-4."""
    base = tb.ModelArgs(num_inducing=8, num_features=16, solver="rk4",
                        ts_dense_scale=2, max_steps=8, num_samples=2)
    rng = np.random.default_rng(0)
    ys = torch.tensor(rng.normal(size=(2, 6, 2)).astype(np.float32) * 0.5)
    ts = torch.linspace(0.0, 1.0, 6)
    gen = torch.Generator().manual_seed(0)
    params = tb.build_shooting(gen, base, ys.numpy(), device="cpu")
    noise = tb.shooting_noise_fn(base)(params, torch.Generator().manual_seed(3))
    results = []
    for args in (base, dataclasses.replace(base, use_adjoint=True)):
        params.zero_grad()
        loss, _ = tb.shooting_loss_fn(args)(params, noise, ys, ts)
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.clone() for n, p in
                                      params.named_parameters()}))
    (lt, gt), (la, ga) = results
    np.testing.assert_allclose(la, lt, rtol=1e-5)
    for name in gt:
        np.testing.assert_allclose(ga[name].numpy(), gt[name].numpy(),
                                   rtol=5e-2, atol=5e-4, err_msg=name)


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

REMAT_CASES = {
    "dopri5": dict(solver="dopri5", rtol=1e-6, atol=1e-6),
    "explicit_adams": dict(solver="explicit_adams", ts_dense_scale=3),
    "adams": dict(solver="adams", rtol=1e-6, atol=1e-6),
    "bdf": dict(solver="bdf", ts_dense_scale=3),
}


@pytest.mark.parametrize("case", list(REMAT_CASES) + ["batched"])
def test_remat_equals_the_taped_solve(field, case):
    """`remat=True` against `remat=False` on the same inputs: loss equal,
    every gradient rtol 1e-6 (the backward recomputes each evaluation)."""
    kw = REMAT_CASES.get(case, REMAT_CASES["dopri5"])
    out = []
    for remat in (False, True):
        tp, tdraw, tx0 = _port_field(field)
        cfg = SolverConfig(remat=remat, **kw)
        if case == "batched":
            draws = tgp.PosteriorDraw(*(torch.stack([leaf, 0.9 * leaf])
                                        for leaf in tdraw))
            xs, _ = tflow.flow_forward_batched(
                tp, draws, torch.stack([tx0, 1.1 * tx0]), _t(TS), cfg)
        else:
            xs, _ = tflow.flow_forward(tp, tdraw, tx0, _t(TS), cfg)
        loss = torch.sum(torch.sin(xs))
        loss.backward()
        leaves = [tx0, *tp.parameters(), *tdraw]
        out.append((float(loss), [torch.zeros_like(t) if t.grad is None
                                  else t.grad for t in leaves]))
    (l0, g0), (l1, g1) = out
    assert l1 == l0
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


def test_rejected_attempt_fallback_rematerializes_its_rhs(field, monkeypatch):
    """A whole-span attempt that rejects: the fallback's rhs runs under a
    checkpoint whatever `remat` says, and the result equals the fallback
    without one (loss and gradients)."""
    calls = []
    original = tflow._rematerialized

    def counting(rhs):
        calls.append(rhs)
        return original(rhs)

    kw = dict(solver="dopri5", first_step=tode.FIRST_STEP_SPAN, rtol=1e-7,
              atol=1e-7, max_steps=64, kernels=True)
    ts = _t(np.array([0.0, 1.0], np.float32))
    out = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(tflow, "_rematerialized", counting)
        else:
            monkeypatch.setattr(tflow, "_rematerialized", lambda rhs: rhs)
        tp, tdraw, tx0 = _port_field(field)
        xs, st = tflow.flow_forward(tp, tdraw, tx0, ts, SolverConfig(**kw))
        assert st.num_attempted > 1   # the attempt was rejected
        torch.sum(torch.sin(xs)).backward()
        out.append((xs.detach(), tx0.grad, tp.z.grad))
    assert len(calls) == 1
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# flow_inverse, the BDF pin, the first-order rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["dopri5", "rk4"])
def test_flow_inverse_matches_jax(field, solver):
    """States at flip(ts) (rtol 1e-5) and counts."""
    kw = dict(solver=solver, ts_dense_scale=3, rtol=1e-6, atol=1e-6)
    _check_pair(*_flow_pair(field, kw, flow=(jflow_inverse,
                                             tflow.flow_inverse), grads=False))


@pytest.mark.parametrize("use_adjoint", [False, True],
                         ids=["taped", "adjoint"])
def test_bdf_takes_the_plain_rhs(field, monkeypatch, use_adjoint):
    """BDF never reaches `fused_rhs`, even with kernels=True; the other
    solvers do."""
    calls = []
    original = tgp.fused_rhs

    def counting(*a):
        calls.append(1)
        return original(*a)

    monkeypatch.setattr(tgp, "fused_rhs", counting)
    for solver, expect in (("bdf", False), ("explicit_adams", True)):
        calls.clear()
        tp, tdraw, tx0 = _port_field(field)
        cfg = SolverConfig(solver=solver, kernels=True, use_adjoint=use_adjoint)
        # one interval: the adjoint's BDF Newton builds the Jacobian of the
        # whole augmented vector, one pullback per entry
        xs, _ = tflow.flow_forward(tp, tdraw, tx0, _t(TS[:2]), cfg)
        torch.sum(xs).backward()
        assert bool(calls) is expect, solver
        assert tflow._kernels_active(cfg, tp, 3000, S_RFF, "fused_rhs") is expect


def _fake_launchers(monkeypatch):
    """Run the kernel `Function`s on CPU tensors: the CUDA checks pass and
    the launchers return zeros of the right shapes."""
    monkeypatch.setattr(ck, "_check", lambda x, *a, **k: (
        x.shape[-1], a[-1].shape[0], a[-1].shape[1], a[-2].shape[0]))
    monkeypatch.setattr(ck, "_check_segment", lambda x0, dt, *a: (
        (x0.shape[-1], a[-2].shape[0], a[-2].shape[1], a[-3].shape[0]), dt))
    monkeypatch.setattr(ck, "_sms", lambda dev: 132)

    def cots(x, ops, din, d, m, s):
        return (torch.zeros_like(x), torch.zeros(m, din), torch.zeros(d, din),
                torch.zeros(d), torch.zeros(din, s, d), torch.zeros(1, s, d),
                torch.zeros(s, d), torch.zeros(d, m))

    monkeypatch.setattr(ck, "_launch_rhs_fwd", lambda x, ops, din, d, m, s:
                        torch.zeros(x.shape[0], d))
    monkeypatch.setattr(ck, "_launch_rhs_bwd", lambda x, g, ops, *dims:
                        cots(x, ops, *dims))
    monkeypatch.setattr(ck, "_launch_dp_fwd", lambda x0, dt, r, a, ops, din,
                        d, m, s: (torch.zeros(x0.shape[0], d),
                                  torch.zeros(x0.shape[0], d),
                                  torch.zeros(6, x0.shape[0], din)))
    monkeypatch.setattr(ck, "_launch_dp_bwd", lambda xs, g, dt, ops, *dims:
                        cots(xs[0], ops, *dims))
    monkeypatch.setattr(ck, "_launch_rk4_fwd", lambda x0, dt, n, ops, din, d,
                        m, s: (torch.zeros(x0.shape[0], d),
                               torch.zeros(4 * n, x0.shape[0], din)))
    monkeypatch.setattr(ck, "_launch_rk4_bwd", lambda xs, g, dt, n, ops, *dims:
                        cots(xs[0], ops, *dims))


@pytest.mark.parametrize("kernel", ["fused_rhs", "dopri5_attempt",
                                    "rk4_segment", "adjoint"])
def test_double_backward_through_a_kernel_raises(monkeypatch, kernel):
    """A backward taken with `create_graph` through a kernel's autograd
    rule raises (its second derivative would be wrong, not an error), even
    when the incoming cotangent needs no gradient (a Newton Jacobian's unit
    vectors); a first-order backward runs."""
    _fake_launchers(monkeypatch)
    rng = np.random.default_rng(0)
    shapes = [(40, 3), (8, 3), (3, 3), (3,), (3, 16, 3), (1, 16, 3),
              (16, 3), (3, 8)]
    ops = [_t(rng.uniform(0.5, 1.0, size=s).astype(np.float32), grad=True)
           for s in shapes]
    dt = _t(np.array([0.1], np.float32))
    if kernel == "fused_rhs":
        out = ck._FusedRhsFn.apply(*ops, True)
    elif kernel == "dopri5_attempt":
        out = ck._FusedDopri5AttemptFn.apply(ops[0], dt, *ops[1:], 1e-6,
                                             1e-6, True)[0]
    elif kernel == "rk4_segment":
        out = ck._FusedRk4SegmentFn.apply(ops[0], dt, *ops[1:], 1, True)
    else:
        x0 = ops[0]
        out, _ = odeint_adjoint(lambda p, t, y: torch.tanh(y * p[0]), ops[3:4],
                                x0, _t(np.array([0.0, 0.1], np.float32)),
                                solver="rk4")
    g = torch.ones_like(out)
    torch.autograd.grad(out, ops[0], g, retain_graph=True)
    with pytest.raises(RuntimeError, match="first order"):
        torch.autograd.grad(out, ops[0], g, create_graph=True)


# ---------------------------------------------------------------------------
# the `scale` preset
# ---------------------------------------------------------------------------

def test_scale_shape_takes_the_attempt_kernels():
    """At the `scale` step's 19200 segment rows, Din=D=5, M=256, S=256 both
    directions of the attempt kernel and of `fused_rhs` take the shape, and
    the backward's per-block slabs stay bounded (the row blocks grow, not
    their count)."""
    n, dim, m, s = 32 * 6 * 100, 5, 256, 256
    assert ck.kernel_refusal("dopri5_attempt", n, dim, dim, m, s) is None
    assert ck.kernel_refusal("fused_rhs", n, dim, dim, m, s) is None
    at_3000 = ck.segment_bwd_geometry(3000, dim, dim, m, s, 6, 132)
    geo = ck.segment_bwd_geometry(n, dim, dim, m, s, 6, 132)
    assert geo.blocks <= at_3000.blocks
    assert geo.blocks * geo.rows_per_block >= n
    assert 4 * (geo.part_main_floats + geo.part_dz_floats) < 20 * 2**20
    fwd = ck.segment_fwd_geometry(n, dim, dim, m, s, 6)
    assert fwd.blocks * fwd.rt >= n


def _step_noise(key, params, num_samples, num_features):
    """The noise the JAX shooting step draws from `key`, as float64
    tensors."""
    k_draw, k_ss = jax.random.split(key)
    k0, ks = jax.random.split(k_ss)
    n, t1, d = params.states.mean.shape
    m, din = params.gp.z.shape
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)
    return StepNoise(*(torch.tensor(np.asarray(a, np.float64)) for a in (
        jax.random.normal(k_w, (num_features, d)),
        jax.random.normal(k_omega, (din, num_features, d)),
        jax.random.uniform(k_phase, (1, num_features, d)),
        jax.random.normal(k_u, (m, d)),
        jax.random.normal(k0, (num_samples, n, d)),
        jax.random.normal(ks, (num_samples, n, t1, d)))))


def test_scale_preset_shooting_elbo_matches_jax():
    """The `scale` preset's flags (M=256, 256 features, 32 draws, dopri5
    with a whole-span first step, remat) on MoCap-09 cut to 2 sequences x
    20 steps (1280 segment rows: the attempt branch, its plain version
    here), against the JAX step on the same noise: the five ELBO terms rtol
    1e-4, the solver's counts, and every gradient leaf. In float64: the
    32-draw mean's raw-variance gradient cancels to 1e-4 of its parts, and
    there the JAX package's float32 sums land 2.5e-4 from the float64 value
    (the port's 5e-5), past the gradients' atol of 1.4e-4."""
    want_args = jbench.preset_model_args("scale")
    got_args = tbench.preset_model_args("scale")
    data_pca = JMocapDataset(data_path=DATA_DIR, subject="09",
                             pca_components=5, data_normalize=False,
                             pca_normalize=True, seqlen=20)
    data_full = JMocapDataset(data_path=DATA_DIR, subject="09",
                              pca_components=-1, data_normalize=False,
                              pca_normalize=False, seqlen=20)
    ys_pca, ys = data_pca.trn.ys[:2], data_full.trn.ys[:2]
    params = jb.build_shooting(jax.random.PRNGKey(0), want_args, ys_pca,
                               projector=j_projector(data_pca), full_dim=50)
    # the kernel init; Z stays at its random init (k-means cannot place 256
    # centers among the cut data's 40 points)
    params = params._replace(gp=initialize_kernel_parameters(params.gp))
    ts = data_pca.trn.ts
    key = jax.random.PRNGKey(3)
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    flat = {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}
    tparams = params_from_numpy(flat, got_args, device="cpu").double()
    jax.config.update("jax_enable_x64", True)
    try:
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        (_, jterms), jgrads = jax.jit(jax.value_and_grad(
            jb.shooting_loss_fn(want_args), has_aux=True))(
                j64, key, jnp.asarray(ys, jnp.float64),
                jnp.asarray(ts, jnp.float64))
        assert jterms.loss.dtype == jnp.float64
        noise = _step_noise(key, j64, got_args.num_samples,
                            got_args.num_features)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert noise.x0.shape[0] * 2 * 20 == 1280
    loss, terms = tb.shooting_loss_fn(got_args)(
        tparams, noise, torch.tensor(ys, dtype=torch.float64),
        torch.tensor(ts, dtype=torch.float64))
    loss.backward()
    for name in ("loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl"):
        np.testing.assert_allclose(float(getattr(terms, name).detach()),
                                   float(getattr(jterms, name)), rtol=1e-4,
                                   err_msg=name)
    assert (terms.nfe, terms.natt) == (int(jterms.nfe), int(jterms.natt))
    gleaves, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    got = dict(tparams.named_parameters())
    for path, g in gleaves:
        name = ".".join(k.name for k in path)
        _close_grad(got[name].grad.numpy(), np.asarray(g), msg=name)
