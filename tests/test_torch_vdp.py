"""The port's vanilla GPODE on Van der Pol against the JAX package, on the
CPU: the simulated data, the vector-field posterior `conditional`, the RFF
scale toggle, one train step (loss, ELBO terms, solver counts, every gradient
leaf) and the 30-step golden loss trajectory of tests/test_golden.py.

JAX params are flattened to {dotted path: array} and loaded with
`gpode_params_from_numpy`; the noise a JAX step draws from its key is rebuilt
with the same splits (`trainer.make_step_bodies` -> `gpode.elbo_loss` ->
`gp.draw_posterior` / `states.sample_initial_state`) and fed to the port as a
`GPODEStepNoise`.

Tolerances: data rtol 1e-6; conditional rtol 1e-4, atol 1e-6; loss and ELBO
terms rtol 1e-4; gradients rtol 1e-3 with atol 1e-3 * max|g| per leaf; the
golden trajectory at tests/test_golden.py's own tolerances.

Both packages initialise inducing points with the native host library's
k-means where it loads, else with scipy's `kmeans2`, and the two branches
start different problems. The goldens were recorded on the native branch,
so the golden test loads the JAX package's library race-free first
(`test_torch_native.load_jax_native`); the scipy-branch test holds the same
30-step run against the JAX package with both libraries forced away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpode_tpu.data.vanderpol import VanderPol as JVanderPol
from gpode_tpu.data.vanderpol import VanderPolNonUniform as JVanderPolNonUniform
from gpode_tpu.models import gp as jgp
from gpode_tpu.models import gpode as jgpode
from gpode_tpu.models.init import (initialize_inducing,
                                   initialize_kernel_parameters)
from gpode_tpu.train import builders as jb
from gpode_tpu.train.trainer import make_train_step as j_make_train_step
from gpode_tpu.utils import native

from gpode_tpu_torch.convert import gpode_params_from_numpy, params_to_numpy
from gpode_tpu_torch.data.mocap import ProjectorArrays
from gpode_tpu_torch.data.vanderpol import VanderPol, VanderPolNonUniform
from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.models import gpode as tgpode
from gpode_tpu_torch.models.likelihoods import (GaussianLikelihood,
                                                ProjectedGaussianLikelihood)
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import trainer as tt

from test_torch_native import load_jax_native, same_branch

torch.set_num_threads(1)

GOLDEN_FIRST = 10.856404304504395
GOLDEN_ITER10 = 6.6017255783081055
GOLDEN_LAST = 5.202798843383789
TERMS = ("loss", "observ_nll", "x0_kl", "inducing_kl")
VDP = dict(s_train=25, t_train=7.0, noise_var=0.05,
           x0=np.array([[-1.5, 2.5]]), mu=0.5)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _t(a):
    return torch.tensor(np.asarray(a))


def _to_port(jparams) -> tgpode.GPODEParams:
    return gpode_params_from_numpy(_flat(jparams), device="cpu")


def _step_noise(sub, jparams, num_features) -> tgpode.GPODEStepNoise:
    """The noise `gpode.elbo_loss(sub, ...)` draws, as tensors."""
    k_draw, k_x0 = jax.random.split(sub)
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)
    m, din = jparams.gp.z.shape
    n, d = jparams.x0.mean.shape
    f = num_features
    return tgpode.GPODEStepNoise(
        rff_weights=_t(jax.random.normal(k_w, (f, d))),
        rff_freq=_t(jax.random.normal(k_omega, (din, f, d))),
        rff_phase=_t(jax.random.uniform(k_phase, (1, f, d))),
        inducing=_t(jax.random.normal(k_u, (m, d))),
        x0=_t(jax.random.normal(k_x0, (1, n, d))[0]))


@pytest.fixture(scope="module")
def data():
    load_jax_native()
    return JVanderPol(**VDP)


def _jax_problem(data, args, seed=121):
    params = jb.build_gpode(jax.random.PRNGKey(seed), args, data.trn.ys)
    params = params._replace(gp=initialize_kernel_parameters(params.gp))
    return params._replace(gp=initialize_inducing(
        params.gp, data.trn.ys, float(data.trn.ts.max()), 1e0,
        rng=np.random.RandomState(seed)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "nonuniform"])
def test_vanderpol_data_matches_jax(kind, monkeypatch):
    # both packages on the scipy (LSODA) branch (the native branch is held
    # in tests/test_torch_native.py)
    same_branch(monkeypatch, False)
    if kind == "uniform":
        kw = dict(s_train=25, t_train=7.0, s_test=50, t_test=14.0,
                  noise_var=0.05)
        got, want = VanderPol(**kw), JVanderPol(**kw)
        splits = ("trn", "tst", "tst_new_x0")
        np.testing.assert_allclose(got.new_x0, want.new_x0, rtol=1e-6)
    else:
        kw = dict(s_train=25, t_train=7.0, s_test=25, t_test=14.0,
                  noise_var=0.05)
        got, want = VanderPolNonUniform(**kw), JVanderPolNonUniform(**kw)
        splits = ("trn", "tst")
    for name in splits:
        a, b = getattr(got, name), getattr(want, name)
        assert a.ys.dtype == np.float32 and a.ys.shape == b.ys.shape
        np.testing.assert_allclose(a.ys, b.ys, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(a.ts, b.ts, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.f([0.3, -1.2]), want.f([0.3, -1.2]))
    assert (got.xlim, got.ylim, got.mu) == (want.xlim, want.ylim, want.mu)


# ---------------------------------------------------------------------------
# models/gp.py: conditional, RFF scale toggle
# ---------------------------------------------------------------------------

def _gp_pair(dimwise, q_diag, m=9, din=2, d=2, seed=3):
    """A JAX SVGP with non-trivial posterior scale and its port copy."""
    rng = np.random.default_rng(seed)
    jp = jgp.init_svgp(jax.random.PRNGKey(seed), din, d, m, dimwise=dimwise,
                       q_diag=q_diag)
    if q_diag:
        jp = jp._replace(u_diag_raw=jnp.asarray(
            rng.normal(size=jp.u_diag_raw.shape), jnp.float32))
    else:
        jp = jp._replace(u_tril=jnp.asarray(
            0.3 * rng.normal(size=jp.u_tril.shape), jnp.float32))
    kern = jp.kernel._replace(
        raw_lengthscales=jnp.asarray(
            rng.uniform(0.2, 1.0, size=jp.kernel.raw_lengthscales.shape),
            jnp.float32),
        raw_variance=jnp.asarray(
            rng.uniform(-0.5, 0.5, size=jp.kernel.raw_variance.shape),
            jnp.float32))
    jp = jp._replace(kernel=kern)
    flat = {f"gp.{k}": v for k, v in _flat(jp).items()}
    flat.update({"x0.mean": np.zeros((1, d), np.float32),
                 "x0.tril_packed": np.zeros((1, d * (d + 1) // 2), np.float32),
                 "likelihood.raw_variance": np.zeros((d,), np.float32)})
    return jp, gpode_params_from_numpy(flat, device="cpu").gp


@pytest.mark.parametrize("full_cov", [False, True], ids=["diag", "full_cov"])
@pytest.mark.parametrize("q_diag", [False, True], ids=["full_rank", "q_diag"])
@pytest.mark.parametrize("dimwise", [True, False], ids=["dimwise", "shared"])
def test_conditional_matches_jax(dimwise, q_diag, full_cov):
    jp, tp = _gp_pair(dimwise, q_diag)
    x = np.random.default_rng(5).normal(size=(31, 2)).astype(np.float32)
    want_mean, want_var = jgp.conditional(jp, jnp.asarray(x), full_cov=full_cov)
    before = ck.LAUNCHES["rbf_gram"]
    with torch.no_grad():   # the evaluation route: K(Z, x) from rbf_gram
        mean, var = tgp.conditional(tp, _t(x), full_cov=full_cov)
    assert ck.LAUNCHES["rbf_gram"] == before  # CPU tensors launch nothing
    np.testing.assert_allclose(mean, want_mean, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(var, want_var, rtol=1e-4, atol=1e-6)
    assert var.shape == ((2, 31, 31) if full_cov else (31, 2))
    # with gradients wanted the Gram comes from rbf_K, and agrees
    mean_g, var_g = tgp.conditional(tp, _t(x), full_cov=full_cov)
    assert mean_g.requires_grad
    np.testing.assert_allclose(mean_g.detach(), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var_g.detach(), var, rtol=1e-5, atol=1e-6)


def test_conditional_takes_rbf_gram_only_where_no_gradient_is_needed(monkeypatch):
    _, tp = _gp_pair(True, False)
    _, tp_shared = _gp_pair(False, False)
    x = torch.randn(7, 2, generator=torch.Generator().manual_seed(0))
    calls = []
    real = tgp.rbf_gram
    monkeypatch.setattr(tgp, "rbf_gram",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        tgp.conditional(tp, x)
        assert len(calls) == 1
        tgp.conditional(tp_shared, x)           # not dimwise: rbf_K
        assert len(calls) == 1
    tgp.conditional(tp, x)                      # parameters require grad
    assert len(calls) == 1
    for p in tp.parameters():
        p.requires_grad_(False)
    tgp.conditional(tp, x)                      # nothing requires grad
    assert len(calls) == 2
    tgp.conditional(tp, x.clone().requires_grad_())
    assert len(calls) == 2


@pytest.mark.parametrize("reference_scale", [False, True],
                         ids=["canonical", "reference"])
def test_rff_reference_scale_matches_jax(reference_scale):
    jp, tp = _gp_pair(True, False)
    rng = np.random.default_rng(2)
    s = 16
    omega = rng.normal(size=(2, s, 2)).astype(np.float32)
    phase = rng.uniform(0, 6.28, size=(1, s, 2)).astype(np.float32)
    weights = rng.normal(size=(s, 2)).astype(np.float32)
    x = rng.normal(size=(11, 2)).astype(np.float32)
    jgp.set_rff_reference_scale(reference_scale)
    tgp.set_rff_reference_scale(reference_scale)
    try:
        want = jgp.rff_eval(jp, *map(jnp.asarray, (omega, phase, weights, x)))
        got = tgp.rff_eval(tp, *map(_t, (omega, phase, weights, x)))
        kw = tgp.kernel_rff_weights(_t(weights))
        want_kw = jgp.kernel_rff_weights(jnp.asarray(weights))
    finally:
        jgp.set_rff_reference_scale(False)
        tgp.set_rff_reference_scale(False)
    np.testing.assert_allclose(got.detach(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(kw, want_kw, rtol=1e-6)
    canonical = tgp.rff_eval(tp, *map(_t, (omega, phase, weights, x)))
    ratio = float((got / canonical).detach().mean())
    assert ratio == pytest.approx(np.sqrt(0.5) if reference_scale else 1.0,
                                  rel=1e-5)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "rk4": dict(solver="rk4", ts_dense_scale=2),
    "dopri5": dict(solver="dopri5", max_steps=64),
    "rk4_obs_mask": dict(solver="rk4", ts_dense_scale=2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step0_loss_terms_and_gradients_match_jax(data, case):
    kw = dict(num_inducing=8, num_features=32, dimwise=True, **STEP_CASES[case])
    j_args, t_args = jb.ModelArgs(**kw), tb.ModelArgs(**kw)
    jparams = _jax_problem(data, j_args)
    ys, ts = data.trn.ys, data.trn.ts
    mask = None
    if case.endswith("obs_mask"):
        mask = (np.arange(ys.shape[1]) % 3 != 1).astype(np.float32)[None]
    sub = jax.random.PRNGKey(5)
    cfg = j_args.solver_config()

    def j_loss(p):
        return jgpode.elbo_loss(sub, p, jnp.asarray(ys), jnp.asarray(ts), cfg,
                                j_args.num_features,
                                None if mask is None else jnp.asarray(mask))

    (_, jterms), jgrads = jax.value_and_grad(j_loss, has_aux=True)(jparams)

    tparams = _to_port(jparams)
    noise = _step_noise(sub, jparams, t_args.num_features)
    if mask is None:
        loss, terms = tb.gpode_loss_fn(t_args)(tparams, noise, _t(ys), _t(ts))
    else:
        loss, terms = tgpode.elbo_loss(tparams, noise, _t(ys), _t(ts),
                                       t_args.solver_config(), _t(mask))
    loss.backward()
    for name in TERMS:
        np.testing.assert_allclose(float(getattr(terms, name).detach()),
                                   float(getattr(jterms, name)), rtol=1e-4,
                                   err_msg=name)
    assert (terms.nfe, terms.natt, terms.ncov) == (
        int(jterms.nfe), int(jterms.natt), int(jterms.ncov))
    assert terms.ncov == ys.shape[1] + 1     # the 26-point grid was covered
    want = _flat(jgrads)
    got = dict(tparams.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * float(np.max(np.abs(g))),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the golden trajectory
# ---------------------------------------------------------------------------

def _loss_trajectories(data):
    """tests/test_golden.py's 30-step run through both packages with the
    same params and noise: (port losses, JAX losses, port params, JAX
    params)."""
    kw = dict(num_inducing=16, num_features=256, dimwise=True, solver="rk4",
              ts_dense_scale=2)
    j_args, t_args = jb.ModelArgs(**kw), tb.ModelArgs(**kw)
    jgp.set_rff_reference_scale(True)
    tgp.set_rff_reference_scale(True)
    try:
        jparams = _jax_problem(data, j_args)
        tparams = _to_port(jparams)
        ys, ts = data.trn.ys, data.trn.ts
        opt = optax.adam(5e-3)
        jstep = j_make_train_step(jb.gpode_loss_fn(j_args), opt)
        opt_state = opt.init(jparams)
        tstep = tt.make_train_step(tb.gpode_loss_fn(t_args), tparams,
                                   tt.default_optimizer(tparams, 5e-3))
        key = jax.random.PRNGKey(121)
        tys, tts = _t(ys), _t(ts)
        j_losses, t_losses = [], []
        for _ in range(30):
            sub = jax.random.split(key)[1]  # the sub-key the JAX step will use
            terms = tstep(_step_noise(sub, jparams, t_args.num_features),
                          tys, tts)
            t_losses.append(float(terms.loss.detach()))
            jparams, opt_state, key, jterms = jstep(
                jparams, opt_state, key, jnp.asarray(ys), jnp.asarray(ts))
            j_losses.append(float(jterms.loss))
    finally:
        jgp.set_rff_reference_scale(False)
        tgp.set_rff_reference_scale(False)
    return t_losses, j_losses, tparams, jparams


TRAJECTORY_RTOL = {0: 1e-3, 9: 1e-2, 29: 2e-2}


def test_vdp_training_loss_trajectory_matches_jax_and_goldens(data):
    """The golden run on the branch the goldens were recorded on: the
    native library's k-means initialises the inducing points."""
    load_jax_native()
    assert native.available()
    t_losses, j_losses, tparams, jparams = _loss_trajectories(data)
    goldens = {0: GOLDEN_FIRST, 9: GOLDEN_ITER10, 29: GOLDEN_LAST}
    for i, rtol in TRAJECTORY_RTOL.items():
        np.testing.assert_allclose(t_losses[i], goldens[i], rtol=rtol)
        np.testing.assert_allclose(t_losses[i], j_losses[i], rtol=rtol)
    assert t_losses[-1] < t_losses[0]
    got = params_to_numpy(tparams)
    for name, p in _flat(jparams).items():
        assert got[name].shape == p.shape and np.all(np.isfinite(got[name]))


def test_vdp_training_loss_trajectory_matches_jax_on_the_scipy_branch(monkeypatch):
    """The same run with the native library forced away, as in a process
    whose load failed: the JAX package simulates the data with LSODA and
    initialises the inducing points with scipy's `kmeans2`, and the port
    follows it on the same noise. No goldens: they belong to the native
    branch."""
    same_branch(monkeypatch, False)
    assert not native.available()
    t_losses, j_losses, _, _ = _loss_trajectories(JVanderPol(**VDP))
    for i, rtol in TRAJECTORY_RTOL.items():
        np.testing.assert_allclose(t_losses[i], j_losses[i], rtol=rtol)
    assert t_losses[-1] < t_losses[0]


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("projected", [False, True],
                         ids=["gaussian", "projected"])
def test_build_gpode_and_step_noise_shapes(projected):
    args = tb.ModelArgs(num_inducing=6, num_features=12)
    ys = np.zeros((3, 10, 2), np.float32)
    kw = {}
    if projected:
        kw = dict(projector=ProjectorArrays(
            components=np.ones((2, 7), np.float32), norm_mean=None,
            norm_std=None), full_dim=7)
    params = tb.build_gpode(torch.Generator().manual_seed(0), args, ys,
                            device="cpu", **kw)
    want = jb.build_gpode(
        jax.random.PRNGKey(0), jb.ModelArgs(num_inducing=6, num_features=12),
        ys, **({} if not projected else dict(
            projector=jb.Projector(jnp.ones((2, 7)), None, None), full_dim=7)))
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    want_shapes = {n: v.shape for n, v in _flat(want).items() if v is not None}
    assert shapes == want_shapes
    kind = ProjectedGaussianLikelihood if projected else GaussianLikelihood
    assert isinstance(params.likelihood, kind)
    np.testing.assert_allclose(params.likelihood.variance.detach(),
                               want.likelihood.variance, rtol=1e-6)
    noise = tgpode.sample_gpode_step_noise(params, args.num_features,
                                           torch.Generator().manual_seed(1))
    assert noise.rff_weights.shape == (12, 2)
    assert noise.rff_freq.shape == (2, 12, 2)
    assert noise.rff_phase.shape == (1, 12, 2)
    assert noise.inducing.shape == (6, 2) and noise.x0.shape == (3, 2)
    assert 0.0 <= float(noise.rff_phase.min()) and float(noise.rff_phase.max()) < 1.0
    loss, terms = tb.gpode_loss_fn(
        tb.ModelArgs(num_inducing=6, num_features=12, solver="rk4",
                     ts_dense_scale=2))(
        params, noise, torch.zeros(3, 10, 7 if projected else 2),
        torch.linspace(0.0, 0.9, 10))
    assert np.isfinite(float(loss.detach())) and terms.ncov == 11
