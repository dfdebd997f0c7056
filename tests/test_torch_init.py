"""The port's data-driven init against the JAX package's, on the CPU:
`flow_forward_sampled`, `estimate_x0_backward` (rk4 and dopri5 under the
eval solver of the time-to-LL driver, over a decreasing time grid),
`initialize_shooting_states_with_data` and `initialize_noisevar`, on a
reduced MoCap-09 shooting problem built by the JAX package (M=16, 32
features, 4 draws); the port's training from that init against the JAX
package's on shared step noise, and its ELBO and gradients against the JAX
package's in float64; then the port's time-to-LL driver end to end at a
tiny run.

The noise the JAX functions draw from their keys is rebuilt with the same
splits and fed to the port: `split(key, S)`, then each key straight into
`draw_posterior`'s own four-way split (weights, frequencies, phases,
inducing normals). Tolerance rtol 1e-4 with atol 1e-5 * max|ref|.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.data.mocap import MocapDataset as JMocapDataset
from gpode_tpu.data.mocap import latent_to_data_projector as j_projector
from gpode_tpu.models import gp as jgp
from gpode_tpu.models import init as jinit
from gpode_tpu.models.flow import SolverConfig as JSolverConfig
from gpode_tpu.models.flow import flow_forward_sampled as j_flow_sampled
from gpode_tpu.train import builders as jb
from gpode_tpu.train.trainer import (build_frozen_mask, default_optimizer,
                                     make_train_step)

from gpode_tpu_torch.convert import params_from_numpy
from gpode_tpu_torch.models import gpode
from gpode_tpu_torch.models import init as tinit
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward_sampled
from gpode_tpu_torch.models.shooting import StepNoise
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.scripts import bench_time_to_nll
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import trainer as tt

from test_torch_native import same_branch

torch.set_num_threads(1)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mocap")
N_SEQ, SEQLEN = 2, 12
NUM_FEATURES, NUM_DRAWS = 32, 4
ARGS = dict(num_inducing=16, num_features=NUM_FEATURES, dimwise=True,
            solver="rk4", ts_dense_scale=2, max_steps=8, num_samples=3)
# the time-to-LL driver's eval solvers: the preset's solver with
# max_steps >= 512 and Hairer's first step
SOLVERS = {"rk4": dict(solver="rk4", ts_dense_scale=2, max_steps=512),
           "dopri5": dict(solver="dopri5", ts_dense_scale=2, max_steps=512)}


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def problem():
    """A reduced MoCap-09 shooting model (2 sequences x 12 steps, 5 PCA
    latents, likelihood in the 50-D data space) with the kernel and
    inducing init: (JAX params, port params, training latents, ts)."""
    data_pca = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                             data_normalize=False, pca_normalize=True,
                             seqlen=SEQLEN)
    ys = data_pca.trn.ys[:N_SEQ]
    params = jb.build_shooting(jax.random.PRNGKey(0), jb.ModelArgs(**ARGS), ys,
                               projector=j_projector(data_pca), full_dim=50)
    params = params._replace(gp=jinit.initialize_kernel_parameters(
        params.gp, lengthscale_value=1.25, variance_value=0.5))
    with pytest.MonkeyPatch.context() as mp:
        # scipy's k-means in both packages on every run
        same_branch(mp, False)
        params = params._replace(gp=jinit.initialize_inducing(
            params.gp, ys, float(data_pca.trn.ts.max()), 1e0,
            rng=np.random.RandomState(0)))
    return params, _port(params), ys, data_pca.trn.ts


def _port(jparams):
    return params_from_numpy(_flat(jparams), tb.ModelArgs(**ARGS), device="cpu")


def _draw_noise(key, jgp_params):
    """The noise `gpode_tpu.models.gp.draw_posterior(key, ...)` draws."""
    m, d = jgp_params.u_mean.shape
    din = jgp_params.z.shape[1]
    k_w, k_omega, k_phase, k_u = jax.random.split(key, 4)
    return tuple(map(_t, (jax.random.normal(k_w, (NUM_FEATURES, d)),
                          jax.random.normal(k_omega, (din, NUM_FEATURES, d)),
                          jax.random.uniform(k_phase, (1, NUM_FEATURES, d)),
                          jax.random.normal(k_u, (m, d)))))


def _draws_noise(key, jgp_params, num_draws):
    """`split(key, num_draws)`, each into `draw_posterior`: a PredictNoise
    without x0 normals."""
    per_draw = [_draw_noise(k, jgp_params)
                for k in jax.random.split(key, num_draws)]
    return gpode.PredictNoise(*(torch.stack(leaf) for leaf in zip(*per_draw)))


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_flow_forward_sampled_matches_jax(problem, solver, direction):
    """One draw from its noise, then the solve over a 4-point grid, also a
    decreasing one (dt < 0 in rk4's steps and dopri5's folded direction)."""
    jparams, tparams, ys, ts = problem
    grid = ts[:4] if direction == "forward" else ts[:4][::-1].copy()
    key = jax.random.PRNGKey(3)
    chol = jgp.precompute_chol(jparams.gp)
    want, jst = j_flow_sampled(key, jparams.gp, jnp.asarray(ys[:, 0]),
                               jnp.asarray(grid), JSolverConfig(**SOLVERS[solver]),
                               NUM_FEATURES, chol)
    before = dict(ck.LAUNCHES)
    with torch.no_grad():
        got, st = flow_forward_sampled(
            tparams.gp, *_draw_noise(key, jparams.gp), _t(ys[:, 0]), _t(grid),
            SolverConfig(**SOLVERS[solver]))
    assert ck.LAUNCHES == before
    assert got.shape == (N_SEQ, 4, 5) == want.shape
    _close(got, want)
    assert (st.num_accepted, st.num_covered) == (int(jst.num_accepted),
                                                 int(jst.num_covered))


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_estimate_x0_backward_matches_jax(problem, solver):
    jparams, tparams, ys, ts = problem
    key = jax.random.PRNGKey(4)
    want = jinit.estimate_x0_backward(key, jparams.gp, jnp.asarray(ys[:, 0]),
                                      jnp.asarray(ts),
                                      JSolverConfig(**SOLVERS[solver]),
                                      NUM_FEATURES, num_samples=NUM_DRAWS)
    got = tinit.estimate_x0_backward(tparams.gp,
                                     _draws_noise(key, jparams.gp, NUM_DRAWS),
                                     _t(ys[:, 0]), _t(ts),
                                     SolverConfig(**SOLVERS[solver]))
    assert got.shape == (N_SEQ, 5)
    _close(got, want)
    # the backward solve moved the states off the first observation
    assert float((got - _t(ys[:, 0])).abs().max()) > 1e-4


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_initialize_shooting_states_with_data_matches_jax(problem, solver):
    jparams, _, ys, ts = problem
    key = jax.random.PRNGKey(5)
    want = jinit.initialize_shooting_states_with_data(
        key, jparams, ys, ts, JSolverConfig(**SOLVERS[solver]), NUM_FEATURES,
        num_samples=NUM_DRAWS)
    tparams = _port(jparams)             # a fresh copy: the port writes in place
    assert tinit.initialize_shooting_states_with_data(
        tparams, _draws_noise(key, jparams.gp, NUM_DRAWS), ys, ts,
        SolverConfig(**SOLVERS[solver])) is tparams
    _close(tparams.states.x0.mean, want.states.x0.mean)
    np.testing.assert_array_equal(tparams.states.mean.detach().numpy(),
                                  np.asarray(want.states.mean))
    np.testing.assert_array_equal(tparams.states.mean.detach().numpy(),
                                  ys[:, :-1])
    # nothing else moved
    for name, a in _flat(want).items():
        if not name.startswith("states.x0.mean") and name != "states.mean":
            np.testing.assert_array_equal(
                dict(tparams.named_parameters())[name].detach().numpy(), a,
                err_msg=name)


@pytest.mark.parametrize("value", ["scalar", "per_dim"])
def test_initialize_noisevar_matches_jax(problem, value):
    jparams, _, _, _ = problem
    v = (0.37 if value == "scalar" else
         np.random.default_rng(6).uniform(1e-4, 3.0, size=50).astype(np.float32))
    want = jinit.initialize_noisevar(jparams.likelihood, v)
    tparams = _port(jparams)
    assert tinit.initialize_noisevar(tparams.likelihood, v) is tparams.likelihood
    _close(tparams.likelihood.base.raw_variance, want.base.raw_variance)
    np.testing.assert_allclose(tparams.likelihood.variance.detach().numpy(),
                               np.broadcast_to(v, (50,)), rtol=1e-5)


def _step_noise(sub, jparams, to=_t):
    """The noise `shooting.elbo_loss(sub, ...)` draws, as a StepNoise."""
    k_draw, k_ss = jax.random.split(sub)
    k0, ks = jax.random.split(k_ss)
    n, t1, d = jparams.states.mean.shape
    m, din = jparams.gp.z.shape
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)
    s = ARGS["num_samples"]
    return StepNoise(
        rff_weights=to(jax.random.normal(k_w, (NUM_FEATURES, d))),
        rff_freq=to(jax.random.normal(k_omega, (din, NUM_FEATURES, d))),
        rff_phase=to(jax.random.uniform(k_phase, (1, NUM_FEATURES, d))),
        inducing=to(jax.random.normal(k_u, (m, d))),
        x0=to(jax.random.normal(k0, (s, n, d))),
        states=to(jax.random.normal(ks, (s, n, t1, d))))


@pytest.fixture(scope="module")
def data_init(problem):
    """The problem's JAX parameters after the data-driven state init, and
    the training data in the 50-D data space: (JAX params, ys, ts)."""
    jparams, _, ys, ts = problem
    jparams = jinit.initialize_shooting_states_with_data(
        jax.random.PRNGKey(7), jparams, ys, ts, JSolverConfig(**SOLVERS["rk4"]),
        NUM_FEATURES, num_samples=NUM_DRAWS)
    ys_full = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=-1,
                            data_normalize=False, pca_normalize=False,
                            seqlen=SEQLEN).trn.ys[:N_SEQ]
    return jparams, ys_full, ts


TRAJECTORY_STEPS = 50


def test_training_from_the_data_driven_init_tracks_jax(data_init):
    """From the data-driven init (states at the data, x0 by backward
    integration) both packages take TRAJECTORY_STEPS Adam steps (lr 5e-3,
    the constraint frozen, as the time-to-LL drivers train) on the same
    step noise: every step's loss agrees within 1e-4 relative."""
    jparams, ys_full, ts = data_init
    jargs, targs = jb.ModelArgs(**ARGS), tb.ModelArgs(**ARGS)
    jstep = make_train_step(
        jb.shooting_loss_fn(jargs), default_optimizer(5e-3),
        frozen_mask=build_frozen_mask(jparams,
                                      jb.default_frozen_predicate(jargs)))
    opt_state = default_optimizer(5e-3).init(jparams)
    tparams = _port(jparams)
    tstep = tt.make_train_step(
        tb.shooting_loss_fn(targs), tparams,
        tt.default_optimizer(tparams, 5e-3,
                             frozen_predicate=tb.default_frozen_predicate(targs)))
    jys, jts = jnp.asarray(ys_full), jnp.asarray(ts)
    key = jax.random.PRNGKey(11)
    worst = 0.0
    for _ in range(TRAJECTORY_STEPS):
        sub = jax.random.split(key)[1]   # the sub-key the JAX step will use
        terms = tstep(_step_noise(sub, jparams), _t(jys), _t(jts))
        jparams, opt_state, key, jterms = jstep(jparams, opt_state, key, jys,
                                                jts)
        got, want = float(terms.loss.detach()), float(jterms.loss)
        worst = max(worst, abs(got - want) / abs(want))
    assert worst < 1e-4


@pytest.mark.parametrize("solver", ["rk4", "dopri5_whole_span"])
def test_elbo_and_gradients_equal_jax_in_float64(data_init, solver):
    """The port's shooting ELBO is the JAX package's formula, not only its
    float32 result: in float64 from the data-driven init on shared step
    noise the loss agrees within 1e-12 relative and every gradient leaf
    within 1e-9 of its largest magnitude. What moves two float32 training
    runs apart is then rounding (another order of the same operations)."""
    jparams, ys_full, ts = data_init
    kw = (dict(solver="dopri5", first_step=-1.0) if solver != "rk4" else {})
    jargs = dataclasses.replace(jb.ModelArgs(**ARGS), **kw)
    targs = dataclasses.replace(tb.ModelArgs(**ARGS), **kw)
    key = jax.random.PRNGKey(13)
    tparams = _port(jparams).double()
    jax.config.update("jax_enable_x64", True)
    try:
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     jparams)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jb.shooting_loss_fn(jargs)(
                p, key, jnp.asarray(ys_full, jnp.float64),
                jnp.asarray(ts, jnp.float64)), has_aux=True))(j64)
        assert jloss.dtype == jnp.float64
        noise = _step_noise(
            key, j64, lambda a: torch.tensor(np.asarray(a, np.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    loss, _ = tb.shooting_loss_fn(targs)(
        tparams, noise, torch.tensor(ys_full, dtype=torch.float64),
        torch.tensor(ts, dtype=torch.float64))
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-12)
    want = _flat(jgrads)
    for name, p in tparams.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-9 * float(np.max(np.abs(w))),
                                   err_msg=name)


DRIVER_KEYS = {"metric", "card", "device", "preset", "config", "seed",
               "targets", "eval_draws", "track_draws", "eval_every",
               "num_iter", "init_seconds", "noise_variance",
               "residual_variance", "crossings", "final",
               "train_steps_per_sec", "final_loss", "rejected_attempt_steps",
               "uncovered_steps", "overheads", "trace"}


def test_driver_runs_on_the_cpu(tmp_path):
    """The time-to-LL driver at a tiny run on the CPU: init, two steps with
    a tracking eval after each, the final eval; its JSON's keys."""
    out = tmp_path / "ttn.json"
    before = dict(ck.LAUNCHES)
    assert bench_time_to_nll.main([
        "--device", "cpu", "--preset", "fast", "--num_iter", "2",
        "--eval_every", "1", "--track_draws", "2", "--eval_draws", "2",
        "--num_samples", "1", "--out", str(out)]) == 0
    assert ck.LAUNCHES == before          # CPU tensors launch nothing
    got = json.loads(out.read_text())
    assert set(got) == DRIVER_KEYS
    assert got["card"] is None and got["device"] == "cpu"
    assert got["config"]["solver"] == "rk4" and got["config"]["num_samples"] == 1
    assert [row["iter"] for row in got["trace"]] == [1, 2]
    assert got["final"]["iter"] == 2 and np.isfinite(got["final"]["test_ll"])
    assert np.isfinite(got["final_loss"]) and got["train_steps_per_sec"] > 0
    assert got["rejected_attempt_steps"] is None    # rk4: no attempt to reject
    noise_var = np.asarray(got["noise_variance"])
    assert noise_var.shape == (50,) and np.all(noise_var > 0)
    np.testing.assert_allclose(noise_var,
                               1.5 * np.asarray(got["residual_variance"]),
                               rtol=1e-5)
    assert got["overheads"]["n_track_evals"] == 2


def test_driver_init_is_the_init_pipeline(problem):
    """`init_states_and_noise` is `initialize_shooting_states_with_data`
    under the eval solver, then the noise variance from a `predict` of the
    training split: checked against those functions called by hand."""
    data_pca, data_full = bench_time_to_nll.load_bench_data()
    margs = dataclasses.replace(tb.ModelArgs(**ARGS), solver="dopri5")
    params = bench_time_to_nll.build_model(margs, data_pca, data_full, 3, "cpu")
    gen = torch.Generator().manual_seed(0)
    v = bench_time_to_nll.view(params)
    x0_noise = gpode.sample_predict_noise(v, NUM_FEATURES, 3, gen, sample_x0=False)
    resid_noise = gpode.sample_predict_noise(v, NUM_FEATURES, 2, gen)
    cfg = bench_time_to_nll.eval_config(margs)
    assert (cfg.solver, cfg.max_steps, cfg.first_step) == ("dopri5", 512, None)
    want_x0 = tinit.estimate_x0_backward(params.gp, x0_noise,
                                         _t(data_pca.trn.ys[:, 0]),
                                         _t(data_pca.trn.ts), cfg)
    resid = bench_time_to_nll.init_states_and_noise(
        params, margs, data_pca, data_full, x0_noise, resid_noise)
    np.testing.assert_array_equal(params.states.x0.mean.detach().numpy(),
                                  want_x0.numpy())
    np.testing.assert_array_equal(params.states.mean.detach().numpy(),
                                  data_pca.trn.ys[:, :-1])
    assert resid.shape == (50,) and bool(torch.all(resid >= 1e-4))
    np.testing.assert_allclose(params.likelihood.variance.detach().numpy(),
                               1.5 * resid.numpy(), rtol=1e-5)
