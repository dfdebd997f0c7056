"""The port's posterior evaluation against the JAX package's, on the CPU:
the batched-draw solve, `predict` in both x0 modes, the mixture metrics and
the projected scorer, on a reduced MoCap-09 problem built by the JAX
package; plus the presets and the small helpers of the eval path.

The noise `gpode.predict` draws from its key is rebuilt with the same splits
(`split(key, S)`, then `split(k)[0]` for the function draw and `[1]` for
the x0 sample, then `draw_posterior`'s own four-way split) and fed to the
port as a `PredictNoise`. Tolerances: predictions, LL and MSE rtol 1e-4;
predictions and function draws also atol 1e-4 * max|ref|, since at the
k-means inducing init cond(K(Z,Z) + jitter) is about 3.6e3, so the two
frameworks' float32 triangular solves differ by up to ~1e-4 of max|nu| (an
entry near zero gets no relative slack); metrics on shared predictions
rtol 1e-5 (the device version sums in float32).
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
from gpode_tpu.models import gpode as jgpode
from gpode_tpu.models.flow import SolverConfig as JSolverConfig
from gpode_tpu.models.flow import flow_forward_batched as jflow_batched
from gpode_tpu.models.init import (initialize_inducing,
                                   initialize_kernel_parameters)
from gpode_tpu.ops.ode import max_rms_over_axis0 as j_max_rms
from gpode_tpu.train import bench_setup as jbench
from gpode_tpu.train import builders as jb
from gpode_tpu.train import metrics as jmetrics
from gpode_tpu.train.evaluation import \
    make_projected_scorer as j_make_projected_scorer
from gpode_tpu.utils.time_grids import insert_zero_t0 as j_insert_zero_t0

from gpode_tpu_torch.convert import gpode_params_from_numpy, params_from_numpy
from gpode_tpu_torch.data.mocap import ProjectorArrays
from gpode_tpu_torch.models import gpode
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward_batched
from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import ode
from gpode_tpu_torch.ops.ode import max_rms_over_axis0
from gpode_tpu_torch.train import bench_setup as tbench
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import metrics as tmetrics
from gpode_tpu_torch.train.evaluation import make_projected_scorer
from gpode_tpu_torch.utils.time_grids import insert_zero_t0

from _torch_capture import OnCard, rehearse_captures
from test_torch_native import same_branch

torch.set_num_threads(1)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mocap")
N_SEQ, SEQLEN, T_EVAL = 2, 12, 10
NUM_FEATURES, NUM_DRAWS = 32, 4
J_ARGS = jb.ModelArgs(num_inducing=8, num_features=NUM_FEATURES,
                      dimwise=True, solver="rk4", ts_dense_scale=2,
                      max_steps=8, num_samples=3)
T_ARGS = tb.ModelArgs(num_inducing=8, num_features=NUM_FEATURES,
                      dimwise=True, solver="rk4", ts_dense_scale=2,
                      max_steps=8, num_samples=3)
# the eval configs of scripts/bench_time_to_nll.py: the preset's solver with
# max_steps >= 512 and the step-size heuristic
SOLVERS = {"rk4": dict(solver="rk4", ts_dense_scale=2, max_steps=512),
           "dopri5": dict(solver="dopri5", ts_dense_scale=2, max_steps=512)}


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def problem():
    """A reduced MoCap-09 shooting model (2 sequences x 12 steps, 5 PCA
    latents, likelihood in the 50-D data space) and its test split, cut to
    T_EVAL steps: (JAX GPODEParams view, port GPODEParams, projector, test
    latents, test data, test ts)."""
    data_pca = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                             data_normalize=False, pca_normalize=True,
                             seqlen=SEQLEN)
    data_full = JMocapDataset(data_path=DATA_DIR, subject="09",
                              pca_components=-1, data_normalize=False,
                              pca_normalize=False, seqlen=SEQLEN)
    ys_pca = data_pca.trn.ys[:N_SEQ]
    params = jb.build_shooting(jax.random.PRNGKey(0), J_ARGS, ys_pca,
                               projector=j_projector(data_pca), full_dim=50)
    params = params._replace(gp=initialize_kernel_parameters(params.gp))
    with pytest.MonkeyPatch.context() as mp:
        # scipy's k-means in both packages on every run: whether the JAX
        # package's native library loads depends on which test process
        # built it first
        same_branch(mp, False)
        params = params._replace(gp=initialize_inducing(
            params.gp, ys_pca, float(data_pca.trn.ts.max()), 1e0,
            rng=np.random.RandomState(0)))
    jview = jgpode.GPODEParams(gp=params.gp, x0=params.states.x0,
                               likelihood=params.likelihood)
    tparams = params_from_numpy(_flat(params), T_ARGS, device="cpu")
    tview = gpode.GPODEParams(tparams.gp, tparams.states.x0, tparams.likelihood)
    return (jview, tview, j_projector(data_pca), data_pca.tst.ys[:, :T_EVAL],
            data_full.tst.ys[:, :T_EVAL], data_pca.tst.ts[:T_EVAL])


def _predict_noise(key, jparams, num_draws, sample_x0):
    """The noise `gpode_tpu.models.gpode.predict(key, ...)` draws."""
    m, d = jparams.gp.u_mean.shape
    din = jparams.gp.z.shape[1]
    keys = jax.random.split(key, num_draws)
    draw_keys = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    x0_keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)

    def draw_noise(k):
        k_w, k_omega, k_phase, k_u = jax.random.split(k, 4)
        return (jax.random.normal(k_w, (NUM_FEATURES, d)),
                jax.random.normal(k_omega, (din, NUM_FEATURES, d)),
                jax.random.uniform(k_phase, (1, NUM_FEATURES, d)),
                jax.random.normal(k_u, (m, d)))

    w, om, ph, u = map(_t, jax.vmap(draw_noise)(draw_keys))
    x0 = None
    if sample_x0:
        n = jparams.x0.mean.shape[0]
        x0 = _t(jax.vmap(lambda k: jax.random.normal(k, (1, n, d))[0])(x0_keys))
    return gpode.PredictNoise(w, om, ph, u, x0)


def _close_pred(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.max(np.abs(want))))


# ---------------------------------------------------------------------------
# helpers and presets
# ---------------------------------------------------------------------------

def test_time_grid_shift_and_batched_error_norm_match_jax():
    ts = np.array([0.0, 0.25, 0.5, 0.9], np.float32)
    np.testing.assert_array_equal(insert_zero_t0(_t(ts)).numpy(),
                                  np.asarray(j_insert_zero_t0(jnp.asarray(ts))))
    np.testing.assert_array_equal(
        insert_zero_t0(_t(ts), 0.1).numpy(),
        np.asarray(j_insert_zero_t0(jnp.asarray(ts), 0.1)))
    r = np.random.default_rng(0).normal(size=(4, 3, 5)).astype(np.float32)
    r[2] *= 3.0
    np.testing.assert_allclose(float(max_rms_over_axis0(_t(r))),
                               float(j_max_rms(jnp.asarray(r))), rtol=1e-6)


@pytest.mark.parametrize("name", tbench.PRESETS)
def test_presets_match_jax(name):
    want = dataclasses.asdict(jbench.preset_model_args(name))
    got = dataclasses.asdict(tbench.preset_model_args(name))
    assert got == {k: want[k] for k in got}
    assert want["remat"] is (name == "scale") and want["use_adjoint"] is False
    assert got["remat"] is want["remat"]
    with pytest.raises(ValueError, match="preset"):
        tbench.preset_model_args("nope")


def test_bench_entry_point_runs_on_the_cpu(monkeypatch, capsys):
    """`scripts/bench.py` with `--device cpu` (the `fast` preset, one step a
    window): one JSON line with the JAX `measure_steps_per_sec` keys, the
    CPU named as such, and no device memory figure."""
    from gpode_tpu_torch.scripts import bench
    assert bench.main(["--preset", "fast", "--iters", "1", "--device",
                       "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"steps_per_sec", "rhs_evals_per_sec", "loss", "platform",
            "device"} <= set(out)
    assert (out["platform"], out["device"], out["peak_mib"]) == ("cpu", "cpu",
                                                                 None)
    assert out["steps_per_sec"] > 0 and np.isfinite(out["loss"])
    # rhs evaluations of a fast step (4) x 5 draws x 6 sequences x 100 steps
    assert out["rhs_evals_per_sec"] == pytest.approx(
        out["steps_per_sec"] * 4 * 5 * 6 * 100)


# ---------------------------------------------------------------------------
# flow_forward_batched and predict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [None, True], ids=["batched_plain", "per_draw_kernel"])
def test_flow_forward_batched_matches_jax(problem, kernels):
    """Four draws in one solve (dopri5 with the max-over-draws error norm).
    kernels=True takes the per-draw fused rhs (its plain version here)."""
    jview, tview, *_ = problem
    noise = _predict_noise(jax.random.PRNGKey(5), jview, NUM_DRAWS, False)
    keys = jax.random.split(jax.random.PRNGKey(5), NUM_DRAWS)
    chol = jgp.precompute_chol(jview.gp)
    jdraws = jax.vmap(lambda k: jgp.draw_posterior(
        jax.random.split(k)[0], jview.gp, NUM_FEATURES, chol))(keys)
    tdraws = tgp.draw_posterior(tview.gp, noise.rff_weights, noise.rff_freq,
                                noise.rff_phase, noise.inducing)
    for name in jdraws._fields:
        want = np.asarray(getattr(jdraws, name))
        np.testing.assert_allclose(getattr(tdraws, name).detach().numpy(), want,
                                   rtol=1e-4, atol=1e-4 * float(np.max(np.abs(want))),
                                   err_msg=name)
    x0 = np.random.default_rng(6).normal(size=(NUM_DRAWS, 3, 5)).astype(np.float32)
    ts = np.linspace(0.0, 0.3, 4).astype(np.float32)
    kw = dict(solver="dopri5", max_steps=64, rtol=1e-5, atol=1e-5)
    want, jst = jflow_batched(jview.gp, jdraws, jnp.asarray(x0), jnp.asarray(ts),
                              JSolverConfig(**kw))
    before = dict(ck.LAUNCHES)
    with torch.no_grad():
        got, st = flow_forward_batched(tview.gp, tdraws, _t(x0), _t(ts),
                                       SolverConfig(kernels=kernels, **kw))
    assert ck.LAUNCHES == before
    assert got.shape == (NUM_DRAWS, 3, 4, 5)
    _close_pred(got, want)
    assert (st.num_accepted, st.num_attempted, st.num_covered) == (
        int(jst.num_accepted), int(jst.num_attempted), int(jst.num_covered))


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("mode", ["x0_given", "x0_sampled"])
def test_predict_matches_jax(problem, solver, mode):
    jview, tview, _, tst_latent, _, tst_ts = problem
    key = jax.random.PRNGKey(7)
    given = mode == "x0_given"
    x0 = tst_latent[:, 0] if given else None
    want = jgpode.predict(key, jview, jnp.asarray(tst_ts),
                          JSolverConfig(**SOLVERS[solver]), NUM_FEATURES,
                          num_draws=NUM_DRAWS,
                          x0=None if x0 is None else jnp.asarray(x0))
    noise = _predict_noise(key, jview, NUM_DRAWS, not given)
    with torch.no_grad():
        got = gpode.predict(tview, noise, _t(tst_ts),
                            SolverConfig(**SOLVERS[solver]),
                            x0=None if x0 is None else _t(x0))
    assert got.shape == (NUM_DRAWS, N_SEQ, T_EVAL, 5) == want.shape
    _close_pred(got, want)


def test_predict_noise_shapes_and_the_x0_rule(problem):
    _, tview, *_ = problem
    gen = torch.Generator().manual_seed(0)
    noise = gpode.sample_predict_noise(tview, NUM_FEATURES, NUM_DRAWS, gen)
    assert noise.rff_freq.shape == (NUM_DRAWS, 5, NUM_FEATURES, 5)
    assert noise.inducing.shape == (NUM_DRAWS, 8, 5)
    assert noise.x0.shape == (NUM_DRAWS, N_SEQ, 5)
    bare = gpode.sample_predict_noise(tview, NUM_FEATURES, NUM_DRAWS, gen,
                                      sample_x0=False)
    assert bare.x0 is None
    with pytest.raises(ValueError, match="x0"):
        gpode.predict(tview, bare, torch.linspace(0, 0.1, 3),
                      SolverConfig(solver="rk4"))


def test_gpode_params_from_numpy_match_the_shooting_view(problem):
    jview, tview, *_ = problem
    flat = _flat(jview)
    got = dict(tview.named_parameters())
    assert set(got) == set(flat)
    built = dict(gpode_params_from_numpy(flat, device="cpu").named_parameters())
    for name, a in flat.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), a, err_msg=name)
        np.testing.assert_array_equal(built[name].detach().numpy(), a, err_msg=name)
    with pytest.raises(KeyError):
        gpode_params_from_numpy({**flat, "x0.extra": flat["x0.mean"]},
                                device="cpu")


# ---------------------------------------------------------------------------
# metrics and the projected scorer
# ---------------------------------------------------------------------------

def test_mixture_summary_device_matches_host_and_jax():
    rng = np.random.default_rng(8)
    actual = rng.normal(size=(3, 7, 6)).astype(np.float32)
    predicted = (actual[None] + 0.4 * rng.normal(size=(16, 3, 7, 6))).astype(np.float32)
    noise_var = rng.uniform(0.05, 0.5, size=(6,)).astype(np.float32)
    host = tmetrics.compute_summary(actual, predicted, noise_var)
    np.testing.assert_allclose(host, jmetrics.compute_summary(actual, predicted,
                                                              noise_var), rtol=1e-12)
    dev = tmetrics.mixture_summary_device(_t(actual), _t(predicted), _t(noise_var))
    jdev = jmetrics.mixture_summary_device(jnp.asarray(actual),
                                           jnp.asarray(predicted),
                                           jnp.asarray(noise_var))
    assert all(v.dtype == torch.float32 and v.ndim == 0 for v in dev)
    np.testing.assert_allclose([float(v) for v in dev], host, rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in dev],
                               [float(v) for v in jdev], rtol=1e-5)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_projected_scorer_matches_jax(problem, solver):
    """LL and MSE in the 50-D data space of the test split from given start
    states, as `scripts/bench_time_to_nll.py` scores a preset."""
    jview, tview, proj, tst_latent, tst_full, tst_ts = problem
    key = jax.random.PRNGKey(9)
    x0 = tst_latent[:, 0]
    jscorer = j_make_projected_scorer(JSolverConfig(**SOLVERS[solver]),
                                      NUM_FEATURES, proj, tst_full, tst_ts, x0,
                                      num_draws=NUM_DRAWS)
    want = [float(v) for v in jscorer(jview, key)]
    scorer = make_projected_scorer(SolverConfig(**SOLVERS[solver]),
                                   ProjectorArrays(*map(np.asarray, proj)),
                                   tst_full, tst_ts, x0, device="cpu")
    got = scorer(tview, _predict_noise(key, jview, NUM_DRAWS, False))
    assert all(v.ndim == 0 for v in got)
    np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-4)
    assert all(np.isfinite(want))


# ---------------------------------------------------------------------------
# the batched solve's attempt: the seam, the gate, the captured attempt
# ---------------------------------------------------------------------------

def _batched_solve(problem, seed, num_draws=NUM_DRAWS):
    """(GP, draws of `seed`'s noise, x0 (S, 2, 5) from the test latents, ts)."""
    jview, tview, _, tst_latent, _, tst_ts = problem
    noise = _predict_noise(jax.random.PRNGKey(seed), jview, num_draws, False)
    draws = tgp.draw_posterior(tview.gp, noise.rff_weights, noise.rff_freq,
                               noise.rff_phase, noise.inducing)
    x0 = _t(tst_latent[:, 0]).expand(num_draws, -1, -1)
    return tview.gp, draws, x0, _t(tst_ts)


@pytest.mark.parametrize("first_step", [None, ode.FIRST_STEP_SPAN],
                         ids=["heuristic", "span_rejects"])
def test_dopri5_with_the_default_attempt_passed_equals_without(problem,
                                                               first_step):
    """`odeint_dopri5` given `dopri5_attempt` on the (time-invariant)
    batched field explicitly returns the states and `ODEStats` of the call
    without one, bit for bit; from the whole span the first attempt is
    rejected."""
    gp_params, draws, x0, ts = _batched_solve(problem, 11)

    def rhs(t, x):
        return tgp.eval_draws(gp_params, draws, x)

    kw = dict(rtol=1e-5, atol=1e-5, max_steps=64, first_step=first_step,
              norm=max_rms_over_axis0)
    with torch.no_grad():
        want, wst = ode.odeint_dopri5(rhs, x0, ts, **kw)
        got, st = ode.odeint_dopri5(rhs, x0, ts, attempt=ode.dopri5_attempt(
            rhs, rtol=1e-5, atol=1e-5, norm=max_rms_over_axis0), **kw)
    assert torch.equal(got, want) and st == wst
    if first_step is not None:
        assert wst.num_attempted > wst.num_accepted


@pytest.mark.parametrize("case,captured", [
    ("card", True), ("cpu", False), ("grad", False), ("remat", False),
    ("rk4", False), ("adams", False), ("capturing", False),
    ("float64", False), ("kernels_off", False), ("kernels_on", True),
    ("kernels_on_refused", False)])
def test_the_gate_captures_only_the_no_grad_dopri5_attempt_on_a_card(
        monkeypatch, case, captured):
    """The attempt is captured with grad mode off, a float32 state on
    CUDA outside any capture, dopri5, no `remat` and the kernels not off;
    every other case is eager. Under `kernels=True` a shape the draws
    kernel refuses (Din = D = 17) raises ValueError."""
    from gpode_tpu_torch.models import flow as tflow

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    din = 17 if case == "kernels_on_refused" else 5
    gp_params, draws, x0 = _random_draws(2, 2, din, 8, 16, 0)
    cfg = SolverConfig(solver=case if case in ("rk4", "adams") else "dopri5",
                       remat=case == "remat",
                       kernels={"kernels_off": False, "kernels_on": True,
                                "kernels_on_refused": True}.get(case))
    if case == "float64":
        x0 = x0.double()
    state = x0 if case == "cpu" else OnCard(x0)
    with torch.set_grad_enabled(case == "grad"):
        if case == "kernels_on_refused":
            with pytest.raises(ValueError, match="Din <= 16"):
                tflow._capture_route(cfg, gp_params, draws, state)
            return
        route = tflow._capture_route(cfg, gp_params, draws, state)
    assert route == ("fused" if captured else None)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_the_cpu_solve_passes_no_attempt_and_replays_nothing(problem,
                                                             monkeypatch, grad):
    """On the CPU, with grad mode on or off, `flow_forward_batched` leaves
    dopri5 its eager attempt, and the clocked span of a captured attempt's
    replay, `gpode.solve.replay`, counts no call."""
    from gpode_tpu_torch.models import flow as tflow
    from gpode_tpu_torch.utils import profiling

    assert "gpode.solve.replay" in profiling.UNTRACED
    assert "gpode.solve.replay" in profiling.SPANS
    seen = []

    def recorded(*args, **kw):
        seen.append(kw["attempt"])
        return ode.odeint(*args, **kw)

    monkeypatch.setattr(tflow, "odeint", recorded)
    gp_params, draws, x0, ts = _batched_solve(problem, 12)
    before = tuple(profiling.UNTRACED["gpode.solve.replay"])
    with torch.set_grad_enabled(grad):
        flow_forward_batched(gp_params, draws, x0, ts,
                             SolverConfig(solver="dopri5", max_steps=64))
    assert seen == [None]
    assert tuple(profiling.UNTRACED["gpode.solve.replay"]) == before


def test_captured_attempt_rehearsal_equals_the_eager_solve(problem,
                                                           monkeypatch):
    """The captured attempt's control flow on the CPU (`CapturedAttempt`
    with the eager stand-in of its graph, let through the gate): each solve
    equals the eager one bit for bit, states and `ODEStats`: two requests'
    noise, a solve with rejected attempts, and one after an in-place change
    of the GP's parameters, all through the one cached attempt, one replay
    per attempt; no output shares memory with its static buffers."""
    from gpode_tpu_torch.models import flow as tflow
    from gpode_tpu_torch.utils import profiling

    gp_params = problem[1].gp
    saved = [p.detach().clone() for p in gp_params.parameters()]
    monkeypatch.setattr(tflow, "_ATTEMPTS", type(tflow._ATTEMPTS)())
    kw = dict(solver="dopri5", max_steps=64, rtol=1e-5, atol=1e-5)

    def solve(seed, captured, **cfg):
        rehearse_captures(monkeypatch, captured)
        _, draws, x0, ts = _batched_solve(problem, seed)
        with torch.no_grad():
            return flow_forward_batched(gp_params, draws, x0, ts,
                                        SolverConfig(**kw, **cfg))

    runs = [(13, {}, False), (14, {}, False),
            (14, {"first_step": ode.FIRST_STEP_SPAN}, False), (13, {}, True)]
    outs = []
    try:
        for seed, cfg, update in runs:
            if update:  # an optimizer's in-place step
                with torch.no_grad():
                    gp_params.z.add_(0.05)
                    gp_params.kernel.raw_lengthscales.mul_(0.9)
            want, wst = solve(seed, False, **cfg)
            before = tuple(profiling.UNTRACED["gpode.solve.replay"])
            got, st = solve(seed, True, **cfg)
            replays = profiling.UNTRACED["gpode.solve.replay"][0] - before[0]
            assert torch.equal(got, want) and st == wst
            assert replays == st.num_attempted
            outs.append((got, got.clone(), st))
    finally:
        with torch.no_grad():
            for p, v in zip(gp_params.parameters(), saved):
                p.copy_(v)
    (attempt,) = tflow._ATTEMPTS.values()
    statics = [attempt.x, attempt.k1, attempt.dt, *attempt.out, *attempt.draws]
    for got, copy, _ in outs:
        assert torch.equal(got, copy)  # no later solve wrote over it
        assert all(got.untyped_storage().data_ptr()
                   != t.untyped_storage().data_ptr() for t in statics)
    assert outs[2][2].num_attempted > outs[2][2].num_accepted
    assert not torch.equal(outs[3][0], outs[0][0])


# ---------------------------------------------------------------------------
# the fused batched-draw attempt: its plain version, the kernel route
# ---------------------------------------------------------------------------

def _random_draws(num_draws, rows, dim, m, s, seed):
    """A dimwise GP of `m` inducing points over `dim` latents with perturbed
    hyperparameters, `num_draws` posterior draws of `s` features from seeded
    noise, and start states (num_draws, rows, dim)."""
    gen = torch.Generator().manual_seed(seed)
    params = tgp.init_svgp(gen, dim, dim, m)
    with torch.no_grad():
        params.kernel.raw_lengthscales.add_(
            0.3 * torch.randn(dim, dim, generator=gen))
        params.kernel.raw_variance.add_(0.2 * torch.randn(dim, generator=gen))
        params.u_mean.normal_(generator=gen)
        draws = tgp.draw_posterior(
            params, torch.randn(num_draws, s, dim, generator=gen),
            torch.randn(num_draws, dim, s, dim, generator=gen),
            torch.rand(num_draws, 1, s, dim, generator=gen),
            torch.randn(num_draws, m, dim, generator=gen))
    return params, draws, torch.randn(num_draws, rows, dim, generator=gen)


# (draws, rows a draw, Din = D, M, features): the validation request's
# 32 x 2 at the bench widths, the test evaluation's 128 x 2, a tile past
# one block's rows, and small odd widths
DRAWS_SHAPES = [(32, 2, 5, 100, 256), (128, 2, 5, 100, 256), (3, 19, 5, 16, 32),
                (4, 1, 2, 7, 17), (2, 5, 9, 8, 40)]


@pytest.mark.parametrize("direction", [1.0, -1.0], ids=["forward", "backward"])
@pytest.mark.parametrize("shape", DRAWS_SHAPES,
                         ids=["x".join(map(str, s)) for s in DRAWS_SHAPES])
def test_dopri5_attempt_draws_plain_is_the_attempt_on_eval_draws(shape,
                                                                 direction):
    """`dopri5_attempt_draws_plain` (and the wrapper on CPU tensors) returns
    the batched solve's attempt, `dopri5_attempt` on the `eval_draws` field
    with the max-over-draws norm, bit for bit: x_new, the ratio and k7, from
    the FSAL k1 = f(x), at a short step and at one whose error rejects."""
    num_draws, rows, dim, m, s = shape
    params, draws, x = _random_draws(num_draws, rows, dim, m, s, sum(shape))

    def field(t, xx):
        return direction * tgp.eval_draws(params, draws, xx, False)

    kern = params.kernel
    with torch.no_grad():
        k1 = field(None, x)
        operands = (params.z, kern.lengthscales, kern.variance, draws.omega,
                    draws.phase, tgp.kernel_rff_weights(draws.weights),
                    draws.nu)
        ratios = []
        for span in (0.01, 2.0):
            dt = torch.tensor(span)
            want = ode.dopri5_attempt(field, rtol=1e-5, atol=1e-5,
                                      norm=max_rms_over_axis0)(None, x, k1, dt)
            before = dict(ck.LAUNCHES)
            for fn in (ck.dopri5_attempt_draws_plain, ck.dopri5_attempt_draws):
                got = fn(x, k1, dt, direction, *operands, 1e-5, 1e-5)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert ck.LAUNCHES == before
            assert want[1].ndim == 0 and want[0].shape == want[2].shape == x.shape
            ratios.append(float(want[1]))
    assert ratios[0] < ratios[1] and ratios[1] > 1.0


def test_dopri5_attempt_draws_is_forward_only():
    params, draws, x = _random_draws(2, 3, 2, 4, 8, 0)
    kern = params.kernel
    k1 = torch.zeros_like(x)
    with pytest.raises(RuntimeError, match="forward only"):
        ck.dopri5_attempt_draws(x, k1, torch.tensor(0.1), 1.0, params.z,
                                kern.lengthscales, kern.variance, *draws)


def test_kernel_order_draws_are_read_with_no_copy():
    """A captured attempt's static draws (`kernel_order_draws`) hold the
    leaves' values in their shapes, and the kernel's layout of them is a
    view of the same memory: the graph holds no layout copy."""
    _, draws, _ = _random_draws(3, 2, 5, 8, 16, 1)
    static = ck.kernel_order_draws(*draws)
    for leaf, copy in zip(draws, static):
        assert copy.shape == leaf.shape and torch.equal(copy, leaf)
    for got, want, leaf in zip(ck._draws_layout(*static),
                               ck._draws_layout(*draws), static):
        assert got.is_contiguous() and torch.equal(got, want)
        assert got.data_ptr() == leaf.data_ptr()


@pytest.mark.parametrize("case", ["forward", "backward", "draws32"])
def test_kernel_route_captured_solve_equals_the_plain_attempt(problem,
                                                             monkeypatch,
                                                             case):
    """`flow_forward_batched` through a `CapturedAttempt` that takes the
    kernel route (on the CPU its eager stand-in runs the kernel's plain
    version) returns the eager solve's states and `ODEStats`, bit for bit,
    forward and backward in time and at the validation request's 32 draws;
    one replay an attempt, and the attempt counted on no kernel."""
    from gpode_tpu_torch.models import flow as tflow
    from gpode_tpu_torch.utils import profiling

    monkeypatch.setattr(tflow, "_ATTEMPTS", type(tflow._ATTEMPTS)())
    gp_params, draws, x0, ts = _batched_solve(
        problem, 15, num_draws=32 if case == "draws32" else NUM_DRAWS)
    if case == "backward":
        ts = torch.flip(ts, [0])
    cfg = SolverConfig(solver="dopri5", max_steps=64, rtol=1e-5, atol=1e-5)
    outs = {}
    for captured in (False, True):
        rehearse_captures(monkeypatch, captured)
        before = tuple(profiling.UNTRACED["gpode.solve.replay"])
        launches = dict(ck.LAUNCHES)
        with torch.no_grad():
            outs[captured] = flow_forward_batched(gp_params, draws, x0, ts, cfg)
        replays = profiling.UNTRACED["gpode.solve.replay"][0] - before[0]
        assert replays == (outs[captured][1].num_attempted if captured else 0)
        assert ck.LAUNCHES == launches
    (attempt,) = tflow._ATTEMPTS.values()
    assert attempt.fused and attempt.direction == (-1.0 if case == "backward"
                                                   else 1.0)
    (want, wst), (got, st) = outs[False], outs[True]
    assert torch.equal(got, want) and st == wst
    assert st.num_accepted > 1


def test_the_kernel_route_is_decided_from_shapes_before_the_capture(
        problem, monkeypatch, caplog):
    """A captured attempt of a dimwise GP at a shape the kernel takes is
    the kernel; a GP that is not dimwise and a width the kernel refuses
    (Din = D = 17) capture the plain attempt, a refusal logged once."""
    from gpode_tpu_torch.models import flow as tflow

    monkeypatch.setattr(tflow, "_REFUSALS_LOGGED", set())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    def route(g, d, x):
        with torch.no_grad():
            return tflow._capture_route(SolverConfig(), g, d, OnCard(x))

    gp_params, draws, x0, _ = _batched_solve(problem, 16)
    assert route(gp_params, draws, x0) == "fused"
    flat = tgp.init_svgp(torch.Generator().manual_seed(0), 5, 5, 8,
                         dimwise=False)
    assert route(flat, draws, x0) == "plain"
    wide, wide_draws, wide_x0 = _random_draws(2, 2, 17, 8, 16, 2)
    with caplog.at_level("WARNING", logger=tflow.__name__):
        for _ in range(2):
            assert route(wide, wide_draws, wide_x0) == "plain"
    refusals = [r for r in caplog.records if "refuses" in r.getMessage()]
    assert len(refusals) == 1 and "Din <= 16" in refusals[0].getMessage()
