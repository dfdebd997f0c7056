"""The port's training loop against the JAX package's, on the CPU.

`gpode_tpu_torch/train/trainer.py` (Adam with its schedule, the `Trainer`,
`save_trace`), `utils/meters.py`, `utils/checkpoint.py`, the new metrics,
the constraint annealer, the segment-minibatched shooting ELBO and the
vanilla x0 init, each held to its JAX counterpart on the same inputs: a
reduced MoCap-09 shooting problem (2 sequences x 12 steps, 5 PCA latents,
the likelihood in the 50-D data space, M=8, 32 features), with the step
noise the JAX package draws from its keys.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpode_tpu.data.mocap import MocapDataset as JMocapDataset
from gpode_tpu.data.mocap import latent_to_data_projector as j_projector
from gpode_tpu.models import init as jinit
from gpode_tpu.models import shooting as jshooting
from gpode_tpu.models.flow import SolverConfig as JSolverConfig
from gpode_tpu.train import builders as jb
from gpode_tpu.train import metrics as jmetrics
from gpode_tpu.train import trainer as jt
from gpode_tpu.utils.meters import Meter as JMeter

from gpode_tpu_torch.convert import (gpode_params_from_numpy, params_from_numpy,
                                     params_like, params_to_numpy)
from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.models import gpode as tgpode
from gpode_tpu_torch.models import init as tinit
from gpode_tpu_torch.models import shooting as tshooting
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.shooting import StepNoise
from gpode_tpu_torch.ops.math import softplus
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import metrics as tmetrics
from gpode_tpu_torch.train import trainer as tt
from gpode_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gpode_tpu_torch.utils.meters import Meter

from test_torch_native import same_branch

torch.set_num_threads(1)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mocap")
N_SEQ, SEQLEN = 2, 12
NUM_FEATURES, NUM_SAMPLES = 32, 3
# the `fast` preset's solver: the JAX package compiles its rk4 step in a
# fraction of the time of the dopri5 one
ARGS = dict(num_inducing=8, num_features=NUM_FEATURES, dimwise=True,
            solver="rk4", ts_dense_scale=2, max_steps=8,
            num_samples=NUM_SAMPLES)
J_ARGS, T_ARGS = jb.ModelArgs(**ARGS), tb.ModelArgs(**ARGS)
TERMS = ("loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl")


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def problem():
    """(JAX shooting params with the kernel and inducing init, data-space
    ys (N, T, 50), ts (T,), latent ys (N, T, 5))."""
    data_pca = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                             data_normalize=False, pca_normalize=True,
                             seqlen=SEQLEN)
    data_full = JMocapDataset(data_path=DATA_DIR, subject="09",
                              pca_components=-1, data_normalize=False,
                              pca_normalize=False, seqlen=SEQLEN)
    ys_pca = data_pca.trn.ys[:N_SEQ]
    params = jb.build_shooting(jax.random.PRNGKey(0), J_ARGS, ys_pca,
                               projector=j_projector(data_pca), full_dim=50)
    params = params._replace(gp=jinit.initialize_kernel_parameters(params.gp))
    with pytest.MonkeyPatch.context() as mp:
        # scipy's k-means in both packages
        same_branch(mp, False)
        params = params._replace(gp=jinit.initialize_inducing(
            params.gp, ys_pca, float(data_pca.trn.ts.max()), 1e0,
            rng=np.random.RandomState(0)))
    return params, data_full.trn.ys[:N_SEQ], data_pca.trn.ts, ys_pca


def _port(jparams, args=T_ARGS):
    return params_from_numpy(_flat(jparams), args, device="cpu")


def _step_noise(sub, jparams, segment_idx=None) -> StepNoise:
    """The noise `shooting.elbo_loss(sub, ...)` draws, as a StepNoise."""
    k_draw, k_ss = jax.random.split(sub)
    k0, ks = jax.random.split(k_ss)
    n, t1, d = jparams.states.mean.shape
    m, din = jparams.gp.z.shape
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)
    return StepNoise(
        rff_weights=_t(jax.random.normal(k_w, (NUM_FEATURES, d))),
        rff_freq=_t(jax.random.normal(k_omega, (din, NUM_FEATURES, d))),
        rff_phase=_t(jax.random.uniform(k_phase, (1, NUM_FEATURES, d))),
        inducing=_t(jax.random.normal(k_u, (m, d))),
        x0=_t(jax.random.normal(k0, (NUM_SAMPLES, n, d))),
        states=_t(jax.random.normal(ks, (NUM_SAMPLES, n, t1, d))),
        segment_idx=None if segment_idx is None else _t(segment_idx))


def _terms_close(terms, jterms):
    for name in TERMS:
        np.testing.assert_allclose(float(getattr(terms, name).detach()),
                                   float(getattr(jterms, name)), rtol=1e-4,
                                   err_msg=name)


def _grads_close(tparams, jgrads):
    want = _flat(jgrads)
    for name, p in tparams.named_parameters():
        g = want[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * float(np.max(np.abs(g))),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# meters, metrics, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mean", "ema"])
def test_meter_matches_jax(mode):
    """One sequence of weighted updates: every field and the history equal."""
    vals = np.random.RandomState(0).randn(25)
    jm, tm = JMeter(mode, 0.9), Meter(mode, 0.9)
    assert not tm
    for i, v in enumerate(vals):
        jm.update(float(v), 3 * i, weight=1 + i % 3)
        tm.update(float(v), 3 * i, weight=1 + i % 3)
        assert vars(tm) == vars(jm)
    assert tm
    with pytest.raises(ValueError, match="mode"):
        Meter("median")


def test_mse_and_calibration_match_jax():
    rng = np.random.RandomState(1)
    actual = rng.randn(3, 7, 4).astype(np.float32)
    predicted = (actual[None] + 0.5 * rng.randn(6, 3, 7, 4)).astype(np.float32)
    noise_var = rng.uniform(0.1, 0.5, 4).astype(np.float32)
    np.testing.assert_allclose(tmetrics.compute_mse(actual, predicted[0], 2.0),
                               jmetrics.compute_mse(actual, predicted[0], 2.0),
                               rtol=1e-6)
    got = tmetrics.compute_calibration(actual, predicted, noise_var)
    want = jmetrics.compute_calibration(actual, predicted, noise_var)
    assert list(got["coverage"]) == list(want["coverage"]) == [0.5, 0.9, 0.95]
    np.testing.assert_allclose(list(got["coverage"].values()),
                               list(want["coverage"].values()), rtol=1e-6)
    np.testing.assert_allclose(got["pit_mae"], want["pit_mae"], rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_optax(schedule):
    n = 40
    cfg = tt.TrainConfig(num_iter=n, lr=5e-3, lr_schedule=schedule)
    want = (optax.cosine_decay_schedule(5e-3, n, alpha=0.01)
            if schedule == "cosine" else optax.constant_schedule(5e-3))
    got = tt.lr_schedule(cfg)
    for count in (0, 1, n // 2, n - 1, n, 2 * n):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   err_msg=str(count))
    with pytest.raises(ValueError, match="lr_schedule"):
        tt.lr_schedule(dataclasses.replace(cfg, lr_schedule="linear"))


# ---------------------------------------------------------------------------
# the Trainer against make_train_step
# ---------------------------------------------------------------------------

def _jax_subkeys(key, n):
    """The sub-keys n JAX steps draw their noise from, starting at `key`."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def test_trainer_adam_clip_and_cosine_match_jax(problem):
    """Three Trainer steps (cosine schedule over 3 iterations, global-norm
    clip 1.0 under a gradient norm above 10, the constraint frozen as
    run_mocap freezes it) against the
    JAX package's `make_train_step` with the same optimizer, on the JAX
    step noise: every loss and every parameter within 1e-4."""
    jparams, ys, ts, _ = problem
    n = 3
    opt = jt.default_optimizer(optax.cosine_decay_schedule(5e-3, n, alpha=0.01),
                               grad_clip=1.0)
    mask = jt.build_frozen_mask(jparams, jb.default_frozen_predicate(J_ARGS))
    jstep = jt.make_train_step(jb.shooting_loss_fn(J_ARGS), opt,
                               frozen_mask=mask)
    key = jax.random.PRNGKey(11)
    subs = _jax_subkeys(key, n)
    noises = [_step_noise(s, jparams) for s in subs]

    p, opt_state, jlosses = jparams, opt.init(jparams), []
    for _ in subs:
        p, opt_state, key, jterms = jstep(p, opt_state, key, jnp.asarray(ys),
                                          jnp.asarray(ts))
        jlosses.append(float(jterms.loss))

    tparams = _port(jparams)
    loss, _ = tb.shooting_loss_fn(T_ARGS)(tparams, noises[0], _t(ys), _t(ts))
    loss.backward()
    frozen = tb.default_frozen_predicate(T_ARGS)
    norm = torch.sqrt(sum(torch.sum(torch.square(q.grad))
                          for n, q in tparams.named_parameters()
                          if not frozen(n)))
    assert float(norm) > 10.0          # the clip acts
    trainer = tt.Trainer(tb.shooting_loss_fn(T_ARGS),
                         tt.TrainConfig(num_iter=n, lr=5e-3,
                                        lr_schedule="cosine", grad_clip=1.0,
                                        log_freq=0),
                         lambda params, gen: noises.pop(0),
                         frozen_predicate=tb.default_frozen_predicate(T_ARGS))
    _, state, _ = trainer.train(tparams, torch.Generator(), _t(ys), _t(ts))
    assert state["count"] == n and trainer.loss_meter.iters == [1, 2, 3]
    np.testing.assert_allclose(trainer.loss_meter.vals, jlosses, rtol=1e-4)
    want, got = _flat(p), params_to_numpy(tparams)
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(got["constraint.raw_scale"],
                                  _flat(jparams)["constraint.raw_scale"])


# ---------------------------------------------------------------------------
# constraint annealing
# ---------------------------------------------------------------------------

ANNEAL = dict(constraint_anneal_iters=8, constraint_anneal_start=0.1)


def test_annealer_matches_jax(problem):
    jparams = problem[0]
    janneal = jb.constraint_annealer(dataclasses.replace(J_ARGS, **ANNEAL))
    tanneal = tb.constraint_annealer(dataclasses.replace(T_ARGS, **ANNEAL))
    assert tb.constraint_annealer(T_ARGS) is None
    for itr in (0, 1, 4, 8, 16):
        want = janneal(jparams, jnp.float32(itr)).constraint.raw_scale
        got = tanneal(torch.tensor(float(itr)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(softplus(got)),
                                   float(jax.nn.softplus(want[0])),
                                   rtol=1e-6, err_msg=str(itr))
    np.testing.assert_allclose(float(softplus(tanneal(torch.tensor(8.0)))),
                               J_ARGS.constraint_initial_scale, rtol=1e-5)


def test_annealed_shooting_loss_matches_jax(problem):
    """The annealed loss mid-horizon on shared noise: terms rtol 1e-4,
    gradients rtol 1e-3."""
    jparams, ys, ts, _ = problem
    jargs = dataclasses.replace(J_ARGS, **ANNEAL)
    targs = dataclasses.replace(T_ARGS, **ANNEAL)
    sub = jax.random.PRNGKey(5)
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(
        jb.shooting_loss_fn(jargs), has_aux=True))(
            jparams, sub, jnp.float32(3.0), jnp.asarray(ys), jnp.asarray(ts))
    tparams = _port(jparams, targs)
    loss, terms = tb.shooting_loss_fn(targs)(
        tparams, _step_noise(sub, jparams), torch.tensor(3.0), _t(ys), _t(ts))
    loss.backward()
    _terms_close(terms, jterms)
    _grads_close(tparams, jgrads)
    # the annealed scale, not the parameter, enters the loss
    with torch.no_grad():
        plain, _ = tb.shooting_loss_fn(T_ARGS)(
            tparams, _step_noise(sub, jparams), _t(ys), _t(ts))
    assert abs(float(plain) - float(loss.detach())) > 1e-3 * abs(float(plain))


# ---------------------------------------------------------------------------
# segment minibatching
# ---------------------------------------------------------------------------

def test_segment_minibatch_elbo_matches_jax(problem):
    """`elbo_loss` on K=4 given segments (the final one among them, whose
    continuity term is masked) against JAX's `segment_idx` hook."""
    jparams, ys, ts, _ = problem
    idx = np.array([7, 0, SEQLEN - 1, 3], dtype=np.int64)
    sub = jax.random.PRNGKey(9)
    cfg = J_ARGS.solver_config()

    def jloss(p):
        return jshooting.elbo_loss(sub, p, jnp.asarray(ys), jnp.asarray(ts),
                                   cfg, NUM_FEATURES, num_samples=NUM_SAMPLES,
                                   segment_idx=jnp.asarray(idx))

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    tparams = _port(jparams)
    loss, terms = tshooting.elbo_loss(tparams, _step_noise(sub, jparams, idx),
                                      _t(ys), _t(ts), T_ARGS.solver_config())
    loss.backward()
    _terms_close(terms, jterms)
    _grads_close(tparams, jgrads)


def test_single_segment_losses_average_to_the_full_loss(problem):
    """The estimator is unbiased: over the T one-segment batches (K=1) on
    one draw and one state sample, the mean loss is the full loss."""
    jparams, ys, ts, _ = problem
    tparams = _port(jparams)
    noise = _step_noise(jax.random.PRNGKey(2), jparams)
    cfg = T_ARGS.solver_config()
    with torch.no_grad():
        full, _ = tshooting.elbo_loss(tparams, noise, _t(ys), _t(ts), cfg)
        losses = [tshooting.elbo_loss(
            tparams, dataclasses.replace(noise, segment_idx=torch.tensor([i])),
            _t(ys), _t(ts), cfg)[0] for i in range(SEQLEN)]
    np.testing.assert_allclose(float(torch.stack(losses).mean()), float(full),
                               rtol=1e-5)


def test_sampled_segment_indices():
    params = _port_like_problem()
    gen = torch.Generator().manual_seed(0)
    for k in (1, 5, SEQLEN - 1):
        idx = tshooting.sample_step_noise(params, NUM_FEATURES, 2, gen,
                                          segment_minibatch=k).segment_idx
        assert idx.shape == (k,) and idx.dtype == torch.int64
        assert len(set(idx.tolist())) == k
        assert 0 <= int(idx.min()) and int(idx.max()) < SEQLEN
    for k in (0, SEQLEN, SEQLEN + 3):   # off, or not fewer than T
        assert tshooting.sample_step_noise(
            params, NUM_FEATURES, 2, gen, segment_minibatch=k).segment_idx is None
    # the other draws are those of a full step
    a = tshooting.sample_step_noise(params, NUM_FEATURES, 2,
                                    torch.Generator().manual_seed(4))
    b = tshooting.sample_step_noise(params, NUM_FEATURES, 2,
                                    torch.Generator().manual_seed(4),
                                    segment_minibatch=5)
    for f in ("rff_weights", "rff_freq", "rff_phase", "inducing", "x0",
              "states"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("k,kernel", [(8, False), (9, True), (16, True)])
def test_minibatched_rows_and_the_kernel_rule(k, kernel):
    """At MoCap-09 (5 draws x 6 sequences) a step of K segments integrates
    30 K rows: the dispatch rule (256 rows) takes the segment kernels from
    K = 9 at the official widths (M=100, S=256, D=5)."""
    gp_params = tgp.init_svgp(torch.Generator().manual_seed(0), 5, 5, 100,
                              device="cpu")
    for name in ("dopri5_attempt", "rk4_segment"):
        assert tgp.kernel_rhs_active(gp_params, 5 * 6 * k, 256, name) is kernel


def _port_like_problem():
    gen = torch.Generator().manual_seed(0)
    return tb.build_shooting(gen, T_ARGS, np.zeros((N_SEQ, SEQLEN, 5),
                                                   np.float32), device="cpu")


# ---------------------------------------------------------------------------
# the vanilla model's x0 init
# ---------------------------------------------------------------------------

def test_initialize_latents_with_data_matches_jax(problem):
    """The vanilla q(x0) mean by backward integration over 4 draws: JAX's
    keys, their noise in the port."""
    _, _, ts, ys_pca = problem
    jargs = jb.ModelArgs(num_inducing=8, num_features=NUM_FEATURES)
    jparams = jb.build_gpode(jax.random.PRNGKey(1), jargs, ys_pca)
    key, draws = jax.random.PRNGKey(7), 4
    cfg = dict(solver="rk4", ts_dense_scale=2, max_steps=512)
    want = jax.jit(lambda k, p: jinit.initialize_latents_with_data(
        k, p, ys_pca, ts, JSolverConfig(**cfg), NUM_FEATURES,
        num_samples=draws))(key, jparams)
    tparams = gpode_params_from_numpy(_flat(jparams), device="cpu")
    m, d = jparams.gp.u_mean.shape

    def draw_noise(k):
        k_w, k_omega, k_phase, k_u = jax.random.split(k, 4)
        return (jax.random.normal(k_w, (NUM_FEATURES, d)),
                jax.random.normal(k_omega, (d, NUM_FEATURES, d)),
                jax.random.uniform(k_phase, (1, NUM_FEATURES, d)),
                jax.random.normal(k_u, (m, d)))

    noise = tgpode.PredictNoise(*map(_t, jax.vmap(draw_noise)(
        jax.random.split(key, draws))))
    got = tinit.initialize_latents_with_data(tparams, noise, ys_pca, ts,
                                             SolverConfig(**cfg))
    assert got is tparams
    w = np.asarray(want.x0.mean)
    np.testing.assert_allclose(tparams.x0.mean.detach().numpy(), w, rtol=1e-4,
                               atol=1e-5 * float(np.max(np.abs(w))))
    np.testing.assert_array_equal(tparams.x0.tril_packed.detach().numpy(),
                                  np.asarray(jparams.x0.tril_packed))


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(problem, tmp_path):
    jparams = problem[0]
    tparams = _port(jparams)
    adam = tt.Adam(tparams, 5e-3)
    for mu in adam.mu:
        mu.normal_()
    adam.count = 17
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, generator=gen)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"params": tparams, "opt_state": adam.state(),
                           "generator": gen, "step": 17, "val_ll": -1.25})
    assert not os.path.exists(path + ".tmp")
    got = load_checkpoint(path)
    assert int(got["step"]) == 17 and float(got["val_ll"]) == -1.25
    assert torch.equal(got["generator_state"], gen.get_state())
    want = params_to_numpy(tparams)
    assert set(got["params"]) == set(want) == set(_flat(jparams))
    for name, a in want.items():
        np.testing.assert_array_equal(got["params"][name], a)
    restored = tt.Adam(tparams, 5e-3)
    restored.load_state(got["opt_state"])
    assert restored.count == 17
    for a, b in zip(restored.mu + restored.nu, adam.mu + adam.nu):
        assert torch.equal(a, b)
    rebuilt = params_like(tparams, got["params"], T_ARGS)
    for (n, a), (_, b) in zip(rebuilt.named_parameters(),
                              tparams.named_parameters()):
        assert torch.equal(a, b), n
    # a checkpoint of another model fails loudly
    other = tb.build_shooting(torch.Generator().manual_seed(0),
                              dataclasses.replace(T_ARGS, num_inducing=9),
                              np.zeros((N_SEQ, SEQLEN, 5), np.float32),
                              projector=None, device="cpu")
    with pytest.raises(ValueError, match="gp.z"):
        params_like(other, got["params"], T_ARGS)
    with pytest.raises(KeyError):
        save_checkpoint(path, {"params": tparams, "note": 1})


def _noise_fn(params, gen):
    return tshooting.sample_step_noise(params, NUM_FEATURES, NUM_SAMPLES, gen)


def _train(jparams, ys, ts, num_iter, path, start_iter=1, state=None):
    """`num_iter` Trainer iterations from `jparams` or from a checkpoint
    `state`; returns (params, trainer)."""
    tparams = _port(jparams)
    gen = torch.Generator().manual_seed(21)
    opt_state = None
    if state is not None:
        tparams = params_like(tparams, state["params"], T_ARGS)
        gen.set_state(state["generator_state"])
        opt_state = state["opt_state"]
    trainer = tt.Trainer(tb.shooting_loss_fn(T_ARGS),
                         tt.TrainConfig(num_iter=num_iter, log_freq=0,
                                        checkpoint_every=3),
                         _noise_fn, checkpoint_path=path,
                         frozen_predicate=tb.default_frozen_predicate(T_ARGS))
    tparams, _, _ = trainer.train(tparams, gen, _t(ys), _t(ts),
                                  start_iter=start_iter, opt_state=opt_state)
    return tparams, trainer


def test_resume_is_bit_equal(problem, tmp_path):
    """6 steps in one run against 3 steps, a checkpoint, and 3 resumed
    steps: the same losses and parameters, bit for bit."""
    jparams, ys, ts, _ = problem
    one, one_tr = _train(jparams, ys, ts, 6, str(tmp_path / "a.npz"))
    _train(jparams, ys, ts, 3, str(tmp_path / "b.npz"))
    state = load_checkpoint(str(tmp_path / "b.npz"))
    assert int(state["step"]) == 3 and state["opt_state"]["count"] == 3
    two, two_tr = _train(jparams, ys, ts, 6, str(tmp_path / "b.npz"),
                         start_iter=4, state=state)
    assert two_tr.loss_meter.iters == [4, 5, 6]
    assert two_tr.loss_meter.vals == one_tr.loss_meter.vals[3:]
    for (n, a), (_, b) in zip(one.named_parameters(), two.named_parameters()):
        assert torch.equal(a, b), n
    final = load_checkpoint(str(tmp_path / "b.npz"))
    assert int(final["step"]) == 6


# ---------------------------------------------------------------------------
# the loop's health warning, interrupt and trace
# ---------------------------------------------------------------------------

class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))


def _toy_loss(starved, interrupt_at=None):
    """A loss over `_Toy` whose terms report `ncov` 3 of 26 at the steps in
    `starved` (the noise is the step's iteration)."""

    def loss_fn(params, itr):
        if itr == interrupt_at:
            raise KeyboardInterrupt
        loss = torch.sum(torch.square(params.w - itr))
        return loss, tgpode.ELBOTerms(loss=loss, observ_nll=loss, x0_kl=loss,
                                      inducing_kl=loss, nfe=7, natt=1,
                                      ncov=3 if itr in starved else 26)

    return loss_fn


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _toy_trainer(loss_fn, num_iter, log_freq):
    logger = logging.getLogger("test_torch_trainer")
    logger.handlers.clear()
    logger.propagate = False
    records = _Records()
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    counter = iter(range(1, num_iter + 1))
    trainer = tt.Trainer(loss_fn, tt.TrainConfig(num_iter=num_iter,
                                                 log_freq=log_freq,
                                                 ncov_expected=26),
                         lambda params, gen: next(counter), logger=logger)
    return trainer, records


def test_ncov_warning_fires_once():
    """Starved steps at 5 and 13: one warning, at the first drain after 5
    (the backoff holds the second back)."""
    trainer, records = _toy_trainer(_toy_loss({5, 13}), 20, 4)
    trainer.train(_Toy(), torch.Generator())
    warnings = [m for m in records.lines if m.startswith("WARNING")]
    assert len(warnings) == 1
    assert "near iter 8" in warnings[0] and "covered 3/26" in warnings[0]
    logs = [m for m in records.lines if m.startswith("Iter ")]
    assert len(logs) == 5 and "COV 26/26" in logs[-1] and "XS KL" not in logs[-1]
    assert trainer.last_ncov == 26 and trainer.last_nfe == 7


def test_keyboard_interrupt_drains_and_returns():
    trainer, records = _toy_trainer(_toy_loss(set(), interrupt_at=4), 10, 0)
    params, state, _ = trainer.train(_Toy(), torch.Generator())
    assert records.lines == ["Stopping optimization"]
    assert trainer.loss_meter.iters == [1, 2, 3] and state["count"] == 3
    assert torch.all(params.w > 1.0)


def test_save_trace_matches_jax(tmp_path):
    """The same meter updates dumped by both packages: one JSON."""
    jtrainer = jt.Trainer(lambda p, k, *b: (0.0, None), jt.TrainConfig())
    ttrainer = tt.Trainer(None, tt.TrainConfig(), None)
    vals = np.random.RandomState(4).randn(6, 5)
    extras = []
    for tr in (jtrainer, ttrainer):
        extra = {"val_ll": Meter(), "val_mse": Meter()}
        for i, row in enumerate(vals):
            for meter, v in zip((tr.loss_meter, tr.observ_nll_meter,
                                 tr.state_kl_meter, tr.init_kl_meter,
                                 tr.inducing_kl_meter), row):
                meter.update(float(v), i + 1)
            tr.time_meter.update(0.01 * (i + 1), i + 1)
            extra["val_ll"].update(float(row[0]), 10 * i)
        extras.append(extra)
    jt.save_trace(jtrainer, str(tmp_path / "j.json"), extra=extras[0])
    tt.save_trace(ttrainer, str(tmp_path / "t.json"), extra=extras[1])
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert set(got) == {"loss", "observ_nll", "state_kl", "x0_kl",
                        "inducing_kl", "step_time", "val_ll"}
