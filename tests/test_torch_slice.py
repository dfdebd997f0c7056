"""The port's shooting train step as a whole against the JAX package's, on a
reduced MoCap-09 problem built by the JAX package, on the CPU.

The JAX params are flattened to {dotted path: array} and loaded with
`params_from_numpy`; the noise the JAX step draws from its key is rebuilt
with the same splits (`trainer.make_step_bodies` -> `shooting.elbo_loss` ->
`gp.draw_posterior` / `kernels.rbf_sample_freq` / `states.sample_*`) and fed
to the port as a `StepNoise`.

Tolerances: loss and the five ELBO terms rtol 1e-4; gradients rtol 1e-3 and
atol 1e-3 * max|g| per leaf (the class of tests/test_golden.py's iter-0
check); parameters after three Adam steps rtol 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.data.mocap import MocapDataset as JMocapDataset
from gpode_tpu.data.mocap import latent_to_data_projector as j_projector
from gpode_tpu.models.init import (initialize_inducing,
                                   initialize_kernel_parameters)
from gpode_tpu.train import builders as jb
from gpode_tpu.train.trainer import (build_frozen_mask, default_optimizer,
                                     make_train_step)

from gpode_tpu_torch.convert import params_from_numpy, params_to_numpy
from gpode_tpu_torch.models.shooting import StepNoise
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import trainer as tt
from gpode_tpu_torch.train.bench_setup import bench_model_args, load_bench_data

torch.set_num_threads(1)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mocap")
N_SEQ, SEQLEN = 2, 12
J_ARGS = jb.ModelArgs(num_inducing=8, num_features=32, dimwise=True,
                      solver="dopri5", ts_dense_scale=2, max_steps=8,
                      first_step=-1.0, num_samples=3)
T_ARGS = tb.ModelArgs(num_inducing=8, num_features=32, dimwise=True,
                      solver="dopri5", ts_dense_scale=2, max_steps=8,
                      first_step=-1.0, num_samples=3)
TERMS = ("loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl")


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module")
def problem():
    """A reduced MoCap-09 shooting problem: 2 sequences x 12 steps, 5 PCA
    latents, likelihood in the 50-D data space."""
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
    params = params._replace(gp=initialize_inducing(
        params.gp, ys_pca, float(data_pca.trn.ts.max()), 1e0,
        rng=np.random.RandomState(0)))
    return params, data_full.trn.ys[:N_SEQ], data_pca.trn.ts


def _step_noise(sub, params) -> StepNoise:
    """The noise `shooting.elbo_loss(sub, ...)` draws, as tensors."""
    k_draw, k_ss = jax.random.split(sub)
    k0, ks = jax.random.split(k_ss)
    n, t1, d = params.states.mean.shape
    m, din = params.gp.z.shape
    s, nf = J_ARGS.num_samples, J_ARGS.num_features
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)

    def t(a):
        return torch.tensor(np.asarray(a))

    return StepNoise(rff_weights=t(jax.random.normal(k_w, (nf, d))),
                     rff_freq=t(jax.random.normal(k_omega, (din, nf, d))),
                     rff_phase=t(jax.random.uniform(k_phase, (1, nf, d))),
                     inducing=t(jax.random.normal(k_u, (m, d))),
                     x0=t(jax.random.normal(k0, (s, n, d))),
                     states=t(jax.random.normal(ks, (s, n, t1, d))))


@pytest.mark.parametrize("kernels", [True, False],
                         ids=["attempt_path", "plain_path"])
def test_step0_loss_terms_and_gradients_match_jax(problem, kernels):
    params, ys, ts = problem
    sub = jax.random.PRNGKey(3)
    loss_fn = jb.shooting_loss_fn(J_ARGS)
    (_, jterms), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, sub, jnp.asarray(ys), jnp.asarray(ts))

    tparams = params_from_numpy(_flat(params), T_ARGS, device="cpu")
    loss, terms = tb.shooting_loss_fn(T_ARGS, kernels=kernels)(
        tparams, _step_noise(sub, params), torch.tensor(ys), torch.tensor(ts))
    loss.backward()
    for name in TERMS:
        np.testing.assert_allclose(float(getattr(terms, name)),
                                   float(getattr(jterms, name)), rtol=1e-4,
                                   err_msg=name)
    assert (terms.nfe, terms.natt) == (7, 1) == (int(jterms.nfe),
                                                  int(jterms.natt))
    want = _flat(jgrads)
    got = dict(tparams.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * float(np.max(np.abs(g))),
                                   err_msg=name)


@pytest.mark.parametrize("frozen", [False, True],
                         ids=["bench_no_mask", "run_mocap_constraint_frozen"])
def test_three_adam_steps_match_jax(problem, frozen):
    """bench.py's step trains every leaf (projector and constraint scale
    included); run_mocap freezes the constraint scale."""
    params, ys, ts = problem
    mask = (build_frozen_mask(params, jb.default_frozen_predicate(J_ARGS))
            if frozen else None)
    jstep = make_train_step(jb.shooting_loss_fn(J_ARGS),
                            default_optimizer(5e-3), frozen_mask=mask)
    opt = default_optimizer(5e-3)
    jparams, opt_state = params, opt.init(params)

    tparams = params_from_numpy(_flat(params), T_ARGS, device="cpu")
    topt = tt.default_optimizer(
        tparams, 5e-3,
        frozen_predicate=tb.default_frozen_predicate(T_ARGS) if frozen else None)
    tstep = tt.make_train_step(tb.shooting_loss_fn(T_ARGS, kernels=True),
                               tparams, topt)
    key = jax.random.PRNGKey(11)
    tys, tts = torch.tensor(ys), torch.tensor(ts)
    for _ in range(3):
        sub = jax.random.split(key)[1]  # the sub-key the JAX step will use
        tstep(_step_noise(sub, jparams), tys, tts)
        jparams, opt_state, key, _ = jstep(jparams, opt_state, key,
                                           jnp.asarray(ys), jnp.asarray(ts))
    want = _flat(jparams)
    got = params_to_numpy(tparams)
    for name, p in want.items():
        np.testing.assert_allclose(got[name], p, rtol=1e-3, atol=1e-6,
                                   err_msg=name)
    moved = not np.array_equal(want["constraint.raw_scale"],
                               _flat(params)["constraint.raw_scale"])
    assert moved != frozen


def test_bench_problem_data_matches_jax_pipeline():
    """The port's MoCap-09 bench data (numpy-only PCA copy) against the JAX
    package's MocapDataset on the same .npz."""
    data_pca, data_full = load_bench_data(DATA_DIR)
    jpca = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                         data_normalize=False, pca_normalize=True, seqlen=100)
    jfull = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=-1,
                          data_normalize=False, pca_normalize=False, seqlen=100)
    np.testing.assert_allclose(data_pca.trn.ys, jpca.trn.ys, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(data_pca.trn.ts, jpca.trn.ts, rtol=1e-5)
    np.testing.assert_allclose(data_full.trn.ys, jfull.trn.ys, rtol=1e-5)
    from gpode_tpu_torch.data.mocap import latent_to_data_projector
    tp, jp = latent_to_data_projector(data_pca), j_projector(jpca)
    for name in ("components", "norm_mean", "norm_std"):
        np.testing.assert_allclose(getattr(tp, name), getattr(jp, name),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert bench_model_args().num_inducing == 100
    assert data_pca.trn.ys.shape == (6, 100, 5)


def test_params_round_trip_through_numpy(problem):
    params, _, _ = problem
    flat = _flat(params)
    back = params_to_numpy(params_from_numpy(flat, T_ARGS, device="cpu"))
    assert set(back) == set(flat)
    for name, a in flat.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    with pytest.raises(KeyError):
        params_from_numpy({**flat, "gp.extra": flat["gp.z"]}, T_ARGS,
                          device="cpu")
