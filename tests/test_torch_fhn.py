"""FitzHugh-Nagumo in the port against the JAX package, on the CPU: the
simulated data on both branches of the native host library and the shipped
interpolation splits (data rtol 1e-6), the masked shooting ELBO with and
without a segment minibatch (terms rtol 1e-4; gradients rtol 1e-3, atol
1e-3 * max|g| per leaf, on the JAX package's step noise), and the drivers
`run_fhn` and `run_fhn_interpolation` at a tiny size: the JAX driver's
artifacts, prediction keys and shapes, and metric keys.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.data.fhn import FHN as JFHN
from gpode_tpu.data.fhn import load_fhn_interpolation as j_load_interp
from gpode_tpu.models import shooting as jshooting
from gpode_tpu.train import builders as jb
from gpode_tpu.train import experiments as jex

from gpode_tpu_torch.convert import params_from_numpy
from gpode_tpu_torch.data.fhn import FHN, load_fhn_interpolation
from gpode_tpu_torch.models import shooting as tshooting
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import experiments as tex

from test_torch_native import same_branch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FHN_DIR = os.path.join(REPO, "data", "fhn")
TERMS = ("loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl")
KW = dict(num_inducing=8, num_features=16, solver="rk4", ts_dense_scale=2,
          num_samples=2)
TINY = dict(num_inducing=4, num_features=8, num_iter=2, log_freq=1,
            eval_sample_size=2, solver="rk4", ts_dense_scale=2, data_obs_s=8,
            data_obs_t=2.0, plots=False, num_samples=2, data_path=FHN_DIR)
RUN_FILES = {"checkpt.npz", "logs", "model_predictions.npz",
             "optimization_trace.json", "train_args.json"}


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
def test_fhn_data_matches_jax(native):
    kw = dict(s_train=30, t_train=6.0, noise_var=0.025)
    with pytest.MonkeyPatch.context() as mp:
        same_branch(mp, native)
        got, want = FHN(**kw), JFHN(**kw)
    for name in ("trn", "tst"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.ys.dtype == np.float32 and a.ys.shape == b.ys.shape
        np.testing.assert_allclose(a.ys, b.ys, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(a.ts, b.ts, rtol=1e-6, err_msg=name)
    assert got.tst.ys.shape == (1, 60, 2)
    np.testing.assert_allclose(got.f([0.3, -1.2]), want.f([0.3, -1.2]))
    assert (got.xlim, got.ylim) == (want.xlim, want.ylim)


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_interpolation_split_loads_as_in_jax(small):
    got, want = load_fhn_interpolation(FHN_DIR, small), j_load_interp(FHN_DIR, small)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the masked shooting ELBO
# ---------------------------------------------------------------------------

def _step_noise(sub, params, num_samples, features, idx):
    """The noise `shooting.elbo_loss(sub, ...)` draws, as tensors."""
    k_draw, k_ss = jax.random.split(sub)
    k0, ks = jax.random.split(k_ss)
    n, t1, d = params.states.mean.shape
    m, din = params.gp.z.shape
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)

    def t(a):
        return torch.tensor(np.asarray(a))

    return tshooting.StepNoise(
        rff_weights=t(jax.random.normal(k_w, (features, d))),
        rff_freq=t(jax.random.normal(k_omega, (din, features, d))),
        rff_phase=t(jax.random.uniform(k_phase, (1, features, d))),
        inducing=t(jax.random.normal(k_u, (m, d))),
        x0=t(jax.random.normal(k0, (num_samples, n, d))),
        states=t(jax.random.normal(ks, (num_samples, n, t1, d))),
        segment_idx=None if idx is None else torch.tensor(idx))


@pytest.mark.parametrize("idx", [None, [0, 3, 11, 24]],
                         ids=["all_segments", "segment_minibatch"])
def test_masked_shooting_elbo_matches_jax(idx):
    """The FHN interpolation problem (small split: 25 grid points, 6 held
    out and zero-filled) through both packages' shooting ELBO with the
    observation mask."""
    split = j_load_interp(FHN_DIR, small=True)
    mask = split["interpolation_mask"]
    ys = np.where(mask[None, :, None], 0.0, split["full_ys"]).astype(np.float32)
    ts = split["full_ts"]
    obs_mask = np.broadcast_to(~mask, ys.shape[:2]).astype(np.float32)
    j_args = jb.ModelArgs(**KW)
    params = jb.build_shooting(jax.random.PRNGKey(3), j_args, ys)
    rng = np.random.default_rng(0)
    params = params._replace(states=params.states._replace(
        mean=jnp.asarray(ys[:, :-1] + 0.1 * rng.normal(size=ys[:, :-1].shape),
                         jnp.float32)))
    sub = jax.random.PRNGKey(8)
    cfg = j_args.solver_config()

    def j_loss(p):
        return jshooting.elbo_loss(sub, p, jnp.asarray(ys), jnp.asarray(ts),
                                   cfg, KW["num_features"],
                                   num_samples=KW["num_samples"],
                                   obs_mask=jnp.asarray(obs_mask),
                                   segment_idx=idx)

    (_, jterms), jgrads = jax.value_and_grad(j_loss, has_aux=True)(params)
    t_args = tb.ModelArgs(**KW)
    tparams = params_from_numpy(_flat(params), t_args, device="cpu")
    noise = _step_noise(sub, params, KW["num_samples"], KW["num_features"], idx)
    loss, terms = tshooting.elbo_loss(tparams, noise, torch.tensor(ys),
                                      torch.tensor(ts), t_args.solver_config(),
                                      obs_mask=torch.tensor(obs_mask))
    loss.backward()
    for name in TERMS:
        np.testing.assert_allclose(float(getattr(terms, name).detach()),
                                   float(getattr(jterms, name)), rtol=1e-4,
                                   err_msg=name)
    want = _flat(jgrads)
    got = dict(tparams.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * float(np.max(np.abs(g))),
                                   err_msg=name)


def test_the_mask_drops_held_out_points_from_the_likelihood():
    """Changing the hidden entries' values leaves the masked ELBO as it is;
    without the mask it moves."""
    split = load_fhn_interpolation(FHN_DIR, small=True)
    mask = split["interpolation_mask"]
    ys = np.where(mask[None, :, None], 0.0, split["full_ys"]).astype(np.float32)
    obs_mask = torch.tensor(np.broadcast_to(~mask, ys.shape[:2])
                            .astype(np.float32))
    args = tb.ModelArgs(**KW)
    params = tb.build_shooting(torch.Generator().manual_seed(0), args, ys,
                               device="cpu")
    noise = tshooting.sample_step_noise(params, 16, 2,
                                        torch.Generator().manual_seed(1))
    ts = torch.tensor(split["full_ts"])
    cfg = args.solver_config()
    moved = ys.copy()
    moved[:, mask] = 5.0
    with torch.no_grad():
        a, b = (float(tshooting.elbo_loss(params, noise, torch.tensor(y), ts,
                                          cfg, obs_mask=obs_mask)[0])
                for y in (ys, moved))
        c, d = (float(tshooting.elbo_loss(params, noise, torch.tensor(y), ts,
                                          cfg)[0]) for y in (ys, moved))
    assert a == b and c != d


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX drivers at the tiny size: {name: (metrics, prediction
    shapes, files)}."""
    out = {}
    for name, run in (
            ("fhn", lambda a: jex.run_fhn(a, shooting_variant=False)),
            ("interpolation", lambda a: jex.run_fhn_interpolation(
                a, small=True, shooting_variant=True))):
        save = str(tmp_path_factory.mktemp(f"jax_{name}"))
        _, _, metrics = run(jex.ExperimentArgs(save=save, **TINY))
        with np.load(os.path.join(save, "model_predictions.npz")) as z:
            shapes = {k: z[k].shape for k in z.files}
        out[name] = (metrics, shapes, set(os.listdir(save)))
    return out


@pytest.mark.parametrize("shooting", [False, True], ids=["vanilla", "shooting"])
@pytest.mark.parametrize("driver", ["fhn", "interpolation"])
def test_fhn_drivers_write_the_jax_artifacts(driver, shooting, jax_runs,
                                             tmp_path):
    args = tex.ExperimentArgs(save=str(tmp_path), device="cpu", **TINY)
    if driver == "fhn":
        _, trainer, metrics = tex.run_fhn(args, shooting_variant=shooting)
    else:
        _, trainer, metrics = tex.run_fhn_interpolation(
            args, small=True, shooting_variant=shooting)
    want_metrics, want_shapes, want_files = jax_runs[driver]
    assert set(metrics) == set(want_metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    with np.load(tmp_path / "model_predictions.npz") as z:
        assert {k: z[k].shape for k in z.files} == want_shapes
    assert set(os.listdir(tmp_path)) == want_files == RUN_FILES
    assert trainer.cfg.num_iter == 2 and np.all(np.isfinite(
        trainer.loss_meter.vals))
