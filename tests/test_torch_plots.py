"""The port's plot suites (`gpode_tpu_torch/plots/`) on the CPU.

The data parts against the JAX package's (`gpode_tpu/plots/`) on the same
parameters and noise, rtol 1e-4 (atol 1e-5 * max|ref|): the sampled fields
on the 30x30 grid and on the 12x12 quiver grid (the noise rebuilt from the
JAX keys `key` and `fold_in(key, 1)`), the un-whitened inducing posterior,
the grid conditional and the shooting snapshot's mean trajectory (its
20-draw prediction from the JAX key's splits). Then the drawing parts: the
VDP and MoCap twins' png families of tests/test_plots.py with plots on at a
tiny size, the notebook variants, display mode, a plots-on twin run
training bit-equal to the same run with `--no_plots`, and a plots-on run
raising before any work where matplotlib does not import.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.data.vanderpol import VanderPol as JVanderPol
from gpode_tpu.models import gp as jgp
from gpode_tpu.models import gpode as jgpode
from gpode_tpu.plots import plots_2d as jplots
from gpode_tpu.train import builders as jb

from gpode_tpu_torch import plots as tplots_pkg
from gpode_tpu_torch.convert import gpode_params_from_numpy, params_from_numpy
from gpode_tpu_torch.data.vanderpol import VanderPol
from gpode_tpu_torch.models import gpode as tgpode
from gpode_tpu_torch.plots import notebook, plots_2d
from gpode_tpu_torch.scripts import (train_mocap_gpode_shooting,
                                     train_vdp_gpode, train_vdp_gpode_shooting)
from gpode_tpu_torch.train import builders as tb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VDP_KW = dict(s_train=8, t_train=2.0, s_test=12, t_test=3.0, noise_var=0.05)
KW = dict(num_inducing=8, num_features=16, solver="rk4", ts_dense_scale=2,
          max_steps=8, num_samples=2)
TINY = ["--device", "cpu", "--num_inducing", "8", "--num_features", "16",
        "--num_iter", "4", "--log_freq", "2", "--eval_sample_size", "4"]
TWINS = {
    "vdp": (train_vdp_gpode, TINY + ["--data_obs_S", "12", "--data_obs_T", "3.0"]),
    "vdp_shooting": (train_vdp_gpode_shooting,
                     TINY + ["--data_obs_S", "12", "--data_obs_T", "3.0",
                             "--num_samples", "2"]),
    "mocap_shooting": (train_mocap_gpode_shooting,
                       TINY + ["--data_path", os.path.join(REPO, "data", "mocap"),
                               "--data_seqlen", "20", "--val_freq", "2",
                               "--val_draws", "2", "--num_samples", "2"]),
}
# the png families of tests/test_plots.py
VDP_FAMILIES = ("model_before_initialization.png",
                "model_after_initialization.png", "plt_longitudinal.png",
                "plt_longitudinal_0.png", "plt_vectorfield.png",
                "plt_inducing_posterior.png", "plt_long_pred.png",
                "plt_longnoise_pred.png", "plt_longnoise_pred_single.png")
FAMILIES = {"vdp": VDP_FAMILIES,
            "vdp_shooting": VDP_FAMILIES + ("plt_shooting_states.png",),
            "mocap_shooting": ("plt_latents_after_optimization_train.png",
                               "plt_data_after_optimization_train.png",
                               "inducing_posterior_train.png",
                               "plt_latents_3d.png")}


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def vdp():
    return JVanderPol(**VDP_KW)


def _nontrivial(jp, seed=3):
    """A JAX SVGP with a non-trivial posterior scale and hyperparameters."""
    rng = np.random.default_rng(seed)
    jp = jp._replace(u_tril=jnp.asarray(0.3 * rng.normal(size=jp.u_tril.shape),
                                        jnp.float32),
                     u_mean=jnp.asarray(rng.normal(size=jp.u_mean.shape),
                                        jnp.float32))
    return jp._replace(kernel=jp.kernel._replace(
        raw_lengthscales=jnp.asarray(rng.uniform(0.2, 1.0, size=jp.kernel
                                                 .raw_lengthscales.shape),
                                     jnp.float32)))


@pytest.fixture(scope="module")
def vanilla(vdp):
    """(JAX GPODEParams, port copy) of a VDP model."""
    jparams = jb.build_gpode(jax.random.PRNGKey(0), jb.ModelArgs(**KW),
                             vdp.trn.ys)
    jparams = jparams._replace(gp=_nontrivial(jparams.gp))
    return jparams, gpode_params_from_numpy(_flat(jparams), device="cpu")


@pytest.fixture(scope="module")
def shooting(vdp):
    """(JAX ShootingParams, port copy) of a VDP shooting model."""
    jparams = jb.build_shooting(jax.random.PRNGKey(1), jb.ModelArgs(**KW),
                                vdp.trn.ys)
    jparams = jparams._replace(gp=_nontrivial(jparams.gp, seed=4))
    return jparams, params_from_numpy(_flat(jparams), tb.ModelArgs(**KW),
                                      device="cpu")


def _draw_noise(keys, jgp_params, features):
    """The noise `gp.draw_posterior(k, ...)` draws for each of `keys`, as
    a `PredictNoise` (x0 None)."""
    m, d = jgp_params.u_mean.shape
    din = jgp_params.z.shape[1]

    def one(k):
        k_w, k_omega, k_phase, k_u = jax.random.split(k, 4)
        return (jax.random.normal(k_w, (features, d)),
                jax.random.normal(k_omega, (din, features, d)),
                jax.random.uniform(k_phase, (1, features, d)),
                jax.random.normal(k_u, (m, d)))

    return tgpode.PredictNoise(*(torch.tensor(np.asarray(a))
                                 for a in jax.vmap(one)(keys)))


def _predict_noise(key, jparams, x0_post, num_draws, features):
    """The noise `gpode.predict(key, ...)` draws with q(x0) samples."""
    keys = jax.random.split(key, num_draws)
    noise = _draw_noise(jax.vmap(lambda k: jax.random.split(k)[0])(keys),
                        jparams.gp, features)
    n, d = x0_post.mean.shape
    noise.x0 = torch.tensor(np.asarray(jax.vmap(
        lambda k: jax.random.normal(jax.random.split(k)[1], (1, n, d))[0])(
            keys)))
    return noise


# ---------------------------------------------------------------------------
# data parts against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_size,fold", [(30, False), (12, True)],
                         ids=["fine_grid", "quiver_grid"])
def test_field_draws_match_jax(vdp, vanilla, grid_size, fold):
    jparams, tparams = vanilla
    key = jax.random.PRNGKey(7)
    key = jax.random.fold_in(key, 1) if fold else key
    _, _, grid = jplots._grid(vdp, grid_size)
    _, _, tgrid = plots_2d._grid(vdp, grid_size)
    np.testing.assert_array_equal(tgrid, grid)
    draws = 10
    want = jplots._field_draws(key, jparams.gp, grid, draws, KW["num_features"])
    noise = _draw_noise(jax.random.split(key, draws), jparams.gp,
                        KW["num_features"])
    got = plots_2d._field_draws(noise, tparams.gp, tgrid)
    assert got.shape == want.shape == (draws, grid_size ** 2, 2)
    _close(got, want, "field draws")
    _close(got.mean(0), want.mean(0), "draw mean")


@pytest.mark.parametrize("dimwise", [True, False], ids=["dimwise", "shared"])
def test_unwhiten_inducing_matches_jax(vdp, dimwise):
    jparams = jb.build_gpode(jax.random.PRNGKey(2),
                             jb.ModelArgs(**{**KW, "dimwise": dimwise}),
                             vdp.trn.ys)
    jparams = jparams._replace(gp=_nontrivial(jparams.gp, seed=5))
    tparams = gpode_params_from_numpy(_flat(jparams), device="cpu")
    (u, z), (ju, jz) = (plots_2d.unwhiten_inducing(tparams.gp),
                        jplots.unwhiten_inducing(jparams.gp))
    np.testing.assert_array_equal(z, jz)
    _close(u, ju, "u")


def test_grid_conditional_matches_jax(vdp, vanilla):
    jparams, tparams = vanilla
    xx, yy, mean, var = plots_2d.grid_conditional(tparams.gp, vdp)
    _, _, grid = jplots._grid(vdp)
    want_mean, want_var = jgp.conditional(jparams.gp, jnp.asarray(grid,
                                                                  jnp.float32))
    assert xx.shape == yy.shape == (30, 30)
    _close(mean, want_mean, "mean")
    _close(var, want_var, "var")


def test_shooting_snapshot_arrays_match_jax(vdp, shooting):
    """`plot_shooting_initialization`'s data: the mean trajectory of a
    20-draw prediction from q(x0) over the train grid and one extrapolated
    point, the grid conditional mean, the state means."""
    jparams, tparams = shooting
    cfg = jb.ModelArgs(**KW).solver_config()
    key = jax.random.PRNGKey(11)
    ts = np.asarray(vdp.trn.ts)
    ts_ext = jnp.asarray(np.concatenate([ts, [2 * ts[-1] - ts[-2]]]),
                         jnp.float32)
    vparams = jgpode.GPODEParams(gp=jparams.gp, x0=jparams.states.x0,
                                 likelihood=jparams.likelihood)
    want = np.asarray(jgpode.predict(key, vparams, ts_ext, cfg,
                                     KW["num_features"], num_draws=20)).mean(0)
    noise = _predict_noise(key, jparams, jparams.states.x0, 20,
                           KW["num_features"])
    got = plots_2d.shooting_initialization_arrays(
        tparams, vdp, tb.ModelArgs(**KW).solver_config(), noise)
    assert got["pred"].shape == (1, len(ts) + 1, 2)
    _close(got["pred"], want, "mean trajectory")
    mean, _ = jgp.conditional(jparams.gp, jnp.asarray(jplots._grid(vdp)[2],
                                                      jnp.float32))
    _close(got["mean"], mean, "grid mean")
    np.testing.assert_array_equal(got["states_mean"],
                                  np.asarray(jparams.states.mean))
    np.testing.assert_array_equal(got["x0_mean"],
                                  np.asarray(jparams.states.x0.mean))


# ---------------------------------------------------------------------------
# the drawing parts
# ---------------------------------------------------------------------------

def _pngs(path):
    return {f for f in os.listdir(path) if f.endswith(".png")}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_draws_every_family_and_trains_as_without_plots(name, tmp_path):
    """The twin with plots on writes every png family of tests/test_plots.py;
    its checkpoint is bit-equal to the same run's with `--no_plots` (the
    plots draw from their own streams)."""
    twin, argv = TWINS[name]
    on, off = str(tmp_path / "on"), str(tmp_path / "off")
    _, _, m_on = twin.run(argv + ["--save", on])
    _, _, m_off = twin.run(argv + ["--no_plots", "--save", off])
    missing = [f for f in FAMILIES[name] if f not in _pngs(on)]
    assert not missing, missing
    assert not _pngs(off)
    a, b = (np.load(os.path.join(d, "checkpt.npz")) for d in (on, off))
    assert set(a.files) == set(b.files) and "generator" in a.files
    for key in a.files:  # parameters, Adam, the train stream, the step
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert m_on == m_off


def _fake_pred(data, s=6):
    rng = np.random.default_rng(0)
    n, t, d = data.tst.ys.shape
    return data.tst.ys[None] + 0.1 * rng.normal(size=(s, n, t, d))


def test_notebook_variants_render(vanilla, shooting):
    """The inline variants run on the Agg backend (`show` draws nothing)."""
    data = VanderPol(**VDP_KW)
    _, params = vanilla
    _, sparams = shooting
    pred = _fake_pred(data)
    nv = params.likelihood.variance.detach().numpy()
    cfg = tb.ModelArgs(**KW).solver_config()
    notebook.show_longitudinal(data, pred, nv)
    notebook.show_longitudinal_per_sequence(data, pred, nv)
    notebook.show_vectorfield(params.gp, data, pred)
    notebook.show_vectorfield_posterior(params.gp, data, pred,
                                        generator=torch.Generator().manual_seed(1),
                                        num_features=16)
    notebook.show_inducing(params.gp, data)
    for p in (params, sparams):
        notebook.show_model_initialization(torch.Generator().manual_seed(2), p,
                                           data, cfg, 16, num_draws=3)
    a = notebook.vectorfield_posterior_arrays(params.gp, data)
    assert a["std"].shape == (900,) and np.all(a["std"] > 0)
    tplots_pkg.pyplot().close("all")


def test_display_mode_shows_instead_of_saving(tmp_path, monkeypatch):
    plt = tplots_pkg.pyplot()
    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(1))
    data = VanderPol(**VDP_KW)
    pred = _fake_pred(data)
    nv = np.full((2,), 0.05)
    out = str(tmp_path)
    plots_2d.set_display_mode(True)
    try:
        plots_2d.plot_longitudinal(data, pred, nv, out)
    finally:
        plots_2d.set_display_mode(False)
    assert shown, "display mode did not plt.show()"
    assert not os.listdir(out), "display mode still wrote files"
    plt.close("all")
    plots_2d.plot_longitudinal(data, pred, nv, out)  # save mode restored
    assert os.path.exists(os.path.join(out, "plt_longitudinal.png"))


def test_plots_without_matplotlib_raise_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(tplots_pkg, "_PYPLOT", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    save = tmp_path / "run"
    twin, argv = TWINS["vdp"]
    with pytest.raises(RuntimeError, match="--no_plots"):
        twin.run(argv + ["--save", str(save)])
    assert not save.exists()
    _, _, m = twin.run(argv + ["--no_plots", "--save", str(save)])
    assert np.isfinite(m["test_ll"])
