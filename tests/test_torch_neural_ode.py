"""The port's neural-ODE baseline (`gpode_tpu_torch/models/neural_ode.py`)
against the JAX package's, on the CPU, on weights carried across by
`convert.py`: `mlp_rhs` (rtol 1e-5), `neural_ode_forward` under dopri5 and
rk4 (states rtol 1e-5, the solver counts equal), `mse_loss` (rtol 1e-5) and
its gradients (rtol 1e-3, atol 1e-3 * max|g| per leaf); a JAX checkpoint
loading through `params_like`; and both twins at a tiny CPU run (the JAX
scripts' artifacts, finite MSE).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.models import neural_ode as jnode
from gpode_tpu.models.flow import SolverConfig as JSolverConfig
from gpode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from gpode_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from gpode_tpu_torch.convert import neural_ode_params_from_numpy, params_like
from gpode_tpu_torch.models import neural_ode as tnode
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.scripts import train_mocap_neuralode, train_vdp_neuralode
from gpode_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [f"mlp.{n}" for n in ("w1", "b1", "w2", "b2", "w3", "b3")]
CFGS = {"dopri5": dict(solver="dopri5", max_steps=64),
        "rk4": dict(solver="rk4", ts_dense_scale=2)}


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module")
def weights():
    """(JAX params with non-zero biases, the port's copy)."""
    jp = jnode.init_neural_ode(jax.random.PRNGKey(0), 3, hidden=16)
    rng = np.random.default_rng(1)
    mlp = jp.mlp._replace(**{b: jnp.asarray(0.1 * rng.normal(
        size=getattr(jp.mlp, b).shape), jnp.float32) for b in ("b1", "b2", "b3")})
    jp = jp._replace(mlp=mlp)
    return jp, neural_ode_params_from_numpy(_flat(jp), device="cpu")


@pytest.fixture(scope="module")
def trajectories():
    rng = np.random.default_rng(2)
    ts = np.linspace(0.0, 1.5, 9).astype(np.float32)
    ys = rng.normal(size=(2, 9, 3)).astype(np.float32)
    return ys, ts


def test_names_and_init(weights):
    jp, tp = weights
    assert [n for n, _ in tp.named_parameters()] == NAMES == list(_flat(jp))
    init = tnode.init_neural_ode(torch.Generator().manual_seed(0), 3, 16,
                                 device="cpu")
    shapes = {n: tuple(p.shape) for n, p in init.named_parameters()}
    assert shapes == {n: a.shape for n, a in _flat(jp).items()}
    for name, p in init.named_parameters():
        if name.startswith("mlp.b"):
            assert not torch.any(p)
        else:
            assert abs(float(p.detach().std()) - 0.1) < 0.05


def test_mlp_rhs_matches_jax(weights):
    jp, tp = weights
    x = np.random.default_rng(3).normal(size=(4, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(tnode.mlp_rhs(tp, torch.tensor(x)).detach(),
                               jnode.mlp_rhs(jp, jnp.asarray(x)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("solver", list(CFGS))
def test_forward_loss_and_gradients_match_jax(weights, trajectories, solver):
    jp, tp = weights
    ys, ts = trajectories
    jcfg, tcfg = JSolverConfig(**CFGS[solver]), SolverConfig(**CFGS[solver])
    want, jstats = jnode.neural_ode_forward(jp, jnp.asarray(ys[:, 0]),
                                            jnp.asarray(ts), jcfg)
    got, tstats = tnode.neural_ode_forward(tp, torch.tensor(ys[:, 0]),
                                           torch.tensor(ts), tcfg)
    assert got.shape == (2, 9, 3)
    np.testing.assert_allclose(got.detach(), want, rtol=1e-5, atol=1e-6)
    assert tstats.num_rhs_evals == int(jstats.num_rhs_evals)
    assert tstats.num_covered == int(jstats.num_covered)

    def j_loss(p):
        return jnode.mse_loss(None, p, jnp.asarray(ys), jnp.asarray(ts), jcfg)

    (jl, jterms), jgrads = jax.value_and_grad(j_loss, has_aux=True)(jp)
    loss, terms = tnode.mse_loss(tp, tnode.no_noise(tp, None),
                                 torch.tensor(ys), torch.tensor(ts), tcfg)
    tp.zero_grad()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(terms.observ_nll) == float(loss) and terms.nfe == int(jterms.nfe)
    assert float(terms.x0_kl) == float(terms.inducing_kl) == 0.0
    got_g = dict(tp.named_parameters())
    for name, g in _flat(jgrads).items():
        np.testing.assert_allclose(got_g[name].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * float(np.max(np.abs(g))),
                                   err_msg=name)
    np.testing.assert_allclose(
        tnode.predict(tp, torch.tensor(ys[:, 0]), torch.tensor(ts), tcfg),
        jnode.predict(jp, jnp.asarray(ys[:, 0]), jnp.asarray(ts), jcfg),
        rtol=1e-5, atol=1e-6)


def test_a_jax_checkpoint_loads(weights, tmp_path):
    jp, _ = weights
    path = str(tmp_path / "checkpt.npz")
    j_save_checkpoint(path, {"params": jp})
    flat = _flat(j_load_checkpoint(path)["params"])
    template = tnode.init_neural_ode(torch.Generator().manual_seed(5), 3, 16,
                                     device="cpu")
    loaded = params_like(template, flat)
    assert isinstance(loaded, tnode.NeuralODEParams)
    for name, p in loaded.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[name])


TWINS = {
    "vdp": (train_vdp_neuralode, ["--data_obs_S", "12", "--data_obs_T", "3.0"],
            {"train_pred": (1, 12, 2), "test_pred": (1, 24, 2),
             "train_ys": (1, 12, 2), "test_ys": (1, 24, 2)},
            {"plt_longitudinal.png", "plt_vectorfield.png"}),
    "mocap": (train_mocap_neuralode,
              ["--data_path", os.path.join(REPO, "data", "mocap"),
               "--data_seqlen", "20"],
              {"train_pred_zs": (6, 20, 5), "train_pred_ys": (6, 20, 50),
               "test_pred_zs": (2, 120, 5), "test_pred_ys": (2, 120, 50)},
              {"plt_data_test.png", "plt_latents_test.png"}),
}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_runs_and_writes_the_jax_artifacts(name, tmp_path, capsys):
    twin, extra, shapes, pngs = TWINS[name]
    save = str(tmp_path / "run")
    assert twin.main(["--device", "cpu", "--num_iter", "3", "--log_freq", "1",
                      "--num_hidden", "16", "--save", save] + extra) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"train_mse", "test_mse"}
    assert all(np.isfinite(v) for v in line["metrics"].values())
    with np.load(os.path.join(save, "model_predictions.npz")) as z:
        assert {k: z[k].shape for k in z.files} == shapes
    files = set(os.listdir(save))
    assert {"checkpt.npz", "logs", "train_args.json"} | pngs <= files
    ck = load_checkpoint(os.path.join(save, "checkpt.npz"))
    assert sorted(ck["params"]) == sorted(NAMES)
    with open(os.path.join(save, "train_args.json")) as f:
        assert json.load(f)["num_hidden"] == 16
