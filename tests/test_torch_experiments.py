"""The port's experiment drivers and their command lines, on the CPU.

`gpode_tpu_torch/train/experiments.py` (`ExperimentArgs`, `run_mocap`,
`run_vdp`) and the CLI twins under `gpode_tpu_torch/scripts/` (each
parser; the FHN and neural-ODE drivers run in tests/test_torch_fhn.py and
tests/test_torch_neural_ode.py), held to
the JAX package's: the dataclass's fields and defaults, each parser's
flags, defaults and choices (from `scripts/_cli.py` and the script's
`set_defaults`), the artifacts a run writes, resume, `--eval_only`, what is
refused before any work, each solver and memory flag training, and a JAX
checkpoint's parameters scored by the
port's evaluation on the JAX package's noise. The runs are tiny (M=8, 16
features, 6 iterations, validation every 3).
"""

from __future__ import annotations

import ast
import builtins
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.data.mocap import MocapDataset as JMocapDataset
from gpode_tpu.data.mocap import latent_to_data_projector as j_projector
from gpode_tpu.models import gpode as jgpode
from gpode_tpu.models import init as jinit
from gpode_tpu.models.likelihoods import project as j_project
from gpode_tpu.train import builders as jb
from gpode_tpu.train import experiments as jex
from gpode_tpu.train import metrics as jmetrics
from gpode_tpu.train.trainer import default_optimizer as j_default_optimizer
from gpode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from gpode_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from gpode_tpu_torch.data.mocap import MocapDataset, latent_to_data_projector
from gpode_tpu_torch.models import gpode as tgpode
from gpode_tpu_torch.scripts import (_cli, train_fhn_gpode,
                                     train_fhn_interpolation,
                                     train_mocap_gpode,
                                     train_mocap_gpode_shooting,
                                     train_mocap_neuralode, train_vdp_gpode,
                                     train_vdp_gpode_shooting,
                                     train_vdp_neuralode)
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import experiments as tex
from gpode_tpu_torch.train.metrics import compute_summary
from gpode_tpu_torch.utils import io as io_utils
from gpode_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

from test_torch_native import same_branch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "data", "mocap")
TWINS = {"train_mocap_gpode_shooting": train_mocap_gpode_shooting,
         "train_mocap_gpode": train_mocap_gpode,
         "train_vdp_gpode": train_vdp_gpode,
         "train_vdp_gpode_shooting": train_vdp_gpode_shooting,
         "train_fhn_gpode": train_fhn_gpode,
         "train_fhn_interpolation": train_fhn_interpolation,
         "train_vdp_neuralode": train_vdp_neuralode,
         "train_mocap_neuralode": train_mocap_neuralode}
TINY = ["--device", "cpu", "--no_plots", "--num_inducing", "8",
        "--num_features", "16", "--num_iter", "6", "--log_freq", "2",
        "--eval_sample_size", "4"]
MOCAP = TINY + ["--data_path", DATA_DIR, "--data_seqlen", "20",
                "--val_freq", "3", "--val_draws", "2"]
VDP = TINY + ["--data_obs_S", "12", "--data_obs_T", "3.0"]
SHOOTING = ["--num_samples", "2"]


# ---------------------------------------------------------------------------
# ExperimentArgs and the parsers
# ---------------------------------------------------------------------------

def test_experiment_args_are_the_jax_fields_and_defaults():
    """Every JAX field in its order with its default, then the port's
    `kernels` and `device`; `model_args` carries the shared fields."""
    jfields = [(f.name, f.default) for f in dataclasses.fields(jex.ExperimentArgs)]
    tfields = [(f.name, f.default) for f in dataclasses.fields(tex.ExperimentArgs)]
    assert tfields == jfields + [("kernels", None), ("device", None)]
    args = tex.ExperimentArgs(segment_minibatch=7, constraint_anneal_iters=9)
    jm = dataclasses.asdict(jex.ExperimentArgs(
        segment_minibatch=7, constraint_anneal_iters=9).model_args())
    assert dataclasses.asdict(args.model_args()) == jm


def _jax_cli(monkeypatch, tmp_path):
    """`scripts/_cli.py` as a module, without its JAX cache set-up."""
    monkeypatch.setenv("GPODE_TPU_JAX_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "_jax_cli", os.path.join(REPO, "scripts", "_cli.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _literal(node):
    return (getattr(builtins, node.id) if isinstance(node, ast.Name)
            else ast.literal_eval(node))


def _jax_script(jcli, name):
    """(the JAX script's parser, its set_defaults) from its source: the
    `add_*_flags` it calls, its own `parser.add_argument` calls and the
    keywords of its `set_defaults`."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    names = [c.func.id if isinstance(c.func, ast.Name) else c.func.attr
             for c in calls]
    desc = ast.literal_eval(calls[names.index("base_parser")].args[0])
    parser = jcli.base_parser(desc)
    for adder in ("add_vdp_flags", "add_mocap_flags", "add_shooting_flags"):
        if adder in names:
            getattr(jcli, adder)(parser)
    for call, called in zip(calls, names):
        if called == "add_argument":
            parser.add_argument(*map(_literal, call.args),
                                **{k.arg: _literal(k.value)
                                   for k in call.keywords})
    defaults = {k.arg: ast.literal_eval(k.value)
                for k in calls[names.index("set_defaults")].keywords}
    parser.set_defaults(**defaults)
    return parser, defaults


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), parser.get_default(a.dest),
                     a.choices and tuple(a.choices),
                     getattr(a.type, "__name__", a.type), a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_parser_matches_the_jax_script(name, monkeypatch, tmp_path):
    """Each twin's flags: the JAX script's dest, option strings, defaults
    (its `set_defaults` included), choices and types, plus `--device`; the
    parsed defaults give the JAX driver's ExperimentArgs."""
    jparser, defaults = _jax_script(_jax_cli(monkeypatch, tmp_path), name)
    tparser = TWINS[name].parser()
    want, got = _flags(jparser), _flags(tparser)
    assert got.pop("device") == (("--device",), None, None, "str", None, None)
    assert got == want
    assert tparser.prog == jparser.prog
    for key, value in defaults.items():
        assert tparser.get_default(key) == value
    jcli = _jax_cli(monkeypatch, tmp_path)
    jargs = dataclasses.asdict(jcli.to_experiment_args(jparser.parse_args([])))
    targs = dataclasses.asdict(_cli.to_experiment_args(tparser.parse_args([])))
    assert targs.pop("kernels") is None and targs.pop("device") is None
    assert targs == jargs


@pytest.mark.parametrize("flag,kernels", [("auto", None), ("true", True),
                                          ("false", False)])
def test_pallas_rhs_maps_to_the_kernel_rule(flag, kernels):
    args = _cli.to_experiment_args(train_vdp_gpode.parser().parse_args(
        ["--pallas_rhs", flag, "--no_plots", "--device", "cpu"]))
    assert args.kernels is kernels and args.plots is False
    assert args.device == "cpu"
    assert args.model_args().solver_config(args.kernels).kernels is kernels


# ---------------------------------------------------------------------------
# what the port refuses, before any work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,item", [
    ([], None),
], ids=["plots"])
def test_unported_options_raise_before_any_work(flags, item, tmp_path):
    """The plots (A.8) are ported: a
    plots-on run of the tiny MoCap shooting twin trains and draws. `--mesh`
    (A.7) is ported too; its refusals, as the JAX driver's, are in
    tests/test_torch_parallel.py."""
    save = tmp_path / "run"
    argv = ["--device", "cpu", "--save", str(save)] + flags
    assert item is None
    plots_on = [a for a in MOCAP if a != "--no_plots"] + SHOOTING
    assert train_mocap_gpode_shooting.main(plots_on + argv) == 0
    assert (save / "plt_latents_3d.png").exists()


@pytest.mark.parametrize("flags", [
    ["--remat", "true"], ["--use_adjoint", "true"],
    ["--solver", "adams"], ["--solver", "explicit_adams"],
    ["--solver", "implicit_adams"], ["--solver", "bdf"],
], ids=["remat", "adjoint", "adams", "explicit_adams", "implicit_adams",
        "bdf"])
def test_solver_and_memory_flags_train(flags, tmp_path, monkeypatch, capsys):
    """The MoCap shooting twin at the tiny size with each solver and memory
    flag the JAX script has: finite losses, the flag in the model's solver
    config, and the JSON line on stdout."""
    runs, losses = [], []
    run, loss_fn = train_mocap_gpode_shooting.run, tex.shooting_loss_fn

    def recording(argv):
        runs.append(run(argv))
        return runs[-1]

    def recording_loss_fn(*a, **k):
        inner = loss_fn(*a, **k)

        def loss(*args):
            out = inner(*args)
            losses.append(float(out[0].detach()))
            return out

        return loss

    monkeypatch.setattr(train_mocap_gpode_shooting, "run", recording)
    monkeypatch.setattr(tex, "shooting_loss_fn", recording_loss_fn)
    save = str(tmp_path / "run")
    assert train_mocap_gpode_shooting.main(
        MOCAP + SHOOTING + flags + ["--save", save, "--num_iter", "3"]) == 0
    _, trainer, metrics = runs[0]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metrics"]["test_ll"] == metrics["test_ll"]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert trainer.cfg.num_iter == 3
    assert np.isfinite(metrics["test_ll"]) and np.isfinite(metrics["test_mse"])
    args = _cli.to_experiment_args(train_mocap_gpode_shooting.parser()
                                   .parse_args(MOCAP + flags))
    cfg = args.model_args().solver_config()
    assert (cfg.solver, cfg.remat, cfg.use_adjoint) == (
        args.solver, flags[0] == "--remat", flags[0] == "--use_adjoint")


def test_twins_default_to_the_card(tmp_path):
    """Without `--device` a twin runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vdp_gpode.main(["--no_plots", "--save", str(tmp_path)])


# ---------------------------------------------------------------------------
# the drivers end to end
# ---------------------------------------------------------------------------

MOCAP_KEYS = {"train_pred_zs": (4, 6, 20, 5), "train_pred_ys": (4, 6, 20, 50),
              "test_pred_zs": (4, 2, 120, 5), "test_pred_ys": (4, 2, 120, 50),
              "obs_noisevar": (50,)}


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_params(a, b):
    pa, pb = (load_checkpoint(p)["params"] for p in (a, b))
    assert set(pa) == set(pb)
    return all(np.array_equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("shooting", [True, False],
                         ids=["shooting", "vanilla"])
def test_run_mocap_artifacts_resume_and_eval_only(shooting, tmp_path):
    """The JAX driver's artifacts; 6 iterations in one go against 3, then
    `--resume` to 6 (bit-equal on the CPU); `--eval_only` on the best-val
    checkpoint reproduces the best-val test LL."""
    twin = (train_mocap_gpode_shooting if shooting else train_mocap_gpode).run
    extra = SHOOTING if shooting else []
    one = str(tmp_path / "one")
    params, trainer, m = twin(MOCAP + extra + ["--save", one,
                                               "--checkpoint_every", "3"])
    for name in ("checkpt.npz", "checkpt_best.npz", "optimization_trace.json",
                 "train_args.json", "logs"):
        assert os.path.exists(os.path.join(one, name)), name
    preds = _arrays(os.path.join(one, "model_predictions.npz"))
    assert {k: v.shape for k, v in preds.items()} == MOCAP_KEYS
    assert all(np.all(np.isfinite(v)) for v in preds.values())
    with open(os.path.join(one, "optimization_trace.json")) as f:
        trace = json.load(f)
    # MoCap meters start after 100 iterations, as in JAX: only validation
    assert set(trace) == {"val_ll", "val_mse"}
    assert trace["val_ll"]["iters"] == [3, 6]
    with open(os.path.join(one, "train_args.json")) as f:
        assert json.load(f)["device"] == "cpu"
    ck = load_checkpoint(os.path.join(one, "checkpt.npz"))
    assert int(ck["step"]) == 6 and ck["opt_state"]["count"] == 6
    assert set(ck["params"]) == {n for n, _ in params.named_parameters()}
    best = load_checkpoint(os.path.join(one, "checkpt_best.npz"))
    assert int(best["step"]) == m["bestval_iter"]
    assert float(best["val_ll"]) == max(trace["val_ll"]["vals"])
    assert set(m["calibration"]["coverage"]) == {0.5, 0.9, 0.95}
    assert np.isfinite(m["test_ll"]) and trainer.cfg.num_iter == 6

    two = str(tmp_path / "two")
    twin(MOCAP + extra + ["--save", two, "--num_iter", "3"])
    _, resumed, _ = twin(MOCAP + extra + ["--save", two, "--resume"])
    assert _same_params(os.path.join(one, "checkpt.npz"),
                        os.path.join(two, "checkpt.npz"))
    log = open(os.path.join(two, "logs")).read()
    assert "Resuming from" in log and "at step 3" in log

    _, none, me = twin(MOCAP + extra + ["--save", one, "--eval_only",
                                        "--eval_checkpoint",
                                        "checkpt_best.npz"])
    assert none is None
    assert me["test_ll"] == m["test_ll_bestval"]
    assert os.path.exists(os.path.join(one, "eval_args.json"))


@pytest.mark.parametrize("shooting", [True, False],
                         ids=["shooting", "vanilla"])
def test_run_vdp_artifacts_resume_and_eval_only(shooting, tmp_path):
    twin = (train_vdp_gpode_shooting if shooting else train_vdp_gpode).run
    extra = SHOOTING if shooting else []
    one = str(tmp_path / "one")
    _, trainer, m = twin(VDP + extra + ["--save", one,
                                        "--checkpoint_every", "3"])
    preds = _arrays(os.path.join(one, "model_predictions.npz"))
    n_test = 12 + (50 if shooting else 12)
    assert {k: v.shape for k, v in preds.items()} == {
        "train_ts": (12,), "train_ys": (1, 12, 2), "train_pred": (4, 1, 12, 2),
        "test_ts": (n_test,), "test_ys": (1, n_test, 2),
        "test_pred": (4, 1, n_test, 2), "obs_noisevar": (2,)}
    with open(os.path.join(one, "optimization_trace.json")) as f:
        trace = json.load(f)
    want = {"loss", "observ_nll", "x0_kl", "inducing_kl", "step_time"}
    assert set(trace) == (want | {"state_kl"} if shooting else want)
    assert trace["loss"]["iters"] == list(range(1, 7))   # warmup 6 // 10
    assert all(np.isfinite(trace["loss"]["vals"]))
    assert np.isfinite(m["test_ll"]) and np.isfinite(m["train_mse"])

    two = str(tmp_path / "two")
    twin(VDP + extra + ["--save", two, "--num_iter", "3",
                        "--checkpoint_every", "3"])
    _, resumed, _ = twin(VDP + extra + ["--save", two, "--resume"])
    assert resumed.loss_meter.vals == trainer.loss_meter.vals[3:]
    assert _same_params(os.path.join(one, "checkpt.npz"),
                        os.path.join(two, "checkpt.npz"))
    _, _, me = twin(VDP + extra + ["--save", one, "--eval_only"])
    assert me == m


# ---------------------------------------------------------------------------
# a JAX checkpoint through the port's loader and evaluation
# ---------------------------------------------------------------------------

def test_jax_checkpoint_scores_like_jax(tmp_path):
    """A checkpoint in the JAX driver's format (`run_mocap`'s params after
    its kernel and inducing init, Adam state, key, step), its parameters
    flattened and loaded through the port's loader: the port's MoCap test
    evaluation on the JAX package's noise gives the JAX evaluation's test
    LL and MSE (rtol 1e-4)."""
    seqlen, draws, features = 20, 4, 16
    args = dict(num_inducing=8, num_features=features, solver="rk4",
                ts_dense_scale=2, max_steps=8, num_samples=2,
                data_seqlen=seqlen, data_path=DATA_DIR, plots=False)
    jargs = jex.ExperimentArgs(**args)
    jd_pca = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                           data_normalize=False, pca_normalize=True,
                           seqlen=seqlen)
    jd_full = JMocapDataset(data_path=DATA_DIR, subject="09",
                            pca_components=-1, data_normalize=False,
                            pca_normalize=False, seqlen=seqlen)
    margs = jex._shooting_margs(jargs.model_args(), True)
    params = jb.build_shooting(jax.random.PRNGKey(2), margs, jd_pca.trn.ys,
                               projector=j_projector(jd_pca), full_dim=50)
    params = params._replace(gp=jinit.initialize_kernel_parameters(params.gp))
    with pytest.MonkeyPatch.context() as mp:
        same_branch(mp, False)
        params = params._replace(gp=jinit.initialize_inducing(
            params.gp, jd_pca.trn.ys, float(jd_pca.trn.ts.max()), 1e0,
            rng=np.random.RandomState(121)))
    j_path = str(tmp_path / "jax_checkpt.npz")
    j_save_checkpoint(j_path, {"params": params,
                               "opt_state": j_default_optimizer(5e-3).init(params),
                               "key": jax.random.PRNGKey(5), "step": 6})
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        j_load_checkpoint(j_path)["params"])
    flat = {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}

    # the JAX evaluation (`run_mocap`'s test split scoring)
    eval_cfg = jex._eval_cfg(margs.solver_config())
    key = jax.random.PRNGKey(8)
    vparams = jgpode.GPODEParams(gp=params.gp, x0=params.states.x0,
                                 likelihood=params.likelihood)
    zs = jgpode.predict(key, vparams, jnp.asarray(jd_pca.tst.ts), eval_cfg,
                        features, num_draws=draws,
                        x0=jnp.asarray(jd_pca.tst.ys[:, 0]))
    ys = np.asarray(j_project(j_projector(jd_pca), zs))
    want = jmetrics.compute_summary(jd_full.tst.ys, ys,
                                    np.asarray(params.likelihood.variance))

    # the port: the flattened leaves through its checkpoint and loader
    save = tmp_path / "port"
    save.mkdir()
    save_checkpoint(str(save / "checkpt.npz"), {"params": flat, "step": 6})
    targs = tex.ExperimentArgs(**args, device="cpu", save=str(save),
                               eval_only=True)
    tmargs = tex._shooting_margs(targs.model_args(), True)
    data_pca = MocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                            data_normalize=False, pca_normalize=True,
                            seqlen=seqlen)
    projector = latent_to_data_projector(data_pca)
    template = tb.build_shooting(torch.Generator().manual_seed(0), tmargs,
                                 data_pca.trn.ys, projector=projector,
                                 full_dim=50, device="cpu")
    logger = io_utils.get_logger(None, displaying=False)
    tparams = tex._load_eval_params(targs, template, tmargs, logger)
    noise = _jax_predict_noise(key, params, draws, features)
    _, tys = tex.mocap_predictions(tparams, noise, data_pca.tst.ts,
                                   data_pca.tst.ys[:, 0],
                                   tex._eval_cfg(tmargs.solver_config()),
                                   tb.make_projector(projector, "cpu"))
    got = compute_summary(jd_full.tst.ys, tys,
                          tparams.likelihood.variance.detach().numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _jax_predict_noise(key, jparams, num_draws, features):
    """The noise `gpode.predict(key, ...)` draws for given start states."""
    m, d = jparams.gp.u_mean.shape
    din = jparams.gp.z.shape[1]
    keys = jax.random.split(key, num_draws)
    draw_keys = jax.vmap(lambda k: jax.random.split(k)[0])(keys)

    def draw_noise(k):
        k_w, k_omega, k_phase, k_u = jax.random.split(k, 4)
        return (jax.random.normal(k_w, (features, d)),
                jax.random.normal(k_omega, (din, features, d)),
                jax.random.uniform(k_phase, (1, features, d)),
                jax.random.normal(k_u, (m, d)))

    return tgpode.PredictNoise(*(torch.tensor(np.asarray(a)) for a in
                                 jax.vmap(draw_noise)(draw_keys)))
