"""The port's multi-device training (`gpode_tpu_torch/parallel/`) on the CPU,
against the JAX package's sharded steps and the port's single-process step.

Process groups start only in spawned ranks (`tests/_torch_parallel_worker.py`,
gloo, `file://` rendezvous in tmp_path, one thread each, every group and
join under a timeout), twice in this file: four ranks (dp=2, mc=2) for the
steps and prediction, two for the collective audit, the MoCap twin
(dp=2) and the VDP shooting twin (mc=2). The problem is the JAX sharding
tests' (`tests/test_sharding.py`: M=8, 16 features, rk4, ts_dense_scale 3,
8 draws, data (4, 6, 2)), built by the JAX package; its parameters and
noise go to the ranks as tensors.

Tolerances: against JAX, loss rtol 1e-4, gradients rtol 1e-3 with atol
1e-3 * max|g| per leaf (the class of tests/test_torch_slice.py); the
sharded step against the port's single-process step, loss rtol 1e-5 and
gradients atol 1e-4 * max|g| per leaf (the same math summed in another
order: the gradients' cancelling sums move by ~1e-5 of max|g|, as the
smoke's card check allows); parameters bit-equal across ranks; `--resume` under the mesh
against an uninterrupted run, rtol 1e-6. The steps are rk4, fixed-step, so
the sharded step computes the single-device one exactly up to rounding
(an adaptive solve's fallback would control its step on a rank's rows).
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.models import shooting as jshooting
from gpode_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpode_tpu.parallel.shard_map_step import make_shard_map_shooting_loss
from gpode_tpu.parallel.train import device_put_replicated
from gpode_tpu.train import builders as jb

from gpode_tpu_torch.convert import params_from_numpy
from gpode_tpu_torch.models import gpode as tgpode
from gpode_tpu_torch.models.shooting import (StepNoise, elbo_loss,
                                             sample_step_noise)
from gpode_tpu_torch.parallel import multihost
from gpode_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh_spec
from gpode_tpu_torch.scripts import (_cli, train_mocap_gpode,
                                     train_mocap_gpode_shooting)
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train import experiments as tex
from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
SPAWN_TIMEOUT_S = 240
ARGS = dict(num_inducing=8, num_features=16, solver="rk4", ts_dense_scale=3,
            max_steps=16, num_samples=8)
J_ARGS, T_ARGS = jb.ModelArgs(**ARGS), tb.ModelArgs(**ARGS)
ANNEALED = dict(ARGS, constraint_anneal_iters=20, constraint_anneal_start=0.1)
DP, MC = 2, 2
TERMS = ("loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl")
VDP_TWIN = ["--device", "cpu", "--no_plots", "--num_inducing", "8",
            "--num_features", "16", "--num_iter", "6", "--data_obs_S", "12",
            "--data_obs_T", "3.0", "--eval_sample_size", "4",
            "--num_samples", "2"]
TWIN = ["--device", "cpu", "--no_plots", "--num_inducing", "8",
        "--num_features", "16", "--num_iter", "6", "--log_freq", "2",
        "--eval_sample_size", "4", "--data_path",
        os.path.join(REPO, "data", "mocap"), "--data_seqlen", "20",
        "--val_freq", "3", "--val_draws", "2", "--num_samples", "2"]


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _t(a):
    return torch.tensor(np.asarray(a))


def _draw_noise(k_draw, params) -> dict:
    """The posterior draw's noise `gp.draw_posterior(k_draw, ...)` draws."""
    m, din = params.gp.z.shape
    d = params.states.mean.shape[-1]
    nf = ARGS["num_features"]
    k_w, k_omega, k_phase, k_u = jax.random.split(k_draw, 4)
    return dict(rff_weights=_t(jax.random.normal(k_w, (nf, d))),
                rff_freq=_t(jax.random.normal(k_omega, (din, nf, d))),
                rff_phase=_t(jax.random.uniform(k_phase, (1, nf, d))),
                inducing=_t(jax.random.normal(k_u, (m, d))))


def _global_noise(key, params) -> dict:
    """The noise `shooting.elbo_loss(key, ...)` draws, as tensors."""
    k_draw, k_ss = jax.random.split(key)
    k0, ks = jax.random.split(k_ss)
    n, t1, d = params.states.mean.shape
    s = ARGS["num_samples"]
    return dict(_draw_noise(k_draw, params),
                x0=_t(jax.random.normal(k0, (s, n, d))),
                states=_t(jax.random.normal(ks, (s, n, t1, d))))


def _block_noise(key, params):
    """Each device's normals in `make_shard_map_shooting_loss(key, ...)`
    (`fold_in(fold_in(k_ss, dp_index), mc_index)`, then
    `_sample_local_states`'s split), in rank order (rank = dp * MC + mc)."""
    k_draw, k_ss = jax.random.split(key)
    n, t1, d = params.states.mean.shape
    n_l, s_l = n // DP, ARGS["num_samples"] // MC
    x0s, states = [], []
    for di in range(DP):
        for mi in range(MC):
            k_local = jax.random.fold_in(jax.random.fold_in(k_ss, di), mi)
            k0, ks = jax.random.split(k_local)
            states.append(_t(jax.random.normal(ks, (s_l, n_l, t1, d))))
            x0s.append(_t(jax.random.normal(k0, (s_l, n_l, d))))
    return _draw_noise(k_draw, params), x0s, states


def _spawn(out_dir, task, world, inputs):
    """Run `world` ranks of the worker's `task`; every rank's results."""
    torch.save(inputs, os.path.join(out_dir, "inputs.pt"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--init", init, "--world", str(world),
         "--rank", str(r), "--task", task, "--out", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {task} failed:\n{out[-6000:]}"
    return [torch.load(os.path.join(out_dir, f"{task}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    ys = (rng.normal(size=(4, 6, 2)) * 0.5).astype(np.float32)
    ts = np.linspace(0, 1.0, 6).astype(np.float32)
    params = jb.build_shooting(jax.random.PRNGKey(0), J_ARGS, ys)
    return params, ys, ts


@pytest.fixture(scope="module")
def quad(problem, tmp_path_factory):
    """The four-rank run, with the parent's inputs and references."""
    params, ys, ts = problem
    flat = _flat(params)
    sm_key, g_key = jax.random.PRNGKey(7), jax.random.PRNGKey(5)
    draw, x0s, states = _block_noise(sm_key, params)
    g_noise = _global_noise(g_key, params)
    view_params = params_from_numpy(flat, T_ARGS, device="cpu")
    predict_noise = tgpode.sample_predict_noise(
        tgpode.GPODEParams(view_params.gp, view_params.states.x0,
                           view_params.likelihood),
        ARGS["num_features"], 8, torch.Generator().manual_seed(2),
        sample_x0=False)
    inputs = dict(params=flat, ys=_t(ys), ts=_t(ts), args=ARGS,
                  annealed_args=ANNEALED, draw_noise=draw, block_x0=x0s,
                  block_states=states, global_noise=g_noise,
                  predict_noise=predict_noise)
    ranks = _spawn(tmp_path_factory.mktemp("quad"), "quad", DP * MC, inputs)
    return dict(ranks=ranks, inputs=inputs, sm_key=sm_key, g_key=g_key)


def _assert_grads_close(got: dict, want: dict, rtol, atol_scale):
    assert set(got) == set(want)
    for name, g in want.items():
        g = np.asarray(g)
        np.testing.assert_allclose(
            np.asarray(got[name]), g, rtol=rtol,
            atol=atol_scale * max(float(np.max(np.abs(g))), 1e-8),
            err_msg=name)


def _single_process(inputs, args, noise, *batch):
    """The port's single-process loss and gradients (zeros for a
    parameter the loss does not read: the annealed constraint scale)."""
    params = params_from_numpy(inputs["params"], args, device="cpu")
    loss, terms = tb.shooting_loss_fn(args)(params, noise, *batch)
    loss.backward()
    return terms, {n: torch.zeros_like(p) if p.grad is None else p.grad
                   for n, p in params.named_parameters()}


def test_shard_map_loss_and_grads_match_jax_shard_map(problem, quad):
    """Four gloo ranks (dp=2, mc=2) on each device's block noise of JAX's
    `make_shard_map_shooting_loss` against that loss on a 4-device mesh."""
    params, ys, ts = problem
    mesh = j_make_mesh({"dp": DP, "mc": MC}, devices=jax.devices()[:4])
    loss_fn = make_shard_map_shooting_loss(mesh, J_ARGS)
    key = quad["sm_key"]
    with mesh:
        (v, jterms), g = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, key, jnp.asarray(ys), jnp.asarray(ts)),
            has_aux=True))(device_put_replicated(params, mesh))
    for res in quad["ranks"]:
        got = res["shard_map"]
        for name in TERMS:
            np.testing.assert_allclose(got["terms"][name],
                                       float(getattr(jterms, name)),
                                       rtol=1e-4, err_msg=name)
        _assert_grads_close(got["grads"], _flat(g), 1e-3, 1e-3)


def test_gspmd_loss_and_grads_match_jax_elbo(problem, quad):
    """The gspmd-style step on the global noise of JAX's plain
    `elbo_loss(key, ...)` against that loss and its gradients."""
    params, ys, ts = problem
    key = quad["g_key"]
    (v, jterms), g = jax.value_and_grad(
        lambda p: jshooting.elbo_loss(key, p, jnp.asarray(ys), jnp.asarray(ts),
                                      J_ARGS.solver_config(),
                                      ARGS["num_features"],
                                      num_samples=ARGS["num_samples"]),
        has_aux=True)(params)
    for res in quad["ranks"]:
        got = res["gspmd"]
        for name in TERMS:
            np.testing.assert_allclose(got["terms"][name],
                                       float(getattr(jterms, name)),
                                       rtol=1e-4, err_msg=name)
        _assert_grads_close(got["grads"], _flat(g), 1e-3, 1e-3)


def test_gspmd_step_matches_the_single_process_step(quad):
    inputs = quad["inputs"]
    terms, grads = _single_process(inputs, T_ARGS,
                                   StepNoise(**inputs["global_noise"]),
                                   inputs["ys"], inputs["ts"])
    for res in quad["ranks"]:
        got = res["gspmd"]
        for name in TERMS:
            np.testing.assert_allclose(got["terms"][name],
                                       float(getattr(terms, name).detach()),
                                       rtol=1e-5, err_msg=name)
        assert got["stats"] == (terms.nfe, terms.natt, terms.ncov)
        _assert_grads_close(got["grads"], grads, 0.0, 1e-4)


def test_three_gspmd_steps_match_the_single_process_steps(quad):
    """Three steps from one seeded generator: each rank's losses against
    the single-process step's (rtol 1e-5)."""
    inputs = quad["inputs"]
    params = params_from_numpy(inputs["params"], T_ARGS, device="cpu")
    step = make_train_step(tb.shooting_loss_fn(T_ARGS), params,
                           default_optimizer(params, 5e-3))
    gen = torch.Generator().manual_seed(11)
    want = [float(step(sample_step_noise(params, ARGS["num_features"],
                                         ARGS["num_samples"], gen),
                       inputs["ys"], inputs["ts"]).loss)
            for _ in range(3)]
    for res in quad["ranks"]:
        np.testing.assert_allclose(res["gspmd_train"]["losses"], want,
                                   rtol=1e-5)


@pytest.mark.parametrize("style", ["gspmd_train", "shard_map_train"])
def test_three_steps_keep_params_bit_equal_across_ranks(quad, style):
    first = quad["ranks"][0][style]
    assert all(np.isfinite(first["losses"]))
    for res in quad["ranks"][1:]:
        assert res[style]["losses"] == first["losses"]
        for name, p in first["params"].items():
            assert torch.equal(res[style]["params"][name], p), name


def test_annealed_step_matches_the_single_process_step(quad):
    """`with_iteration`: the constraint scale at iteration 7 of a 20-step
    anneal, through the gspmd step and the single-process loss."""
    inputs = quad["inputs"]
    args = tb.ModelArgs(**ANNEALED)
    terms, grads = _single_process(inputs, args,
                                   StepNoise(**inputs["global_noise"]),
                                   torch.tensor(7.0), inputs["ys"],
                                   inputs["ts"])
    plain, _ = _single_process(inputs, T_ARGS,
                               StepNoise(**inputs["global_noise"]),
                               inputs["ys"], inputs["ts"])
    assert float(terms.state_kl) != float(plain.state_kl)
    for res in quad["ranks"]:
        got = res["annealed"]
        np.testing.assert_allclose(got["terms"]["loss"], float(terms.loss),
                                   rtol=1e-5)
        _assert_grads_close(got["grads"], grads, 0.0, 1e-4)


def test_sharded_predict_matches_predict(quad):
    """Eight draws split over dp (four per block), gathered in order."""
    inputs = quad["inputs"]
    params = params_from_numpy(inputs["params"], T_ARGS, device="cpu")
    view = tgpode.GPODEParams(params.gp, params.states.x0, params.likelihood)
    want = tgpode.predict(view, inputs["predict_noise"], inputs["ts"],
                          T_ARGS.solver_config(), x0=inputs["ys"][:, 0])
    for res in quad["ranks"]:
        assert res["predict"].shape == (8, 4, 6, 2)
        np.testing.assert_allclose(res["predict"].numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_ranks_take_their_mesh_coordinates(quad):
    assert [r["coords"] for r in quad["ranks"]] == [
        {"dp": 0, "mc": 0}, {"dp": 0, "mc": 1}, {"dp": 1, "mc": 0},
        {"dp": 1, "mc": 1}]


@pytest.fixture(scope="module")
def pair(problem, tmp_path_factory):
    params, ys, ts = problem
    inputs = dict(params=_flat(params), ys=_t(ys), ts=_t(ts), args=ARGS,
                  twin_argv=TWIN + ["--mesh", "dp=2"],
                  vdp_argv=VDP_TWIN + ["--mesh", "mc=2",
                                       "--parallel", "gspmd"])
    return _spawn(tmp_path_factory.mktemp("pair"), "pair", 2, inputs)


def test_collective_audit_passes_a_clean_step(pair):
    """Two collectives per step (the gradient-and-terms sum, the solver
    statistics' max), none inside a segment solve."""
    for res in pair:
        report = res["clean"]
        assert report["solves"] == 2 and report["inside"] == []
        assert report["collectives"] == ["c10d::allreduce_"] * 4


def test_collective_audit_catches_a_planted_all_reduce(pair):
    for res in pair:
        assert res["planted"]["inside"] == [
            "c10d::allreduce_ in gpode.segment_solve"]
        assert "INSIDE a segment solve" in res["planted_caught"]


def test_mocap_twin_trains_on_two_ranks_and_resumes(pair):
    """`--mesh dp=2` (shard_map) on two ranks: the ranks end bit-equal,
    rank 0 alone evaluates, and 3 steps then `--resume` to 6 equal 6 steps
    in one go."""
    rank0, rank1 = pair
    assert np.isfinite(rank0["twin_metrics"]["test_ll"])
    assert rank1["twin_metrics"] is None
    for name, p in rank0["twin_params"].items():
        assert torch.equal(rank1["twin_params"][name], p), name
        np.testing.assert_allclose(rank0["resumed_params"][name].numpy(),
                                   p.numpy(), rtol=1e-6, atol=0,
                                   err_msg=name)


def test_mocap_twin_draw_stages_on_two_ranks(pair):
    """`--draw_stages 2:3,4:3` under the mesh: the second stage's step is
    rebuilt for its draws; the ranks stay bit-equal."""
    rank0, rank1 = pair
    assert np.isfinite(rank0["staged_metrics"]["test_ll"])
    assert rank1["staged_metrics"] is None
    for name, p in rank0["staged_params"].items():
        assert torch.equal(rank1["staged_params"][name], p), name
    assert any(not torch.equal(p, rank0["twin_params"][name])
               for name, p in rank0["staged_params"].items())


def test_vdp_twin_splits_its_samples_over_two_ranks(pair):
    """The 2-D driver (`run_2d`) under `--mesh mc=2`: VDP has one
    sequence, so the two ranks split the MC samples; they end bit-equal
    and rank 0 alone evaluates."""
    rank0, rank1 = pair
    assert np.isfinite(rank0["vdp_metrics"]["test_ll"])
    assert rank1["vdp_metrics"] is None
    for name, p in rank0["vdp_params"].items():
        assert torch.equal(rank1["vdp_params"][name], p), name


@pytest.mark.parametrize("shooting,flags,match", [
    (False, ["--mesh", "dp=1"], "wired for the shooting"),
    (True, ["--mesh", "dp=1", "--segment_minibatch", "3"],
     "needs --parallel gspmd"),
    (True, ["--mesh", "dp=2"], "!= 1 ranks"),
], ids=["vanilla", "minibatch_shard_map", "mesh_not_the_world"])
def test_mesh_refusals_before_any_group(shooting, flags, match, tmp_path):
    """What `--mesh` refuses, as the JAX driver words it, before this
    process joins a group and before any work. The vanilla twins have no
    `--mesh` flag (as in JAX); their driver refuses a mesh in its args."""
    save = tmp_path / "run"
    argv = TWIN[:-2] + ["--save", str(save)]  # TWIN ends in --num_samples
    if shooting:
        args = _cli.to_experiment_args(
            train_mocap_gpode_shooting.parser().parse_args(argv + flags))
    else:
        args = _cli.to_experiment_args(
            train_mocap_gpode.parser().parse_args(argv))
        args.mesh = flags[1]
    with pytest.raises(ValueError, match=match):
        tex.run_mocap(args, shooting_variant=shooting)
    assert not torch.distributed.is_initialized()
    assert not (save / "checkpt.npz").exists()


def test_mesh_layout_and_blocks():
    assert parse_mesh_spec("dp=2,mc=-1") == {"dp": 2, "mc": -1}
    mesh = make_mesh({"dp": 2, "mc": -1}, world_size=8, rank=5)
    assert mesh.shape == {"dp": 2, "mc": 4}
    assert mesh.coords == {"dp": 1, "mc": 1}
    assert mesh.sequence_block(6) == (3, 6)
    assert mesh.sample_block(8) == (2, 4)
    assert make_mesh(world_size=3, rank=0).shape == {"dp": 3}
    assert Mesh({"mc": 2}, 1).sequence_block(4) == (0, 4)
    with pytest.raises(ValueError, match="do not split"):
        mesh.sequence_block(5)
    with pytest.raises(ValueError, match="bad mesh spec"):
        parse_mesh_spec("dp2")
    blocks = multihost.global_put({"ys": np.arange(12.0).reshape(6, 2)},
                                  mesh, "dp")
    np.testing.assert_array_equal(blocks["ys"].numpy(),
                                  np.arange(6.0, 12.0).reshape(3, 2))
    assert multihost.global_array(np.ones(3)).shape == (3,)
    np.testing.assert_array_equal(
        multihost.fetch_replicated(torch.arange(3.0)), [0.0, 1.0, 2.0])


def test_backend_and_device_of_a_rank(monkeypatch):
    """gloo on the CPU and when ranks share a card, NCCL when each rank has
    one; a rank's card is LOCAL_RANK modulo the cards; no card raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.backend_for(torch.device("cpu"), 1) == "gloo"
    assert multihost.backend_for(torch.device("cuda", 0), 1) == "nccl"
    assert multihost.backend_for(torch.device("cuda", 0), 2) == "gloo"
    assert multihost.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.local_device() == torch.device("cuda", 0)


def test_elbo_loss_takes_no_obs_mask_under_a_mesh(problem):
    params, ys, ts = problem
    tparams = params_from_numpy(_flat(params), T_ARGS, device="cpu")
    noise = StepNoise(**_global_noise(jax.random.PRNGKey(1), params))
    with pytest.raises(ValueError, match="obs_mask takes no mesh"):
        elbo_loss(tparams, noise, _t(ys), _t(ts), T_ARGS.solver_config(),
                  obs_mask=torch.ones(4, 6), mesh=Mesh({"dp": 1}, 0))
