"""One rank of the port's multi-rank CPU tests (tests/test_torch_parallel.py).

Each process joins a gloo group through a `file://` rendezvous, runs the
tasks of its `--task` set on the inputs the parent wrote (`inputs.pt`: the
flattened parameters, data and noise, all made by the parent) and writes
what it computed to `<out>/<task>_rank<r>.pt` for the parent to compare.

    python tests/_torch_parallel_worker.py --init file:///tmp/x/rdv \\
        --world 4 --rank 0 --task quad --out /tmp/x

Tasks:
  quad (4 ranks, dp=2, mc=2): the shard_map step on the parent's per-block
    noise and the gspmd step on its global noise (loss, terms, reduced
    gradients), three gspmd and three shard_map steps from one seeded
    generator (losses and parameters), the annealed gspmd step, and
    `make_sharded_predict`;
  pair (2 ranks, dp=2): `collective_audit` on a clean and on a planted
    step, and the tiny MoCap shooting twin under `--mesh dp=2` (6 steps in
    one go; 3 steps, then `--resume` to 6; two draw stages), and the
    VDP shooting twin under `--mesh mc=2` (one sequence: the samples
    split).
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gpode_tpu_torch.convert import params_from_numpy  # noqa: E402
from gpode_tpu_torch.models import shooting  # noqa: E402
from gpode_tpu_torch.models.gpode import GPODEParams  # noqa: E402
from gpode_tpu_torch.parallel import collective_audit, multihost  # noqa: E402
from gpode_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from gpode_tpu_torch.parallel.shard_map_step import (  # noqa: E402
    make_shard_map_shooting_step, shard_map_noise_fn)
from gpode_tpu_torch.parallel.train import (  # noqa: E402
    COLLECTIVES_PER_STEP, block_noise, make_sharded_predict,
    make_sharded_shooting_step, sharded_noise_fn)
from gpode_tpu_torch.train import builders as tb  # noqa: E402
from gpode_tpu_torch.train.trainer import default_optimizer  # noqa: E402

TIMEOUT_S = 120.0


def _grads(params):
    return {n: p.grad.clone() for n, p in params.named_parameters()}


def _step_result(make, mesh, args, inp, noise, *batch):
    """One mesh step from the parent's parameters: the global terms and
    the reduced gradients (read after the step; Adam leaves them)."""
    params = params_from_numpy(inp["params"], args, device="cpu")
    step = make(mesh, args, params, default_optimizer(params, 5e-3))
    terms = step(noise, *batch)
    return {"terms": {f: float(getattr(terms, f)) for f in
                      ("loss", "observ_nll", "state_kl", "x0_kl",
                       "inducing_kl")},
            "stats": (terms.nfe, terms.natt, terms.ncov),
            "grads": _grads(params)}


def _train(make, noise_maker, mesh, args, inp, ys, ts, steps=3):
    params = params_from_numpy(inp["params"], args, device="cpu")
    step = make(mesh, args, params, default_optimizer(params, 5e-3))
    noise_fn = noise_maker(mesh, args)
    gen = torch.Generator().manual_seed(11)
    losses = [float(step(noise_fn(params, gen), ys, ts).loss)
              for _ in range(steps)]
    return {"losses": losses,
            "params": {n: p.detach().clone()
                       for n, p in params.named_parameters()}}


def quad(rank, inp):
    mesh = make_mesh({"dp": 2, "mc": 2})
    args = tb.ModelArgs(**inp["args"])
    ys, ts = inp["ys"], inp["ts"]
    lo, hi = mesh.sequence_block(ys.shape[0])
    ys_local = ys[lo:hi]
    out = {"coords": mesh.coords}

    sm_noise = shooting.StepNoise(**inp["draw_noise"],
                                  x0=inp["block_x0"][rank],
                                  states=inp["block_states"][rank])
    out["shard_map"] = _step_result(make_shard_map_shooting_step, mesh, args,
                                    inp, sm_noise, ys_local, ts)
    g_noise = block_noise(shooting.StepNoise(**inp["global_noise"]), mesh)
    out["gspmd"] = _step_result(make_sharded_shooting_step, mesh, args, inp,
                                g_noise, ys_local, ts)

    out["gspmd_train"] = _train(make_sharded_shooting_step, sharded_noise_fn,
                                mesh, args, inp, ys_local, ts)
    out["shard_map_train"] = _train(make_shard_map_shooting_step,
                                    shard_map_noise_fn, mesh, args, inp,
                                    ys_local, ts)

    annealed = tb.ModelArgs(**inp["annealed_args"])
    out["annealed"] = _step_result(make_sharded_shooting_step, mesh, annealed,
                                   inp, g_noise, torch.tensor(7.0), ys_local,
                                   ts)

    params = params_from_numpy(inp["params"], args, device="cpu")
    view = GPODEParams(params.gp, params.states.x0, params.likelihood)
    predict = make_sharded_predict(mesh, args.solver_config())
    out["predict"] = predict(view, inp["predict_noise"], ts, ys[:, 0])
    return out


def pair(rank, inp, out_dir):
    mesh = make_mesh({"dp": 2})
    args = tb.ModelArgs(**inp["args"])
    ys, ts = inp["ys"], inp["ts"]
    lo, hi = mesh.sequence_block(ys.shape[0])
    out = {}

    params = params_from_numpy(inp["params"], args, device="cpu")
    step = make_sharded_shooting_step(mesh, args, params,
                                      default_optimizer(params, 5e-3))
    noise_fn = sharded_noise_fn(mesh, args)
    gen = torch.Generator().manual_seed(3)

    def run():
        step(noise_fn(params, gen), ys[lo:hi], ts)

    out["clean"] = collective_audit.audit(run, steps=2)
    collective_audit.assert_solves_collective_free(out["clean"],
                                                   COLLECTIVES_PER_STEP)

    integrate = shooting.integrate_segments

    def planted(*a):
        pred, stats = integrate(*a)
        dist.all_reduce(pred.detach().sum())  # inside the solve range
        return pred, stats

    shooting.integrate_segments = planted
    try:
        out["planted"] = collective_audit.audit(run)
    finally:
        shooting.integrate_segments = integrate
    try:
        collective_audit.assert_solves_collective_free(out["planted"],
                                                       COLLECTIVES_PER_STEP)
        out["planted_caught"] = False
    except AssertionError as exc:
        out["planted_caught"] = str(exc)

    from gpode_tpu_torch.scripts import train_mocap_gpode_shooting as twin
    argv = inp["twin_argv"]
    one, two = (os.path.join(out_dir, name) for name in ("one", "two"))
    trained, _, out["twin_metrics"] = twin.run(argv + ["--save", one])
    out["twin_params"] = {n: p.detach().clone()
                          for n, p in trained.named_parameters()}
    twin.run(argv + ["--save", two, "--num_iter", "3"])
    resumed, _, _ = twin.run(argv + ["--save", two, "--resume"])
    out["resumed_params"] = {n: p.detach().clone()
                             for n, p in resumed.named_parameters()}
    staged, _, out["staged_metrics"] = twin.run(
        argv + ["--save", os.path.join(out_dir, "staged"),
                "--draw_stages", "2:3,4:3"])
    out["staged_params"] = {n: p.detach().clone()
                            for n, p in staged.named_parameters()}

    from gpode_tpu_torch.scripts import train_vdp_gpode_shooting as vdp
    vdp_params, _, out["vdp_metrics"] = vdp.run(
        inp["vdp_argv"] + ["--save", os.path.join(out_dir, "vdp")])
    out["vdp_params"] = {n: p.detach().clone()
                         for n, p in vdp_params.named_parameters()}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--task", choices=("quad", "pair"), required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    multihost.initialize(a.init, a.world, a.rank, device="cpu",
                         timeout_s=TIMEOUT_S)
    inp = torch.load(os.path.join(a.out, "inputs.pt"), weights_only=False)
    if a.task == "quad":
        out = quad(a.rank, inp)
    else:
        out = pair(a.rank, inp, a.out)
    torch.save(out, os.path.join(a.out, f"{a.task}_rank{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
