"""Hold the sharded train steps to the single-process step on the bench
problem, one process per rank.

    torchrun --nproc_per_node=2 -m gpode_tpu_torch.scripts.mesh_check \\
        [--presets official,fast] [--out results/mesh_check]

or, by hand, each rank with `--init file:///tmp/rdv --world 2 --rank R`
(`run_local` starts such ranks on this host, sharing its card).
The mesh is `dp=<world>`. For each preset (`train/bench_setup.py`, full
width: MoCap-09, 6 sequences of 100 steps, M=100, S=256, 5 draws) every
rank builds the bench problem (rank 0's parameters broadcast) and:

  * the "gspmd" step on the global noise of one seeded generator: its
    loss and every reduced gradient leaf, against the single-process step
    on the same noise (rank 0, in float32 and, on the plain path, in
    float64);
  * the "shard_map" step on its block noise: the same, against the
    single-process composition of every rank's block (rank 0 evaluates each
    block's part of the objective, `shooting.elbo_loss(mesh=...)` at that
    block's coordinates, and sums them);
  * the CUDA kernels each step launched on this rank (counters set to 0
    just before the step and read just after), and its solver statistics;
  * 5 steps of each style from one seeded generator: a hash of the
    parameters, which must be bit-equal on every rank;
  * `parallel/collective_audit` over one step: the collectives per step
    against `COLLECTIVES_PER_STEP`, none inside a segment solve.

Limits: the loss rtol 1e-5 against the float32 single-process value. On
the card every gradient leaf within 1e-4 * max|g| of the float32
single-process gradient (max|g| that leaf's). On the CPU, whose float32
sums of this problem land farther apart, each leaf must instead be no
farther from the float64 single-process gradient than 1.25x the float32
single-process gradient's distance + 1e-4 * max|g|: there the float32
gradients themselves sit up to ~5e-4 of max|g| from float64 (gp.z; the
cancelling sums of the draw's leaves), so two float32 summation orders can
differ by more than 1e-4 of max|g| while both are as right as float32
allows. Both distances are reported everywhere. The equality holds for
fixed-step solvers and accepted whole-span attempts, and the bench
problem's first step accepts on every rank: a rejected attempt there fails
the check. Every rank writes `<out>/mesh_check_rank<r>.pt`; rank 0
compares them, prints one JSON line and exits non-zero on a failed check.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from gpode_tpu_torch.models.shooting import elbo_loss, sample_step_noise
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.parallel import STYLES, collective_audit, multihost
from gpode_tpu_torch.parallel.mesh import Mesh, make_mesh
from gpode_tpu_torch.parallel.shard_map_step import sample_block_noise
from gpode_tpu_torch.parallel.train import (COLLECTIVES_PER_STEP, block_noise,
                                            make_sharded_shooting_step,
                                            sharded_noise_fn)
from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                               preset_model_args)
from gpode_tpu_torch.train.trainer import default_optimizer

LOSS_RTOL, GRAD_ATOL_SCALE = 1e-5, 1e-4
TRAIN_STEPS = 5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _grads(params) -> dict:
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().cpu() for n, p in params.named_parameters()}


def _param_hash(params) -> str:
    h = hashlib.sha256()
    for name, p in params.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _one_step(style, mesh, args, params0, noise, ys_local, ts, dev):
    """One mesh step of `style` from a copy of `params0`: its global terms,
    the reduced gradients and the kernels it launched."""
    make, _ = STYLES[style]
    params = copy.deepcopy(params0)
    step = make(mesh, args, params, default_optimizer(params, 5e-3))
    _sync(dev)
    ck.reset_launch_counts()
    terms = step(noise, ys_local, ts)
    _sync(dev)
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    return {"loss": float(terms.loss), "grads": _grads(params),
            "launches": launches, "nfe": terms.nfe, "natt": terms.natt,
            "ncov": terms.ncov}


def _single(args, params0, ys, ts, parts, dtype) -> dict:
    """Single-process loss and gradients in `dtype` of the sum of the
    `parts` ((mesh, noise) pairs: a block's part of the objective, or the
    whole step where the mesh is None); float64 takes the plain path."""
    params = copy.deepcopy(params0).to(dtype)
    cfg = args.solver_config(None if dtype == torch.float32 else False)
    loss = 0.0
    for mesh, noise in parts:
        noise = dataclasses.replace(noise, **{
            f.name: getattr(noise, f.name).to(dtype)
            for f in dataclasses.fields(noise)
            if getattr(noise, f.name) is not None
            and getattr(noise, f.name).is_floating_point()})
        lo, hi = (0, ys.shape[0]) if mesh is None else mesh.sequence_block(
            ys.shape[0])
        loss = loss + elbo_loss(params, noise, ys[lo:hi].to(dtype),
                                ts.to(dtype), cfg, mesh=mesh)[0]
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads(params)}


def check_preset(preset: str, mesh: Mesh, dev: torch.device) -> dict:
    args, params0, ys, ts = build_bench_problem(preset_model_args(preset),
                                                device=dev)
    multihost.broadcast_params(params0)
    lo, hi = mesh.sequence_block(ys.shape[0])
    ys_local = ys[lo:hi]
    out = {"rows_per_rank": args.num_samples * (hi - lo) * ys.shape[1]}

    noise = sample_step_noise(params0, args.num_features, args.num_samples,
                              torch.Generator(dev).manual_seed(0))
    out["gspmd"] = _one_step("gspmd", mesh, args, params0,
                             block_noise(noise, mesh), ys_local, ts, dev)
    block_gen = torch.Generator(dev).manual_seed(1)
    out["shard_map"] = _one_step(
        "shard_map", mesh, args, params0,
        sample_block_noise(params0, mesh, args.num_features,
                           args.num_samples, block_gen), ys_local, ts, dev)
    if mesh.rank == 0:
        whole = [(None, noise)]
        blocks = [(Mesh(mesh.shape, r), sample_block_noise(
            params0, Mesh(mesh.shape, r), args.num_features,
            args.num_samples, torch.Generator(dev).manual_seed(1)))
            for r in range(mesh.size)]
        for style, parts in (("gspmd", whole), ("shard_map", blocks)):
            out[f"{style}_ref"] = _single(args, params0, ys, ts, parts,
                                          torch.float32)
            out[f"{style}_ref64"] = _single(args, params0, ys, ts, parts,
                                            torch.float64)

    for style, (make, noise_maker) in STYLES.items():
        params = copy.deepcopy(params0)
        step = make(mesh, args, params, default_optimizer(params, 5e-3))
        noise_fn = noise_maker(mesh, args)
        gen = torch.Generator(dev).manual_seed(2)
        _sync(dev)
        t0 = time.perf_counter()
        losses = [float(step(noise_fn(params, gen), ys_local, ts).loss)
                  for _ in range(TRAIN_STEPS)]
        _sync(dev)
        out[f"{style}_train"] = {
            "losses": losses, "hash": _param_hash(params),
            "steps_per_sec": TRAIN_STEPS / (time.perf_counter() - t0)}

    params = copy.deepcopy(params0)
    step = make_sharded_shooting_step(mesh, args, params,
                                      default_optimizer(params, 5e-3))
    noise_fn = sharded_noise_fn(mesh, args)
    gen = torch.Generator(dev).manual_seed(3)
    report = collective_audit.audit(
        lambda: step(noise_fn(params, gen), ys_local, ts))
    out["audit"] = {k: report[k] for k in ("solves", "per_step", "inside",
                                            "collectives")}
    return out


def _close(got: dict, ref: dict, ref64: dict, on_card: bool) -> dict:
    """The loss's error relative to the float32 reference; for the
    gradients, the worst leaf's distance to the float32 reference over that
    leaf's max|g|, and the distances of `got` and of the float32 reference
    to float64 over max|g64|; `grads_within` whether every leaf keeps the
    limit of its device (module docstring)."""
    direct, within, worst64 = 0.0, True, {}
    for name, g64 in ref64["grads"].items():
        g64, g32, g = g64.float(), ref["grads"][name], got["grads"][name]
        scale = max(float(g32.abs().max()), 1e-30)
        e_direct = float((g - g32).abs().max())
        scale64 = max(float(g64.abs().max()), 1e-30)
        e_got = float((g - g64).abs().max())
        e_ref = float((g32 - g64).abs().max())
        within &= (e_direct <= GRAD_ATOL_SCALE * scale if on_card else
                   e_got <= 1.25 * e_ref + GRAD_ATOL_SCALE * scale64)
        worst64[name] = (e_got / scale64, e_ref / scale64)
        direct = max(direct, e_direct / scale)
    return {"loss_rel_err": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_err_vs_f32_over_max": direct,
            "grad_err_vs_f64_over_max": max(v[0] for v in worst64.values()),
            "f32_ref_err_vs_f64_over_max": max(v[1] for v in worst64.values()),
            "grads_within": within}


def compare(preset: str, results: list, failures: list,
            on_card: bool) -> dict:
    """Rank 0's verdict on every rank's results of one preset (the gradient
    limit of the device, and the kernel launches only `on_card`: on the CPU
    the wrappers run their plain versions and count nothing)."""
    kernel_fwd, kernel_bwd = (
        ("fused_rk4_segment_fwd", "fused_rk4_segment_bwd")
        if preset_model_args(preset).solver == "rk4"
        else ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd"))
    summary = {"rows_per_rank": results[0]["rows_per_rank"]}
    for style in ("gspmd", "shard_map"):
        errs = [_close(r[style], results[0][f"{style}_ref"],
                       results[0][f"{style}_ref64"], on_card) for r in results]
        launches = [r[style]["launches"] for r in results]
        natt = [r[style]["natt"] for r in results]
        summary[style] = {"errors": errs, "launches": launches,
                          "natt": natt, "loss": results[0][style]["loss"],
                          "ref_loss": results[0][f"{style}_ref"]["loss"]}
        for rank, (e, lau, n) in enumerate(zip(errs, launches, natt)):
            where = f"{preset} {style} rank {rank}"
            if on_card and lau.get(kernel_fwd, 0) != 1:
                failures.append(f"{where}: {kernel_fwd} launched "
                                f"{lau.get(kernel_fwd, 0)} times in a step")
            if n > 1:
                failures.append(f"{where}: its whole-span attempt was "
                                f"rejected ({n} attempts); the bench "
                                f"problem's first step accepts")
            if on_card and lau.get(kernel_bwd, 0) != 1:
                failures.append(f"{where}: {kernel_bwd} launched "
                                f"{lau.get(kernel_bwd, 0)} times in a step")
            if e["loss_rel_err"] > LOSS_RTOL:
                failures.append(f"{where}: loss rel err {e['loss_rel_err']}")
            if not e["grads_within"]:
                failures.append(f"{where}: gradients beyond the limit: {e}")
        train = [r[f"{style}_train"] for r in results]
        summary[f"{style}_train"] = {
            "losses": train[0]["losses"],
            "steps_per_sec": [t["steps_per_sec"] for t in train],
            "params_bit_equal": len({t["hash"] for t in train}) == 1}
        if not summary[f"{style}_train"]["params_bit_equal"]:
            failures.append(f"{preset} {style}: params differ across ranks "
                            f"after {TRAIN_STEPS} steps")
    audits = [r["audit"] for r in results]
    summary["audit"] = [{k: a[k] for k in ("solves", "per_step", "inside")}
                        for a in audits]
    for rank, a in enumerate(audits):
        if a["inside"] or a["per_step"] != COLLECTIVES_PER_STEP or not a["solves"]:
            failures.append(f"{preset} audit rank {rank}: {a}")
    return summary


def run_local(world: int, presets: str, out_dir: str,
              timeout_s: float) -> tuple[list, list]:
    """Run `world` ranks of this check as processes of this host (each with
    LOCAL_RANK = its rank, so ranks share the card when there is one: gloo),
    through a `file://` rendezvous in `out_dir`; kill them after
    `timeout_s`. Returns (their exit codes, their outputs)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_WORLD_SIZE")}
    os.makedirs(out_dir, exist_ok=True)   # the rendezvous file lives here
    init = "file://" + os.path.join(os.path.abspath(out_dir), "rendezvous")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gpode_tpu_torch.scripts.mesh_check",
         "--init", init, "--world", str(world), "--rank", str(rank),
         "--presets", presets, "--out", out_dir],
        cwd=root, env=dict(env, LOCAL_RANK=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", default=None,
                    help="rendezvous URL (tcp:// or file://); default the "
                         "torchrun environment")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--presets", default="official,fast")
    ap.add_argument("--out", default="results/mesh_check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    multihost.initialize(a.init, a.world, a.rank, device=a.device)
    dev = multihost.local_device(a.device)
    mesh = make_mesh()
    os.makedirs(a.out, exist_ok=True)
    mine = {"rank": mesh.rank, "backend": dist.get_backend(),
            "device": str(dev)}
    for preset in a.presets.split(","):
        mine[preset] = check_preset(preset, mesh, dev)
    torch.save(mine, os.path.join(a.out, f"mesh_check_rank{mesh.rank}.pt"))
    dist.barrier()
    code = 0
    if mesh.rank == 0:
        results = [torch.load(os.path.join(a.out,
                                           f"mesh_check_rank{r}.pt"),
                              weights_only=False)
                   for r in range(mesh.size)]
        failures = []
        verdict = {"mesh": mesh.shape, "backend": mine["backend"],
                   "presets": {p: compare(p, [r[p] for r in results],
                                          failures, dev.type == "cuda")
                               for p in a.presets.split(",")},
                   "failures": failures,
                   "seconds": time.perf_counter() - t0}
        print(json.dumps(verdict), flush=True)
        code = 1 if failures else 0
    dist.barrier()
    dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
