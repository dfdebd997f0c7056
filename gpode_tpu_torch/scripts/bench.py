"""Benchmark: MoCap shooting-GPODE training throughput (ELBO steps/s).

    python -m gpode_tpu_torch.scripts.bench [--preset official] [--iters 200]
        [--device cuda] [--mesh dp=2,mc=... [--parallel shard_map|gspmd]]

Counterpart of the single-device `measure_steps_per_sec` of `bench.py`: the
bench problem of a preset (`train/bench_setup.py`: MoCap subject 09, seqlen
100, 5 PCA latents, the likelihood in the 50-D data space, kernel and
inducing init), the preset's shooting step with Adam (lr 5e-3, no frozen
mask, as `bench.py` builds it) — captured as CUDA graphs where
`train/graph_step.capture_refusal` allows, as `bench.py` jits it — step
noise from a generator seeded with 1 on the device. 3 warm-up steps, then 3 timing windows of `--iters` steps, each
ending in a host read of the loss; steps/s is the median window's.

Prints one JSON line: `steps_per_sec`, `rhs_evals_per_sec` (steps/s x the
last step's rhs evaluations x the segments of a step, draws x sequences x
steps), the final `loss`, `platform` ("gpu" or "cpu") and `device` (the
card's name), plus the preset, whether the step was `captured`, the
iterations and the peak device memory in MiB (null on the CPU). The JAX script's CPU-baseline subprocess is not
here. `--device cpu` runs on the CPU (the kernels' plain versions).

`--mesh dp=2,mc=4` times the sharded train step the drivers run with
`--mesh` (`--parallel` picks its style; sequences over dp, MC samples over
mc, parameters replicated from rank 0), one process per rank: under
`torchrun --nproc_per_node=W`, or a world of 1 in a plain process. Every
rank times its own steps; rank 0 prints the line, with the mesh, the style,
the world size and the process group's backend.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import torch.distributed as dist

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.models.shooting import sample_step_noise
from gpode_tpu_torch.parallel import STYLES, multihost
from gpode_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec
from gpode_tpu_torch.train.bench_setup import (PRESETS, build_bench_problem,
                                               preset_model_args)
from gpode_tpu_torch.train.builders import shooting_loss_fn
from gpode_tpu_torch.train.graph_step import (MESH_REFUSAL, CapturedStep,
                                              log_refusal, make_step)
from gpode_tpu_torch.train.trainer import default_optimizer


def measure_steps_per_sec(preset: str = "official", iters: int = 200,
                          warmup: int = 3, device=None,
                          mesh_spec: str | None = None,
                          parallel: str = "shard_map") -> dict:
    mesh = None
    if mesh_spec:
        mesh = make_mesh(parse_mesh_spec(mesh_spec))
        multihost.initialize(device=device)
        dev = multihost.local_device(device)
    else:
        dev = resolve_device(device)
    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
                                               device=dev)
    opt = default_optimizer(params, 5e-3)
    n_seq = ys.shape[0]
    if mesh is None:
        step = make_step(shooting_loss_fn(args), params, opt, args)
        noise_fn = None
    else:
        make, noise_maker = STYLES[parallel]
        log_refusal(MESH_REFUSAL, dev)
        step = make(mesh, args, params, opt)
        noise_fn = noise_maker(mesh, args)
        multihost.broadcast_params(params)
        lo, hi = mesh.sequence_block(n_seq)
        ys = ys[lo:hi]
    gen = torch.Generator(dev).manual_seed(1)

    def run():
        if noise_fn is not None:
            return step(noise_fn(params, gen), ys, ts)
        return step(sample_step_noise(params, args.num_features,
                                      args.num_samples, gen), ys, ts)

    for _ in range(warmup):
        terms = run()
    float(terms.loss.detach())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window_times = []
    for _ in range(3):
        begin = time.perf_counter()
        for _ in range(iters):
            terms = run()
        final_loss = float(terms.loss.detach())  # the window ends in a host read
        window_times.append(time.perf_counter() - begin)
    steps_per_sec = iters / sorted(window_times)[1]
    segments = args.num_samples * n_seq * ys.shape[1]
    cuda = dev.type == "cuda"
    meshed = {} if mesh is None else {
        "mesh": mesh.shape, "parallel": parallel, "world_size": mesh.size,
        "backend": dist.get_backend()}
    return {
        "steps_per_sec": steps_per_sec,
        "rhs_evals_per_sec": steps_per_sec * terms.nfe * segments,
        "loss": final_loss,
        "platform": "gpu" if cuda else "cpu",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "preset": preset,
        "captured": isinstance(step, CapturedStep),
        "iters": iters,
        "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                     if cuda else None),
        **meshed,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="official", choices=PRESETS)
    ap.add_argument("--iters", type=int, default=200,
                    help="steps per timing window (3 windows)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="time the sharded step over this rank mesh, e.g. "
                         "'dp=2' (one process per rank)")
    ap.add_argument("--parallel", default="shard_map",
                    choices=("shard_map", "gspmd"),
                    help="the sharded step's style with --mesh")
    a = ap.parse_args(argv)
    result = measure_steps_per_sec(a.preset, a.iters, device=a.device,
                                   mesh_spec=a.mesh, parallel=a.parallel)
    if result.get("mesh") is None or dist.get_rank() == 0:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
