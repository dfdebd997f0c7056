#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure ends the run with a non-zero
exit code and no result line:

  1. device: a CUDA device must be present; prints the card's name and power
     limit (nvidia-smi);
  2. build: compiles every kernel source under gpode_tpu_torch/csrc/ with
     nvcc (all in parallel) and prints build seconds and ptxas register and
     spill lines;
  3. kernels: on the inputs of the MoCap-09 train step (N=3000 segment rows,
     Din=D=5, M=100 inducing points, S=256 features; the official and the
     `fast` preset build the same params and draws) holds each kernel
     against its plain PyTorch version — forward rtol 1e-4 (atol 1e-5 *
     max|ref|), cotangents atol 1e-3 * max|g| — and times the kernel, the
     plain version and the least time the card could take. The rk4 segment
     is held at 1 substep (the fast step), at 3 and at M=256 (the
     `m256_fast` shape). `rbf_gram`
     is held at the same N=3000, M=100, at M=256, at N=77 (a ragged last
     tile) and at Din=17 (its runtime-Din variant, off the main path); the
     three wide-layout rhs functions against their plain versions at
     N=2995 and 3000, M=100 and 256, each also for bit-identical reruns.
     Bounds read the function, not the formulation: the wide kernels take
     the per-dim rhs's counts. The dopri5 attempt's forward and backward
     are held and timed at M=256 too, the rk4 segment's timed at 3 substeps
     and at M=256, and two launches of each row-tile kernel (`fused_rhs` and
     the segment kernels) must be bit-identical. For each of the ten
     redesigned kernels (the six row-tile ones, the three wide ones and
     `rbf_gram`) it prints registers and spill bytes (the build's ptxas
     record), block size, dynamic shared memory and resident blocks and
     warps per SM (the occupancy query); every built variant must be free of
     spills and be one the launch geometry selects. The yardstick of their
     speed is one float32 GEMM (`torch.mm` of two GEMM_N x GEMM_N matrices,
     TF32 off), which shares no code with any kernel here, timed in the same
     call: each of the ten must stay within the limit of its ratio to that
     GEMM (EARLIER). `rbf_gram`, which only writes its output, is also
     printed beside one `fill_` of the same (D, N, M) tensor (the same bytes
     written by one PyTorch call; printed, not held);
  4. train: the official-recipe shooting train step (dopri5, whole-span
     first step, 5 MC draws, no frozen mask as in bench.py): the step-0 loss
     against the same step through the plain path at rtol 1e-4, then 3
     warm-up and 20 timed steps with every launch counter set to 0 just
     before them;
  5. reject fallback: `flow_forward` of the bench draw over a span whose
     whole-span attempt is rejected, through the kernels and through the
     plain path, held equal (rtol 1e-4); then the accept test near its
     threshold: at every span 0.01 * 1.05^k whose float64 plain error RMS
     lies in [0.5, 2] (not within 1e-3 of 1), the attempt kernel and the
     float32 plain path must accept or reject alike, spans on both sides;
  5b. official heuristic: the official preset with Hairer's first-step
     heuristic (`first_step=None`, `max_steps=64`: the train scripts'
     defaults), whose generic dopri5 solve launches the `fused_rhs` forward
     at every stage over the 2970 segment rows and its backward at every
     stage's VJP: the step-0 loss against the plain path at rtol 1e-4, then
     the timed steps as in phase 4, printing each kernel's launches per step;
  6. fast train: the same for the `fast` preset (rk4, one step per
     interval), which must launch each rk4 segment kernel once per step and
     neither the dopri5 attempt nor the standalone rhs; prints its step-0
     loss beside the official step's on the same params and noise;
  7. eval: the projected scorer (128-draw posterior predictive, test LL and
     MSE in the 50-D data space of the MoCap-09 test split) on the params
     after phase 6, its device metric held against the host metric on the
     same predictions (rtol 1e-4);
  7a. draws attempt: `dopri5_attempt_draws` at the validation request's 32
     draws x 2 rows and the test evaluation's 128 x 2 (the bench problem's
     GP, M=100, S=256, D=5, the FSAL k1 = f(x)) against its plain version:
     x_new and k7 at dt=0.01 (rtol 1e-4, atol 1e-5 * max|ref|), the error
     ratio over the shortest span 0.01 * 1.25^k whose plain ratio exceeds
     1e3, far above the rounding of the stage sums (rel 1e-3), two launches
     bit-identical; its time, the plain
     version's and its bound (6 field evaluations, each draw's operands
     read once), its resources and every built variant free of spills, and
     the device ms of one replay of the captured attempt, fused and plain;
     then the validation request's solve (`flow_forward_batched`, dopri5,
     Hairer's start, 120 steps) a second time: the kernel once per attempt,
     and the commit kernel (`draws_commit`) once per attempt too; then
     `draws_commit` at the same two shapes' states and 120 output times
     against its plain version (the host's `_hermite` ops and hand-over
     copies) bit for bit, over a step of two output times and over the whole
     span, its time at the two-point step beside its bound and the plain
     version's device ms, its registers free of spills, and the captured
     attempt's replay with the commit; then the posterior draw's
     `draw_solve` kernels (the train step's 5 factors of M=100 at 1 and 32
     columns, and M=128) against the float64 library chain (nu and its
     cotangents within 2e-3 of the largest entry), reruns bit-identical,
     each kernel's device ms beside its bound, its plain version's and the
     library chain's (`library_ms`), and both kernels free of spills; the
     official train phase's launches count them on the main path; then the
     shooting states' `state_entropy` kernels at the train step's (6, 99)
     factors of D=5 (and D=2, 8) against the unrolled chain in float32
     (forward within 1e-6, the cotangent bit for bit) and float64 (forward
     and cotangent within 1e-5), reruns bit-identical, each kernel's device ms beside its bound
     and the chain's (`library_ms`: its forward; for the backward, its
     forward and backward less the forward), both kernels' time beside the
     chain's forward and backward, every instantiation free of spills;
  7b. time to test LL: the time-to-LL driver
     (`gpode_tpu_torch.scripts.bench_time_to_nll.main`) in-process, `fast`
     preset, DRIVER_ITERS iterations, tracking evals every 250, 128-draw
     evals: the data-driven init (backward-integrated x0 over 50 draws,
     states at the data, noise variance from a 16-draw predict), then the
     train steps with every launch counter set to 0 just before the driver
     and read just after. It must return 0, set a finite noise variance
     > 0, replay its captured step (phase 7g) in every step after the
     warm-up, launch each rk4 segment kernel once per step and neither the
     dopri5 attempt nor `fused_rhs`, and end at a finite 128-draw test LL
     above phase 7's (read after 23 steps from a random start); prints its
     init seconds and steps/s;
  7c. experiments: the CLI twins in-process (`run(argv)` of
     `gpode_tpu_torch/scripts/train_*.py`) into a temporary directory, on
     the card by default, with `--no_plots`. The MoCap shooting twin's
     default recipe (MoCap-09 at full width: M=100, S=256, 5 draws, 6 x 100
     steps, 5 latents, the 50-D likelihood) for EXPERIMENT_ITERS steps,
     validation and checkpoints every 100: its artifacts with the JAX
     driver's keys and shapes, finite losses and final LL/MSE, the dopri5
     attempt forward and backward once per step (counters set to 0 just
     before, read just after), the `Trainer`'s captured step replayed
     (phase 7g); `--eval_only` on `checkpt_best.npz` must give
     the logged best-val test LL (rtol 1e-6); RESUME_ITERS steps in one go
     against half of them and `--resume` (losses of the second half and the
     final parameters, rtol 1e-6; bit-equality printed); `--solver rk4`
     (the rk4 segment kernels once per step); `--segment_minibatch 16` with
     `--constraint_anneal_iters` (the attempt kernel at 480 rows, the
     annealed scale at the horizon the initial scale); the vanilla MoCap
     and both VDP twins for TINY_ITERS steps (finite losses); prints
     steps/s, the final LL/MSE, calibration and the best-val iteration;
  7d. scale and solvers: the dopri5 attempt kernels at the `scale` step's
     inputs (N=19200 segment rows: 32 draws x 6 x 100; M=256, S=256)
     against their plain versions (forward rtol 1e-4, cotangents atol
     1e-3 * max|g|), the accept RMS (one float32 mean over 96000 values)
     against the same mean in float64 (rel 1e-5), both timed; the `scale`
     train step (M=256, 32 draws, remat): its step-0 loss against the plain
     path (rtol 1e-4), the peak memory of one plain-path step without and
     with remat (remat must be lower), then 3 warm-up and SCALE_STEPS timed
     steps with each attempt kernel once per step (steps/s, peak MiB); a
     forced reject inside the scale step (its interval stretched to the
     shortest span 0.01 * 1.25^k whose plain attempt error RMS exceeds 2):
     the loss through the kernels against the plain path (rtol 1e-4), and
     every gradient leaf against the plain path in float64: no farther from
     it than 1.25x the float32 plain path's distance + 1e-4 * max|g| (both
     float32 paths sit ~1e-3 of max|g| from float64 on this step's
     cancelling sums), and its peak MiB; the official
     step with `use_adjoint` (`fused_rhs` in both directions, no attempt
     kernel; loss rtol 1e-5 and gradients rtol 5e-2, atol 5e-4 against the
     taped step); a MoCap shooting step with `explicit_adams`,
     `implicit_adams` and `adams` (`fused_rhs` in both directions) and `bdf`
     (no kernel), each on the card against the CPU (loss rtol 1e-4), and
     `explicit_adams` with remat (every forward launched once more in the
     backward, the loss unchanged); the VDP twin with `--solver adams` and
     `--solver bdf` for TINY_ITERS steps (finite losses and test LL);
  7g. captured step: the train step as captured CUDA graphs
     (`gpode_tpu_torch/train/graph_step.py`) against the eager step at the
     `official`, `fast` and `scale` presets (the bench problem at full
     width, one copy of its parameters per run, the same noise):
     CAPTURE_STEPS steps each — every loss within rtol 1e-6 of the eager
     one and every parameter within 1e-5 of its largest magnitude
     (bit-equality printed), each segment kernel once per step and
     direction (`LAUNCHES`), two graphs split at the accept read (official,
     `scale`) or one (`fast`), no reject; host syncs per step
     (`torch.cuda.set_sync_debug_mode`): 1 on a captured official or
     `scale` step, 0 on a captured `fast` one (the eager steps' printed);
     CAPTURE_PROFILED steps of each under torch.profiler: device kernels per
     step, the device's busy share of the wall, and each segment kernel's
     device launches equal to its `LAUNCHES` count and to one per step;
     steps/s in windows of CAPTURE_WINDOW steps, eager and captured in
     turns (E, C, C, E) x CAPTURE_ROUNDS; the peak allocated and reserved
     MiB of each run above what was live before it; a forced reject inside
     the captured official step (the grid stretched at two replays by the
     first power of 2 that rejects): attempts, losses and parameters equal
     to the eager run's, both rejects run eagerly after graph A. `scale`
     may instead be refused by `capture_refusal`, its reason printed. The
     `Trainer`, `bench_time_to_nll` and `scripts/bench.py` take the
     captured step too, so phases 7b, 7c, 7e and 7f run it;
  7e. plots, FHN and the neural ODE (run after phase 9: it reads phase 8's
     VDP GP): the native host library's branch and build seconds, and
     whether g++ and matplotlib are here (with g++ the native branch is
     required); the plots' data parts on the card against the CPU on the
     same noise (rtol 1e-4, atol 1e-4 * max|ref|): the VDP field draws on
     the 30x30 and 12x12 grids and their mean, the un-whitened inducing
     posterior of the VDP and the MoCap GP, the grid conditional (one
     `rbf_gram` launch); the VDP twin, vanilla and `--shooting`, and the
     MoCap shooting twin at their defaults for TINY_ITERS steps, plots on
     where matplotlib imports (then the png families of tests/test_plots.py
     and two `rbf_gram` launches per VDP run, none on MoCap; else
     `--no_plots`, said so): finite losses; the FHN shooting twin's default
     step (300 rows, Din=D=2, M=16): the attempt kernels at its inputs
     against their plain versions (forward rtol 1e-4, cotangents atol
     1e-3 * max|g|), timed, the step-0 loss against the plain path (rtol
     1e-4), then TINY_ITERS twin steps with the attempt forward once per
     step (and once more per reject after a replayed graph A: the twin's
     step is captured, phase 7g) and its backward once per accepted step;
     FHN interpolation,
     vanilla and `--shooting` at 6 draws (`fused_rhs` in both directions):
     finite interpolation LL/MSE; the VDP and MoCap neural-ODE twins: the
     step-0 loss on the card against the CPU (rtol 1e-4), finite MSE;
  8. vdp: vanilla GPODE on Van der Pol at the train script's defaults (25
     observations over T=7, noise variance 0.05, M=16, S=256, dimwise,
     dopri5): the step-0 loss on the card against the same step on the CPU
     with the same noise (rtol 1e-4), then 3 warm-up and 20 timed steps, the
     loss finite and lower at the end; then the same with the golden-run
     config (rk4, `ts_dense_scale=2`, reference RFF scale);
  9. field: the vector-field posterior `gp.conditional` under
     `torch.no_grad()` of the trained VDP GP on the 30x30 phase-plane grid
     and of the MoCap GP after phase 6 at 3000 sampled shooting states: mean
     and variance against the same call with grad mode on, which takes
     `rbf_K` (rtol 1e-4, atol 1e-4 * max|ref|), exactly one `rbf_gram`
     launch per call, variances > 0; then `rbf_gram` against its plain
     version at both shapes (the grid's N=900, Din=D=2, M=16 too);
 10. wide A/B: `gpode_tpu_torch.scripts.proto_wide_rhs.main(["--rows",
     "2995"])` in-process (errors of the wide kernels against the per-dim
     reference, then chained timings of all variants); it must return 0;
  7f. mesh (run last, since it leaves this process in a world of 1):
     (a) a world of 1 on NCCL in this process: the MoCap shooting twin at
     its defaults for MESH_ITERS steps (its meters start after 100, so 20
     metered losses) without a mesh and with `--mesh dp=1` under both
     `--parallel` styles: losses and final parameters rtol 1e-6 against the
     run without, the attempt kernels launched; then `scripts.bench
     --preset official --mesh dp=1` prints its JSON line; (b) two ranks over
     gloo on the one card (NCCL refuses two ranks on one GPU), `dp=2`, the
     official and `fast` bench problems at full width (1500 segment rows
     per rank): `gpode_tpu_torch.scripts.mesh_check` in two processes —
     both step styles' loss (rtol 1e-5 against the single-process step or
     the single-process composition of the two rank blocks) and every
     gradient leaf (within 1e-4 * max|g| of the float32 single-process
     gradient; the distances to float64 printed beside it), an accepted
     whole-span attempt on each rank, the attempt kernels (official) or the
     rk4 segment kernels (`fast`) once per step on each rank, parameters
     bit-equal on both ranks after 5 steps of each style,
     `collective_audit`'s 2 collectives per step and none inside a solve;
     (c)
     `capture_trace` over 5 official steps and `analyze_trace` on its
     output: grouped device ms per step beside the profile's
     `key_averages` device time;
 11. a `{"kernels": [...]}` line (rows 6-7 also carry their `scale`
     and FHN times and launches, rows 4-7 their launches under `--mesh`,
     rows 2-3 their launches per step on the adjoint, multistep and FHN
     interpolation paths, row 1 its launches per plot run), the smoke's
     wall seconds, a copy of all results in chiprun_out/chip_smoke.json,
     and as the last line `{"ok": true, "device": {...}}`.

`--profile-steps N` adds a torch.profiler breakdown of N more train steps
after phases 4, 6, 7d (the `scale` step) and 8 (device time by operator,
device busy share).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# the work counts and the card's peaks behind every bound: the benchmark's
# (one operation per flop or transcendental)
from benchmark.opcounts import (bound_s, gram_ops, param_floats, rhs_ops,
                                vjp_ops)
from benchmark.opcounts_draw import draw_solve_bwd, draw_solve_fwd
from benchmark.opcounts_eval import dp_attempt_draws

ROOT = os.path.dirname(os.path.abspath(__file__))

TRAIN_WARMUP, TRAIN_STEPS = 3, 20
KERNEL_ITERS = 50
GEMM_N = 2048
EVAL_DRAWS, EVAL_REPEATS = 128, 3
DRIVER_ITERS = 500

NAMES = ("x", "z", "lengthscales", "variance", "omega", "phase", "weights", "nu")
SOURCES = {"fused_rhs_fwd": "gpode_tpu_torch/csrc/fused_rhs.cu",
           "fused_rhs_bwd": "gpode_tpu_torch/csrc/fused_rhs.cu",
           "fused_dopri5_attempt_fwd": "gpode_tpu_torch/csrc/fused_dopri5.cu",
           "fused_dopri5_attempt_bwd": "gpode_tpu_torch/csrc/fused_dopri5.cu",
           "fused_rk4_segment_fwd": "gpode_tpu_torch/csrc/fused_rk4.cu",
           "fused_rk4_segment_bwd": "gpode_tpu_torch/csrc/fused_rk4.cu",
           "rbf_gram": "gpode_tpu_torch/csrc/rbf_gram.cu",
           "fused_rhs_wide_fwd": "gpode_tpu_torch/csrc/fused_rhs_wide.cu",
           "fused_rhs_wide2_fwd": "gpode_tpu_torch/csrc/fused_rhs_wide.cu",
           "fused_rhs_wide_bwd": "gpode_tpu_torch/csrc/fused_rhs_wide.cu",
           "dopri5_attempt_draws": "gpode_tpu_torch/csrc/dopri5_draws.cu",
           "draws_commit": "gpode_tpu_torch/csrc/dopri5_draws.cu",
           "draw_solve_fwd": "gpode_tpu_torch/csrc/draw_solve.cu",
           "draw_solve_bwd": "gpode_tpu_torch/csrc/draw_solve.cu",
           "state_entropy_fwd": "gpode_tpu_torch/csrc/state_entropy.cu",
           "state_entropy_bwd": "gpode_tpu_torch/csrc/state_entropy.cu"}
REPLACES = {
    "fused_rhs_fwd": "gpode_tpu/ops/pallas_kernels.py:252",
    "fused_rhs_bwd": "gpode_tpu/ops/pallas_kernels.py:467",
    "fused_dopri5_attempt_fwd": "gpode_tpu/ops/pallas_kernels.py:979",
    "fused_dopri5_attempt_bwd": "gpode_tpu/ops/pallas_kernels.py:1027",
    "fused_rk4_segment_fwd": "gpode_tpu/ops/pallas_kernels.py:720",
    "fused_rk4_segment_bwd": "gpode_tpu/ops/pallas_kernels.py:756",
    "rbf_gram": "gpode_tpu/ops/pallas_kernels.py:178",
    "fused_rhs_wide_fwd": "scripts/proto_wide_rhs.py:112",
    "fused_rhs_wide2_fwd": "scripts/proto_wide_rhs.py:168",
    "fused_rhs_wide_bwd": "scripts/proto_wide_rhs.py:305",
    "dopri5_attempt_draws": "none: the batched prediction solve's attempt",
    "draws_commit": "none: the dense output is XLA's in the JAX package",
    "draw_solve_fwd": "none: XLA's Cholesky and triangular solves",
    "draw_solve_bwd": "none: XLA's Cholesky and triangular solves",
    "state_entropy_fwd": "none: XLA fuses the unrolled Cholesky chain",
    "state_entropy_bwd": "none: XLA fuses the unrolled Cholesky chain",
}
# The ten redesigned kernels (six on the row tile, three wide-layout ones and
# `rbf_gram`): device ms per launch before their redesign (`ms`; PERF.md,
# NVIDIA H100 80GB HBM3, 700.00 W) and the ratio of each to one launch of
# the yardstick GEMM of the same call, recorded on the kernels of commit
# 350a559 for the row-tile kernels (`ratio`; PERF.md, GEMM 0.3409 ms), of
# commit 90e806b for the wide ones (GEMM 0.3406 ms) and of commit c02184e
# for `rbf_gram` (GEMM 0.3385 ms).
# Held in every call: the ratio now is at most `limit` — 1.25x the recorded
# ratio for the four segment kernels, and the recorded ratio / 1.5 for the
# two `fused_rhs` kernels, the three wide ones and `rbf_gram` (their
# redesign is 1.5x faster whatever card the call lands on).
EARLIER = {
    "fused_rhs_fwd": dict(ms=0.0321, ratio=0.0951, limit=0.0951 / 1.5),
    "fused_rhs_bwd": dict(ms=0.1692, ratio=0.5013, limit=0.5013 / 1.5),
    "fused_dopri5_attempt_fwd": dict(ms=0.2184, ratio=0.2292, limit=1.25 * 0.2292),
    "fused_dopri5_attempt_bwd": dict(ms=0.8809, ratio=0.5843, limit=1.25 * 0.5843),
    "fused_rk4_segment_fwd": dict(ms=0.1198, ratio=0.1305, limit=1.25 * 0.1305),
    "fused_rk4_segment_bwd": dict(ms=0.5846, ratio=0.4721, limit=1.25 * 0.4721),
    "fused_rhs_wide_fwd": dict(ms=0.0291, ratio=0.0859, limit=0.0859 / 1.5),
    "fused_rhs_wide2_fwd": dict(ms=0.0299, ratio=0.0884, limit=0.0884 / 1.5),
    "fused_rhs_wide_bwd": dict(ms=0.1127, ratio=0.3307, limit=0.3307 / 1.5),
    "rbf_gram": dict(ms=0.0108, ratio=0.0325, limit=0.0325 / 1.5),
}

# the kernels each path must launch, and those a train path must not
MAIN_PATH_KERNELS = {
    "official": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd"),
    "fast": ("fused_rk4_segment_fwd", "fused_rk4_segment_bwd"),
    "official_heuristic": ("fused_rhs_fwd", "fused_rhs_bwd"),
    "driver": ("fused_rk4_segment_fwd", "fused_rk4_segment_bwd"),
    "field": ("rbf_gram",),
    "experiments": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd"),
    "experiments_rk4": ("fused_rk4_segment_fwd", "fused_rk4_segment_bwd"),
    "scale": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd"),
    "adjoint": ("fused_rhs_fwd", "fused_rhs_bwd"),
    "wide_ab": ("fused_rhs_fwd", "fused_rhs_bwd", "fused_rhs_wide_fwd",
                "fused_rhs_wide2_fwd", "fused_rhs_wide_bwd"),
    "predict": ("dopri5_attempt_draws", "draws_commit"),
    "draw": ("draw_solve_fwd", "draw_solve_bwd"),
    "entropy": ("state_entropy_fwd", "state_entropy_bwd"),
}
OFF_PATH_KERNELS = {
    "official": (),
    "fast": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd",
             "fused_rhs_fwd", "fused_rhs_bwd"),
    "official_heuristic": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd",
                           "fused_rk4_segment_fwd", "fused_rk4_segment_bwd"),
}


_T0 = time.perf_counter()


def phase(name):
    """Print the phase's name, the smoke's seconds so far and, once CUDA is
    up, the device memory still allocated by the phases before it."""
    torch = sys.modules.get("torch")
    mem = ""
    if torch is not None and torch.cuda.is_initialized():
        mem = f", {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated"
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s{mem})", flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# work counts for the bounds
# ---------------------------------------------------------------------------

def bound(ops, nbytes):
    """`bound_s` in ms: (the least time the card could take, its limit)."""
    t, by = bound_s(ops, nbytes)
    return 1e3 * t, by


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase():
    phase("device")
    import torch
    if not torch.cuda.is_available():
        raise CheckFailed("no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    return card


def build_phase():
    phase("build")
    from gpode_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    infos = cuda_build.build_all()
    total = time.perf_counter() - t0
    for name, info in infos.items():
        how = "reused, built" if info.reused else "built"
        print(f"{name}: {how} in {info.seconds:.1f} s -> "
              f"{os.path.relpath(info.path, ROOT)}")
        for line in info.ptxas:
            print(f"  {line}")
    print(f"build wall {total:.1f} s", flush=True)
    return {name: info.seconds for name, info in infos.items()}


def cuda_ms(fn, iters=KERNEL_ITERS, warmup=5):
    """Device milliseconds per call of `fn`, free of the host's launch
    overhead (a launch from Python costs about as much as the shortest
    kernels here run): see `gpode_tpu_torch.utils.timing.device_ms`."""
    import torch
    from gpode_tpu_torch.utils.timing import device_ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup   # enqueue time per call

    def enqueue(count):
        for _ in range(count):
            fn()

    return device_ms(enqueue, iters, host_s)


def gemm_ms(dev):
    """Device ms of the ratio checks' yardstick: one float32 product of two
    GEMM_N x GEMM_N matrices (`torch.mm`, TF32 off), which shares no code
    with any kernel of this repository, timed in the same call."""
    import torch
    gen = torch.Generator(dev).manual_seed(3)
    a, b = (torch.randn(GEMM_N, GEMM_N, device=dev, generator=gen)
            for _ in range(2))
    out = torch.empty_like(a)
    ms = cuda_ms(lambda: torch.mm(a, b, out=out))
    print(f"yardstick: torch.mm {GEMM_N}x{GEMM_N} @ {GEMM_N}x{GEMM_N} float32 "
          f"{ms:.4f} ms", flush=True)
    return ms


def main_path_inputs(dev, preset="official"):
    """A preset's step kernel inputs: the flattened shooting states and one
    posterior draw of the bench problem."""
    import torch
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.models.shooting import sample_step_noise, stack_segments
    from gpode_tpu_torch.models.states import sample_shooting_states
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)

    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
                                               device=dev)
    gen = torch.Generator(dev).manual_seed(123)
    with torch.no_grad():
        noise = sample_step_noise(params, args.num_features, args.num_samples, gen)
        x = stack_segments(sample_shooting_states(params.states, noise.x0,
                                                  noise.states))
        draw = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                                 noise.rff_phase, noise.inducing)
        ops = (x, params.gp.z, params.gp.kernel.lengthscales,
               params.gp.kernel.variance, draw.omega, draw.phase,
               gp.kernel_rff_weights(draw.weights), draw.nu)
    dt = (ts[1] - ts[0]).reshape(1)
    return ([t.detach().clone().contiguous().requires_grad_() for t in ops], dt,
            args, params.gp, draw)


def compare_fwd(got, ref, what, atol_scale=1e-5):
    import torch
    got, ref = got.detach(), ref.detach()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = bool(torch.all((got - ref).abs() <= 1e-4 * ref.abs() + atol_scale * scale))
    print(f"  {what}: max_abs_err {err:.3e} (max|ref| {scale:.3e})")
    check(ok and math.isfinite(err), f"{what} disagrees with the plain version")
    return err


def compare_grads(got, ref, what):
    worst = 0.0
    for name, a, b in zip(NAMES, got, ref):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"  {what} d{name}: max_abs_err {err:.3e} (max|g| {scale:.3e})")
        check(math.isfinite(err) and err <= 1e-3 * scale,
              f"{what} d{name} disagrees with the plain version")
        worst = max(worst, err)
    return worst


def kernel_phase(dev, gemm):
    """`fused_rhs` and the dopri5 attempt at the official step's inputs;
    `gemm`: device ms of the yardstick GEMM of this call."""
    phase("kernels")
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck

    inputs, dt, args, _, _ = main_path_inputs(dev)
    x, params = inputs[0], inputs[1:]
    n, din = x.shape
    d, m = params[6].shape
    s = params[5].shape[0]
    print(f"shapes: N={n} Din={din} D={d} M={m} S={s}")
    check((n, din, d, m, s) == (3000, 5, 5, 100, 256),
          "main-path shapes differ from the official recipe")
    g = torch.randn(n, d, device=dev, generator=torch.Generator(dev).manual_seed(7))
    rtol, atol = args.rtol, args.atol
    pf = param_floats(din, d, m, s)
    out = {}

    # -- fused_rhs forward / backward
    f_k = ck.fused_rhs(*inputs)
    f_p = ck.fused_rhs_plain(*inputs)
    e_fwd = compare_fwd(f_k, f_p, "fused_rhs_fwd f")
    e_bwd = compare_grads(torch.autograd.grad(f_k, inputs, g),
                          torch.autograd.grad(f_p, inputs, g, retain_graph=True),
                          "fused_rhs_bwd")
    dims = (din, d, m, s)
    ops = ck._kernel_operands(*[p.detach() for p in params])
    xd = x.detach()
    with torch.no_grad():
        check(torch.equal(ck._launch_rhs_fwd(xd, ops, *dims),
                          ck._launch_rhs_fwd(xd, ops, *dims)),
              "two fused_rhs forward runs differ")
        ms_f = cuda_ms(lambda: ck._launch_rhs_fwd(xd, ops, *dims))
        ms_fp = cuda_ms(lambda: ck.fused_rhs_plain(xd, *[p.detach() for p in params]))
    check(all(torch.equal(a, b) for a, b in zip(
        ck._launch_rhs_bwd(xd, g, ops, *dims), ck._launch_rhs_bwd(xd, g, ops, *dims))),
        "two fused_rhs backward runs differ")
    print("  fused_rhs: two runs bit-identical in each direction")
    ms_b = cuda_ms(lambda: ck._launch_rhs_bwd_packed(xd, g, ops, *dims))
    ms_bp = cuda_ms(lambda: torch.autograd.grad(f_p, inputs, g, retain_graph=True))
    out["fused_rhs_fwd"] = (e_fwd, ms_f, ms_fp, *bound(
        rhs_ops(n, din, d, m, s), 4 * (n * din + pf + n * d)))
    out["fused_rhs_bwd"] = (e_bwd, ms_b, ms_bp, *bound(
        vjp_ops(n, din, d, m, s), 4 * (n * din + n * d + pf + n * din + pf)))

    # -- fused_dopri5_attempt forward / backward
    x5_k, err_k = ck.fused_dopri5_attempt(x, dt, *params, rtol, atol)
    x5_p, err_p, _ = ck.dopri5_attempt_plain(x, dt, *params, rtol, atol)
    e_dfwd = compare_fwd(x5_k, x5_p, "fused_dopri5_attempt_fwd x5")
    # At the step's dt=0.01 the embedded error is of the order of float32
    # rounding of the stage sums (b5 - b4 sums to 0, so k_j's rounding
    # survives the cancellation) in both versions: there only the accept
    # decision (RMS against 1) is held equal. The error estimate itself is
    # held tightly over a long span, where it stands far above rounding.
    rms_k = float(err_k.square().mean().sqrt())
    rms_p = float(err_p.square().mean().sqrt())
    print(f"  fused_dopri5_attempt_fwd err_scaled at dt={float(dt):.4g}: rms "
          f"{rms_k:.6f} vs plain {rms_p:.6f}")
    check((rms_k <= 1.0) == (rms_p <= 1.0), "accept decisions differ")
    e_x5_long, e_err_long = long_span_error_check(
        xd, [p.detach() for p in params], rtol, atol)
    e_dbwd = compare_grads(
        torch.autograd.grad(x5_k, inputs, g),
        torch.autograd.grad(x5_p, inputs, g, retain_graph=True),
        "fused_dopri5_attempt_bwd")
    with torch.no_grad():
        first = ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims)
        check(all(torch.equal(a, b) for a, b in zip(
            first, ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims))),
            "two fused_dopri5_attempt forward runs differ")
        print("  fused_dopri5_attempt_fwd: two runs bit-identical")
        xs = first[2]
        ms_df = cuda_ms(lambda: ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims))
        ms_dfp = cuda_ms(lambda: ck.dopri5_attempt_plain(
            xd, dt, *[p.detach() for p in params], rtol, atol))
    ms_db = cuda_ms(lambda: ck._launch_dp_bwd(xs, g, dt, ops, *dims))
    ms_dbp = cuda_ms(lambda: torch.autograd.grad(x5_p, inputs, g, retain_graph=True))
    first = ck._launch_dp_bwd(xs, g, dt, ops, *dims)
    second = ck._launch_dp_bwd(xs, g, dt, ops, *dims)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "two fused_dopri5_attempt backward runs differ")
    print("  fused_dopri5_attempt_bwd: two runs bit-identical")

    # forward and backward at M=256 (the m256 shape): held and timed
    inputs256, dt256, args256, _, _ = main_path_inputs(dev, "m256")
    m256 = inputs256[1].shape[0]
    check(m256 == 256, "the m256 preset has not M=256")
    x5_k, _ = ck.fused_dopri5_attempt(inputs256[0], dt256, *inputs256[1:],
                                      args256.rtol, args256.atol)
    x5_p, _, xs256 = ck.dopri5_attempt_plain(inputs256[0], dt256, *inputs256[1:],
                                             args256.rtol, args256.atol)
    e_dfwd = max(e_dfwd, compare_fwd(x5_k, x5_p, "fused_dopri5_attempt_fwd x5 (M=256)"))
    e_dbwd = max(e_dbwd, compare_grads(
        torch.autograd.grad(x5_k, inputs256, g),
        torch.autograd.grad(x5_p, inputs256, g), "fused_dopri5_attempt_bwd (M=256)"))
    ops256 = ck._kernel_operands(*[p.detach() for p in inputs256[1:]])
    dims256 = (din, d, m256, s)
    x256 = inputs256[0].detach()
    with torch.no_grad():
        ms_df256 = cuda_ms(lambda: ck._launch_dp_fwd(
            x256, dt256, args256.rtol, args256.atol, ops256, *dims256))
    xs256 = xs256.detach().contiguous()
    ms_db256 = cuda_ms(lambda: ck._launch_dp_bwd(xs256, g, dt256, ops256, *dims256))
    print(f"  fused_dopri5_attempt at M=256: forward {ms_df256:.4f}, backward "
          f"{ms_db256:.4f} ms per launch")

    out["fused_dopri5_attempt_fwd"] = (max(e_dfwd, e_x5_long), ms_df, ms_dfp, *bound(
        7 * rhs_ops(n, din, d, m, s), 4 * (n * din + pf + 2 * n * d + 6 * n * din)))
    out["fused_dopri5_attempt_bwd"] = (e_dbwd, ms_db, ms_dbp, *bound(
        6 * vjp_ops(n, din, d, m, s), 4 * (6 * n * din + n * d + pf + n * din + pf)))

    print_kernel_rows(out)
    resources = {name: report_redesigned_kernel(dev, name, n, dims, out, gemm)
                 for name in ("fused_rhs_fwd", "fused_rhs_bwd")}
    resources["fused_dopri5_attempt_fwd"] = report_redesigned_kernel(
        dev, "fused_dopri5_attempt_fwd", n, dims, out, gemm, ms_m256=ms_df256)
    resources["fused_dopri5_attempt_bwd"] = report_redesigned_kernel(
        dev, "fused_dopri5_attempt_bwd", n, dims, out, gemm, ms_m256=ms_db256)
    return out, e_err_long, resources


def long_span_error_check(x, params, rtol, atol):
    """The attempt kernel over the shortest span (0.01 * 1.25^k) whose plain
    error estimate exceeds 1e3, far above its rounding (about 0.1 at
    rtol = atol = 1e-6). Over such a span the six-stage chain amplifies
    rounding, so both outputs are held against the plain version in float64:
    x5's error may be at most 4 times the float32 plain version's (1e-6 *
    max|ref| at the least); err_scaled within rtol 1e-3 with atol 1e-4 *
    max|ref|, or twice the float32 plain version's own largest error where
    that is more (the estimate divides float32 rounding of the stage sums by
    atol + rtol * |x|, so its smallest entries sit at that rounding in every
    float32 version). Returns the max abs errors of x5 (against the float32
    plain version) and of err_scaled (against float64)."""
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck
    for k in range(60):
        span = 0.01 * 1.25 ** k
        dt = torch.full((1,), span, device=x.device)
        with torch.no_grad():
            x5_p, err_p, _ = ck.dopri5_attempt_plain(x, dt, *params, rtol, atol)
        if float(err_p.abs().max()) > 1e3:
            break
    else:
        raise CheckFailed("no span lifts the embedded error above 1e3")
    with torch.no_grad():
        x5_k, err_k = ck.fused_dopri5_attempt(x, dt, *params, rtol, atol)
        x5_64, err_64, _ = ck.dopri5_attempt_plain(
            x.double(), dt.double(), *[p.double() for p in params], rtol, atol)
    e_k64 = float((x5_k.double() - x5_64).abs().max())
    e_p64 = float((x5_p.double() - x5_64).abs().max())
    limit = max(4 * e_p64, 1e-6 * float(x5_64.abs().max()))
    print(f"  fused_dopri5_attempt_fwd x5 at dt={span:.5g} vs float64: kernel "
          f"{e_k64:.3e}, plain float32 {e_p64:.3e} (limit {limit:.3e}, "
          f"max|ref| {float(x5_64.abs().max()):.3e})")
    check(math.isfinite(e_k64) and e_k64 <= limit,
          f"fused_dopri5_attempt_fwd x5 at dt={span:.5g} is off beyond rounding")
    err = float((err_k.double() - err_64).abs().max())
    err_p64 = float((err_p.double() - err_64).abs().max())
    scale = float(err_64.abs().max())
    floor = max(1e-4 * scale, 2 * err_p64)
    ok = bool(torch.all((err_k.double() - err_64).abs()
                        <= 1e-3 * err_64.abs() + floor))
    print(f"  fused_dopri5_attempt_fwd err_scaled at dt={span:.5g} vs float64: "
          f"kernel {err:.3e}, plain float32 {err_p64:.3e}, kernel vs plain "
          f"float32 {float((err_k - err_p).abs().max()):.3e} (atol {floor:.3e}, "
          f"max|ref| {scale:.3e})")
    check(ok and math.isfinite(err),
          f"fused_dopri5_attempt_fwd err_scaled disagrees at dt={span:.5g}")
    return float((x5_k - x5_p).abs().max()), err


def rk4_kernel_phase(dev, gemm):
    """The rk4 segment kernels at the fast step's inputs, at its 1 substep
    and at 3 (the reverse sweep across steps), at M=256 (the m256_fast
    shape), and twice each for bit-identical results. The rows' times are at
    1 substep; both kernels are also timed at 3 substeps and at M=256.
    `gemm`: device ms of the yardstick GEMM of this call. Returns the two
    kernel rows and their resource reports."""
    phase("kernels: rk4 segment")
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck

    inputs, dt, args, _, _ = main_path_inputs(dev, "fast")
    x, params = inputs[0], inputs[1:]
    n, din = x.shape
    d, m = params[6].shape
    s = params[5].shape[0]
    substeps = args.solver_config().substeps
    print(f"shapes: N={n} Din={din} D={d} M={m} S={s} substeps={substeps}")
    check((n, din, d, m, s, substeps) == (3000, 5, 5, 100, 256, 1),
          "fast-step shapes differ from the fast preset")
    g = torch.randn(n, d, device=dev, generator=torch.Generator(dev).manual_seed(8))
    e_fwd = e_bwd = 0.0
    for sub in (1, 3):
        x1_k = ck.fused_rk4_segment(x, dt, *params, sub)
        x1_p, _ = ck.rk4_segment_plain(x, dt, *params, sub)
        e_fwd = max(e_fwd, compare_fwd(
            x1_k, x1_p, f"fused_rk4_segment_fwd x1 ({sub} substeps)"))
        e_bwd = max(e_bwd, compare_grads(
            torch.autograd.grad(x1_k, inputs, g),
            torch.autograd.grad(x1_p, inputs, g),
            f"fused_rk4_segment_bwd ({sub} substeps)"))

    dims = (din, d, m, s)
    ops = ck._kernel_operands(*[p.detach() for p in params])
    xd, pd = x.detach(), [p.detach() for p in params]
    with torch.no_grad():
        first = ck._launch_rk4_fwd(xd, dt, 1, ops, *dims)
        check(all(torch.equal(a, b) for a, b in zip(
            first, ck._launch_rk4_fwd(xd, dt, 1, ops, *dims))),
            "two fused_rk4_segment forward runs differ")
        print("  fused_rk4_segment_fwd: two runs bit-identical")
        xs = first[1]
        ms_f = cuda_ms(lambda: ck._launch_rk4_fwd(xd, dt, 1, ops, *dims))
        ms_fp = cuda_ms(lambda: ck.rk4_segment_plain(xd, dt, *pd, 1))
    ms_b = cuda_ms(lambda: ck._launch_rk4_bwd(xs, g, dt, 1, ops, *dims))
    x1_p, _ = ck.rk4_segment_plain(x, dt, *params, 1)
    ms_bp = cuda_ms(lambda: torch.autograd.grad(x1_p, inputs, g, retain_graph=True))
    first = ck._launch_rk4_bwd(xs, g, dt, 1, ops, *dims)
    second = ck._launch_rk4_bwd(xs, g, dt, 1, ops, *dims)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "two fused_rk4_segment backward runs differ")
    print("  fused_rk4_segment_bwd: two runs bit-identical")
    with torch.no_grad():
        _, xs3 = ck._launch_rk4_fwd(xd, dt, 3, ops, *dims)
        ms_f3 = cuda_ms(lambda: ck._launch_rk4_fwd(xd, dt, 3, ops, *dims))
    ms_b3 = cuda_ms(lambda: ck._launch_rk4_bwd(xs3, g, dt, 3, ops, *dims))
    print(f"  fused_rk4_segment at 3 substeps: forward {ms_f3:.4f}, backward "
          f"{ms_b3:.4f} ms per launch")

    inputs256, dt256, args256, _, _ = main_path_inputs(dev, "m256_fast")
    check(inputs256[1].shape[0] == 256, "the m256_fast preset has not M=256")
    sub256 = args256.solver_config().substeps
    x1_k = ck.fused_rk4_segment(inputs256[0], dt256, *inputs256[1:], sub256)
    x1_p, _ = ck.rk4_segment_plain(inputs256[0], dt256, *inputs256[1:], sub256)
    e_fwd = max(e_fwd, compare_fwd(x1_k, x1_p, "fused_rk4_segment_fwd x1 (M=256)"))
    e_bwd = max(e_bwd, compare_grads(
        torch.autograd.grad(x1_k, inputs256, g),
        torch.autograd.grad(x1_p, inputs256, g), "fused_rk4_segment_bwd (M=256)"))
    ops256 = ck._kernel_operands(*[p.detach() for p in inputs256[1:]])
    x256 = inputs256[0].detach()
    with torch.no_grad():
        _, xs256 = ck._launch_rk4_fwd(x256, dt256, sub256, ops256, din, d, 256, s)
        ms_f256 = cuda_ms(lambda: ck._launch_rk4_fwd(x256, dt256, sub256, ops256,
                                                     din, d, 256, s))
    ms_b256 = cuda_ms(lambda: ck._launch_rk4_bwd(xs256, g, dt256, sub256, ops256,
                                                 din, d, 256, s))
    print(f"  fused_rk4_segment at M=256: forward {ms_f256:.4f}, backward "
          f"{ms_b256:.4f} ms per launch")

    pf = param_floats(din, d, m, s)
    out = {
        "fused_rk4_segment_fwd": (e_fwd, ms_f, ms_fp, *bound(
            4 * rhs_ops(n, din, d, m, s), 4 * (n * din + pf + n * d + 4 * n * din))),
        "fused_rk4_segment_bwd": (e_bwd, ms_b, ms_bp, *bound(
            4 * vjp_ops(n, din, d, m, s), 4 * (4 * n * din + n * d + pf + n * din + pf))),
    }
    print_kernel_rows(out)
    resources = {
        "fused_rk4_segment_fwd": report_redesigned_kernel(
            dev, "fused_rk4_segment_fwd", n, dims, out, gemm,
            ms_3_substeps=ms_f3, ms_m256=ms_f256),
        "fused_rk4_segment_bwd": report_redesigned_kernel(
            dev, "fused_rk4_segment_bwd", n, dims, out, gemm,
            ms_3_substeps=ms_b3, ms_m256=ms_b256)}
    return out, resources


def print_kernel_rows(out):
    for name, (err, ms, pms, bms, by) in out.items():
        print(f"{name}: {ms:.4f} ms kernel, {pms:.4f} ms plain, bound "
              f"{bms:.4f} ms ({by}), max_abs_err {err:.3e}")


def print_resources(name, report):
    """One kernel's registers and spills (the build's ptxas record), block
    size, dynamic shared memory and residency (the occupancy query)."""
    print(f"{name} resources: {report['ptxas_registers']} registers, spill "
          f"{report['spill_stores']} B stores / {report['spill_loads']} B loads, "
          f"{report['local_bytes']} B local; block {report['threads']} threads, "
          f"{report['smem_bytes']} B dynamic shared memory; resident "
          f"{report['blocks_per_sm']} blocks = {report['warps_per_sm']} warps "
          f"per SM ({report['entry']})")
    check(report["blocks_per_sm"] >= 1, f"{name} does not fit an SM")
    check(report["registers"] == report["ptxas_registers"],
          f"{name}: the loaded kernel is not the one ptxas reported")
    return report


# the row-tile kernels' (direction, stages) by name; stages None: fused_rhs
TILE = {"fused_rhs_fwd": ("fwd", None), "fused_rhs_bwd": ("bwd", None),
        "fused_dopri5_attempt_fwd": ("fwd", 6),
        "fused_dopri5_attempt_bwd": ("bwd", 6),
        "fused_rk4_segment_fwd": ("fwd", 4),
        "fused_rk4_segment_bwd": ("bwd", 4)}


def variant_table(name):
    """(library, kernel, the mangled template argument after the variant's
    ints, {label: the mangled-name key of each instantiated variant}) of a
    redesigned kernel: (dp, rt, maxt) variants, or dp alone for `rbf_gram`."""
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops import wide_rhs as wr
    if name == "rbf_gram":
        lib_name, kernel, _ = ck.GRAM_KERNEL
        return lib_name, kernel, "", {f"<{dp}>": ck.gram_variant_key(dp)
                                      for dp in ck.GRAM_VARIANTS}
    if name in wr.WIDE_KERNELS:
        direction, suffix = wr.WIDE_KERNELS[name]
        lib_name, kernel = "fused_rhs_wide", wr.WIDE_KERNEL_NAMES[direction]
        variants = wr.WIDE_VARIANTS[direction]
    else:
        direction, stages = TILE[name]
        suffix = ""
        if stages is None:
            (lib_name, kernel, _), variants = (ck.RHS_KERNELS[direction],
                                               ck.RHS_VARIANTS[direction])
        else:
            (lib_name, kernel, _), variants = (
                ck.SEGMENT_KERNELS[direction, stages],
                ck.SEGMENT_VARIANTS[direction, stages])
    return lib_name, kernel, suffix, {
        f"<{dp}, {rt}, {maxt}>": ck.variant_key(kernel, dp, rt, maxt, suffix)
        for dp, rt, maxt in variants}


def check_variants_free_of_spills(name):
    """Every instantiated variant of a redesigned kernel (one per range of
    Din, or of max(Din, D) for the wide kernels), from the build's ptxas
    record: the table the launch geometry selects from is what was built,
    and none of it spills."""
    from gpode_tpu_torch.ops import cuda_build
    lib_name, kernel, suffix, variants = variant_table(name)
    built = {k: v for k, v in cuda_build.kernel_resources(lib_name).items()
             if kernel in k and f"{suffix}E" in k}
    for label, key in variants.items():
        found = [v for k, v in built.items() if key in k]
        check(len(found) == 1, f"{name}: {len(found)} builds of {key}")
        print(f"  {name} variant {label}: {found[0]['registers']} "
              f"registers, spill {found[0]['spill_stores']} B stores / "
              f"{found[0]['spill_loads']} B loads")
        check(found[0]["spill_stores"] == 0 and found[0]["spill_loads"] == 0,
              f"{name} variant {label} spills registers")
    check(len(built) == len(variants),
          f"{name}: {len(built)} variants built, the geometry selects from "
          f"{len(variants)}")


def report_redesigned_kernel(dev, name, n, dims, out, gemm, **extra):
    """A redesigned kernel (a row-tile kernel, a wide-layout one or
    `rbf_gram`) at N rows of shape `dims` (Din, D, M, S): its resources at
    that geometry,
    every built variant free of spills, and its time against its earlier
    one, one launch of the yardstick GEMM of this call (`gemm` ms) and its
    bound (`out[name]`: the kernel row). Holds the ratio limit."""
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops import wide_rhs as wr
    if name == "rbf_gram":
        din, d, m, _ = dims
        geo = ck.gram_geometry(n, din, d, m, ck._sms(dev))
        occupancy = ck.gram_occupancy(din, d, m, geo)
    elif name in wr.WIDE_KERNELS:
        din, d, m, s = dims
        occupancy, geo = wr.wide_occupancy(
            name, n, din, d, wr._ceil_to(s, wr.KERNEL_PAD),
            wr._ceil_to(m, wr.KERNEL_PAD), ck._sms(dev))
    else:
        direction, stages = TILE[name]
        if stages is None and direction == "fwd":
            geo = ck.rhs_fwd_geometry(n, *dims)
        elif stages is None:
            geo = ck.rhs_bwd_geometry(n, *dims, ck._sms(dev))
        elif direction == "fwd":
            geo = ck.segment_fwd_geometry(n, *dims, stages)
        else:
            geo = ck.segment_bwd_geometry(n, *dims, stages, ck._sms(dev))
        occupancy = (ck.rhs_occupancy(direction, *dims, geo) if stages is None
                     else ck.segment_occupancy(direction, stages, *dims, geo))
    report = print_resources(name, occupancy)
    check_variants_free_of_spills(name)
    was = EARLIER[name]
    ms, bound_ms = out[name][1], out[name][3]
    ratio = ms / gemm
    print(f"{name}: {ms:.4f} ms per launch ({was['ms']:.4f} ms before its "
          f"redesign: {was['ms'] / ms:.2f}x); {ratio:.4f}x the yardstick GEMM "
          f"of this call ({gemm:.4f} ms; {was['ratio']:.4f}x on the parent, "
          f"limit {was['limit']:.4f}x); {100 * bound_ms / ms:.1f}% of its "
          f"bound ({bound_ms:.4f} ms)")
    check(ratio <= was["limit"], f"{name} takes {ratio:.4f}x the yardstick "
          f"GEMM, over the limit {was['limit']:.4f}x")
    return dict(ms=ms, earlier_ms=was["ms"], ratio_to_gemm=ratio,
                parent_ratio=was["ratio"], limit=was["limit"],
                bound_share=bound_ms / ms, blocks=geo.blocks,
                rows_per_block=(geo.rows_per_block
                                if hasattr(geo, "rows_per_block") else geo.rt),
                **report, **extra)


def gram_wide_kernel_phase(dev, gemm):
    """`rbf_gram` and the three wide-layout rhs kernels at the MoCap-09 step's
    inputs (and the M=256 preset's), each against its plain version on the
    same operands, and each twice for bit-identical results.
    Times are at N=3000, M=100; `gemm`: device ms of the yardstick GEMM of
    this call. Returns the four kernel rows and their resource reports."""
    phase("kernels: rbf_gram and the wide layout")
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops import wide_rhs as wr

    shapes = {}
    for preset in ("official", "m256"):
        inputs, _, _, _, _ = main_path_inputs(dev, preset)
        shapes[preset] = [t.detach() for t in inputs]
    x, params = shapes["official"][0], shapes["official"][1:]
    n, din = x.shape
    d, m = params[6].shape
    s = params[5].shape[0]
    check((n, din, d, m, s) == (3000, 5, 5, 100, 256)
          and shapes["m256"][1].shape[0] == 256,
          "main-path shapes differ from the official and m256 presets")
    pf = param_floats(din, d, m, s)
    out = {}

    # -- rbf_gram: K(x, Z) of the step's states against the inducing points
    e_gram = 0.0
    with torch.no_grad():
        for what, (xx, pp) in {
                "N=3000 M=100": (x, params), "N=77 M=100": (x[:77].contiguous(), params),
                "N=3000 M=256": (shapes["m256"][0], shapes["m256"][1:])}.items():
            z, ls, var = pp[0], pp[1], pp[2]
            e_gram = max(e_gram, compare_fwd(
                ck.rbf_gram(xx, z, ls, var), ck.rbf_gram_plain(xx, z, ls, var),
                f"rbf_gram K ({what})"))
        # a Din past the exact variants: the runtime-Din variant, which no
        # MoCap or VDP path reaches
        gen = torch.Generator(dev).manual_seed(17)
        wide = (torch.randn(n, 17, device=dev, generator=gen),
                torch.randn(m, 17, device=dev, generator=gen),
                3.0 + torch.rand(d, 17, device=dev, generator=gen),
                0.3 + torch.rand(d, device=dev, generator=gen))
        check(ck.gram_geometry(n, 17, d, m, ck._sms(dev)).dp == ck.GRAM_ANY_DIN,
              "Din=17 does not take the runtime-Din variant")
        e_gram = max(e_gram, compare_fwd(
            ck.rbf_gram(*wide), ck.rbf_gram_plain(*wide),
            "rbf_gram K (N=3000 Din=17 M=100, runtime-Din variant)"))
        z, ls, var = params[0], params[1], params[2]
        inv_ls = (1.0 / ls).contiguous()
        gram = ck._launch_rbf_gram(x, z, inv_ls, var)
        check(torch.equal(gram, ck._launch_rbf_gram(x, z, inv_ls, var)),
              "two rbf_gram runs differ")
        print("  rbf_gram: two runs bit-identical")
        ms_g = cuda_ms(lambda: ck._launch_rbf_gram(x, z, inv_ls, var))
        ms_gp = cuda_ms(lambda: ck.rbf_gram_plain(x, z, ls, var))
        # the write yardstick: the same (D, N, M) float32 bytes written by
        # one PyTorch call (printed, not held)
        ms_fill = cuda_ms(lambda: gram.fill_(1.0))
    out["rbf_gram"] = (e_gram, ms_g, ms_gp, *bound(
        gram_ops(n, din, d, m),
        4 * (n * din + m * din + d * din + d + d * n * m)))
    print(f"rbf_gram: {ms_g:.4f} ms per launch; fill_ of its (D, N, M) output "
          f"{ms_fill:.4f} ms (write yardstick: kernel / fill_ "
          f"{ms_g / ms_fill:.2f})")

    # -- the wide layout: kernels against plain versions on packed operands
    errs = {"fused_rhs_wide_fwd": 0.0, "fused_rhs_wide2_fwd": 0.0,
            "fused_rhs_wide_bwd": 0.0}
    timed = None
    with torch.no_grad():
        for preset, rows in (("official", 2995), ("official", 3000),
                             ("m256", 2995), ("m256", 3000)):
            xx = shapes[preset][0][:rows].contiguous()
            pp = shapes[preset][1:]
            mm = pp[0].shape[0]
            what = f"N={rows} M={mm}"
            g = torch.randn(rows, d, device=dev,
                            generator=torch.Generator(dev).manual_seed(9))
            b, phase_w, zn_w, invls2_t, wblk, sp, mp = wr.kernel_pack(*pp)
            flat = wr.wide_flat_weights(wblk, d, sp, mp)
            packed = (b, phase_w, zn_w, invls2_t)
            f_wide = wr.fused_rhs_wide(xx, *pp)
            errs["fused_rhs_wide_fwd"] = max(errs["fused_rhs_wide_fwd"], compare_fwd(
                f_wide, wr.fused_rhs_wide_plain(xx, *pp),
                f"fused_rhs_wide_fwd f ({what})"))
            f_wide2 = wr.fused_rhs_wide2(xx, *pp)
            errs["fused_rhs_wide2_fwd"] = max(errs["fused_rhs_wide2_fwd"], compare_fwd(
                f_wide2, wr.fused_rhs_wide2_plain(xx, *pp),
                f"fused_rhs_wide2_fwd f ({what})"))
            check(torch.equal(f_wide, wr.fused_rhs_wide(xx, *pp)),
                  f"two fused_rhs_wide forward runs differ ({what})")
            check(torch.equal(f_wide2, wr.fused_rhs_wide2(xx, *pp)),
                  f"two fused_rhs_wide2 forward runs differ ({what})")
            compare_fwd(f_wide, ck.fused_rhs_plain(xx, *pp),
                        f"fused_rhs_wide f vs the per-dim plain rhs ({what})")
            got = wr.fused_rhs_wide_bwd(xx, *pp, g)
            errs["fused_rhs_wide_bwd"] = max(errs["fused_rhs_wide_bwd"], compare_grads(
                got, wr.fused_rhs_wide_bwd_plain(xx, *pp, g),
                f"fused_rhs_wide_bwd ({what})"))
            again = wr.fused_rhs_wide_bwd(xx, *pp, g)
            check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
                  f"two fused_rhs_wide backward runs differ ({what})")
            if (preset, rows) == ("official", 3000):
                timed = (xx, g, packed, wblk, flat, sp, mp)
        print("  fused_rhs_wide_fwd, fused_rhs_wide2_fwd, fused_rhs_wide_bwd: two "
              "runs bit-identical at every shape")
        xx, g, packed, wblk, flat, sp, mp = timed
        ms = {
            "fused_rhs_wide_fwd": (
                cuda_ms(lambda: wr.launch_wide_fwd(xx, *packed, wblk, d, sp, mp, dense=True)),
                cuda_ms(lambda: wr.wide_fwd_packed_plain(xx, *packed, wblk, d, sp, mp))),
            "fused_rhs_wide2_fwd": (
                cuda_ms(lambda: wr.launch_wide_fwd(xx, *packed, flat, d, sp, mp, dense=False)),
                cuda_ms(lambda: wr.wide2_fwd_packed_plain(xx, *packed, flat, d, sp, mp))),
            "fused_rhs_wide_bwd": (
                cuda_ms(lambda: wr.launch_wide_bwd(xx, g, *packed, wblk, d, sp, mp)),
                cuda_ms(lambda: wr.wide_bwd_packed_plain(xx, g, *packed, wblk, d, sp, mp))),
        }
    # the function's work, whatever the layout: the per-dim rhs's counts
    fwd_bound = bound(rhs_ops(n, din, d, m, s), 4 * (n * din + pf + n * d))
    bwd_bound = bound(vjp_ops(n, din, d, m, s),
                      4 * (n * din + n * d + pf + n * din + pf))
    for name in errs:
        out[name] = (errs[name], *ms[name],
                     *(bwd_bound if name.endswith("bwd") else fwd_bound))
    print_kernel_rows(out)
    resources = {name: report_redesigned_kernel(dev, name, n, (din, d, m, s), out, gemm)
                 for name in errs}
    resources["rbf_gram"] = report_redesigned_kernel(
        dev, "rbf_gram", n, (din, d, m, s), out, gemm, fill_ms=ms_fill)
    return out, resources


VDP_DATA = dict(s_train=25, t_train=7.0, noise_var=0.05, mu=0.5)
VDP_CONFIGS = {
    # the train script's defaults (scripts/_cli.py, train/experiments.py)
    "default": dict(solver="dopri5", ts_dense_scale=4, max_steps=64),
    # the golden-trajectory config of tests/test_golden.py
    "golden": dict(solver="rk4", ts_dense_scale=2),
}


def vdp_phase(dev, config, profile_steps=0):
    """Vanilla GPODE on Van der Pol: the step-0 loss on the card against the
    same step on the CPU with the same noise, then the timed train steps
    (and `profile_steps` profiled ones). Returns (results, trained params,
    data)."""
    phase(f"vdp ({config})")
    import numpy as np
    import torch
    from gpode_tpu_torch.convert import gpode_params_from_numpy, params_to_numpy
    from gpode_tpu_torch.data.vanderpol import VanderPol
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.models.gpode import (GPODEStepNoise,
                                              sample_gpode_step_noise)
    from gpode_tpu_torch.models.init import (initialize_inducing,
                                             initialize_kernel_parameters)
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.builders import (ModelArgs, build_gpode,
                                                gpode_loss_fn)
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    n_obs = VDP_DATA["s_train"]
    data = VanderPol(s_test=2 * n_obs,
                     t_test=VDP_DATA["t_train"] * (2 * n_obs - 1) / (n_obs - 1),
                     x0=np.array([[-1.5, 2.5]]), **VDP_DATA)
    args = ModelArgs(num_inducing=16, num_features=256, dimwise=True,
                     **VDP_CONFIGS[config])
    gp.set_rff_reference_scale(config == "golden")
    try:
        params = build_gpode(torch.Generator().manual_seed(121), args,
                             data.trn.ys, device=dev)
        initialize_kernel_parameters(params.gp)
        initialize_inducing(params.gp, data.trn.ys, float(data.trn.ts.max()),
                            1e0, rng=np.random.RandomState(121))
        ys = torch.as_tensor(data.trn.ys, device=dev)
        ts = torch.as_tensor(data.trn.ts, device=dev)
        loss_fn = gpode_loss_fn(args)
        gen = torch.Generator(dev).manual_seed(121)
        noise0 = sample_gpode_step_noise(params, args.num_features, gen)
        cpu_params = gpode_params_from_numpy(params_to_numpy(params), device="cpu")
        cpu_noise = GPODEStepNoise(**{k: v.cpu() for k, v in vars(noise0).items()})
        with torch.no_grad():
            loss_d, terms_d = loss_fn(params, noise0, ys, ts)
            loss_c, terms_c = loss_fn(cpu_params, cpu_noise, ys.cpu(), ts.cpu())
        ld, lc = float(loss_d), float(loss_c)
        print(f"step-0 loss: card {ld:.8f} (nfe {terms_d.nfe} natt {terms_d.natt} "
              f"ncov {terms_d.ncov}), CPU {lc:.8f} (nfe {terms_c.nfe} natt "
              f"{terms_c.natt} ncov {terms_c.ncov})")
        check(math.isfinite(ld) and abs(ld - lc) <= 1e-4 * abs(lc),
              "the VDP step-0 loss on the card differs from the CPU's")
        check(terms_d.ncov == n_obs + 1, "the solver did not cover the grid")

        step = make_train_step(loss_fn, params, default_optimizer(params, 5e-3))
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        losses, nfe, natt = [], 0, 0
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
            terms = step(sample_gpode_step_noise(params, args.num_features, gen),
                         ys, ts)
            losses.append(float(terms.loss.detach()))
            nfe, natt = nfe + terms.nfe, natt + terms.natt
            check(terms.ncov == n_obs + 1, f"step {i} did not cover the grid")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        sps = TRAIN_STEPS / seconds
        print(f"loss first {losses[0]:.6f} last {losses[-1]:.6f}; {sps:.2f} "
              f"steps/s ({1e3 / sps:.3f} ms/step) over {TRAIN_STEPS} steps; nfe "
              f"{nfe} natt {natt} in all, ncov {terms.ncov} per step; peak "
              f"memory {peak / 2**20:.1f} MiB; kernel launches "
              f"{sum(launches.values())}")
        if profile_steps:
            profile_train_steps(step, lambda: sample_gpode_step_noise(
                params, args.num_features, gen), ys, ts, profile_steps,
                f"vdp_{config}")
    finally:
        gp.set_rff_reference_scale(False)
    check(all(math.isfinite(v) for v in losses), "non-finite VDP training loss")
    check(losses[-1] < losses[0], "the VDP loss did not fall")
    # one row, far below the 256-row gate: the rhs is the plain path; the
    # draw factors K(Z, Z) itself, through the draw_solve kernels
    rhs = {k: v for k, v in launches.items() if not k.startswith("draw_solve")}
    check(sum(rhs.values()) == 0, "a kernel launched on the 1-row VDP path")
    check(launches["draw_solve_fwd"] > 0 and launches["draw_solve_bwd"] > 0,
          "the VDP draw did not take the draw_solve kernels")
    return dict(step0_card=ld, step0_cpu=lc, loss_first=losses[0],
                loss_last=losses[-1], steps_per_sec=sps, nfe=nfe, natt=natt,
                ncov=terms.ncov, peak_bytes=peak), params, data


def field_phase(dev, vdp_params, vdp_data, mocap_args, mocap_params):
    """The vector-field posterior through `rbf_gram`: `gp.conditional` of the
    trained VDP GP on the 30x30 phase-plane grid and of the trained MoCap GP
    at 3000 sampled shooting states, against the same call with grad mode on
    (the `rbf_K` route), then `rbf_gram` against its plain version at both
    shapes. Returns (results, launches, the worst `rbf_gram` error)."""
    phase("field")
    import numpy as np
    import torch
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.models.shooting import sample_step_noise, stack_segments
    from gpode_tpu_torch.models.states import sample_shooting_states
    from gpode_tpu_torch.ops import cuda_kernels as ck

    xx, yy = np.meshgrid(np.linspace(*vdp_data.xlim, 30),
                         np.linspace(*vdp_data.ylim, 30))
    grid = torch.as_tensor(np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1),
                           dtype=torch.float32, device=dev)
    with torch.no_grad():
        noise = sample_step_noise(mocap_params, mocap_args.num_features,
                                  mocap_args.num_samples,
                                  torch.Generator(dev).manual_seed(5))
        states = stack_segments(sample_shooting_states(
            mocap_params.states, noise.x0, noise.states)).contiguous()
    results = {}
    ck.reset_launch_counts()                     # main path starts here
    for name, gp_params, x in (("vdp_grid", vdp_params.gp, grid),
                               ("mocap_states", mocap_params.gp, states)):
        before = ck.LAUNCHES["rbf_gram"]
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = gp.conditional(gp_params, x)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        check(ck.LAUNCHES["rbf_gram"] == before + 1,
              f"conditional ({name}) did not launch rbf_gram exactly once")
        # grad mode on and the trained parameters require grad: the dispatch
        # rule takes rbf_K
        mean_k, var_k = gp.conditional(gp_params, x)
        check(ck.LAUNCHES["rbf_gram"] == before + 1 and mean_k.requires_grad,
              "the differentiable route did not take rbf_K")
        d = gp_params.u_mean.shape[1]
        check(mean.shape == (x.shape[0], d) and var.shape == (x.shape[0], d),
              f"conditional ({name}) returned the wrong shapes")
        # the two routes form the Gram differently (outer differences against
        # rbf_K's norm expansion, ~1e-6 apart) and the whitening solve with
        # chol(K(Z,Z) + 1e-5 I) amplifies that: atol 1e-4 * max|ref|
        e_mean = compare_fwd(mean, mean_k, f"conditional mean ({name}, "
                             f"N={x.shape[0]} D={d} M={gp_params.num_inducing})",
                             atol_scale=1e-4)
        e_var = compare_fwd(var, var_k, f"conditional var ({name})",
                            atol_scale=1e-4)
        vmin = float(var.min())
        print(f"  {name}: var min {vmin:.3e} max {float(var.max()):.3e}; "
              f"{1e3 * seconds:.3f} ms per call (host clock, first call)")
        check(math.isfinite(vmin) and vmin > 0.0,
              f"conditional ({name}) has a variance <= 0")
        results[name] = dict(rows=x.shape[0], mean_max_abs_err=e_mean,
                             var_max_abs_err=e_var, var_min=vmin,
                             seconds=seconds)
    launches = dict(ck.LAUNCHES)                 # main path ends here
    check(launches["rbf_gram"] == 2, "rbf_gram launches on the field path")
    # the wrapper against its plain version at both shapes the path gave it
    e_gram = 0.0
    with torch.no_grad():
        for name, gp_params, x in (("vdp_grid", vdp_params.gp, grid),
                                   ("mocap_states", mocap_params.gp, states)):
            ops = (x, gp_params.z, gp_params.kernel.lengthscales,
                   gp_params.kernel.variance)
            e_gram = max(e_gram, compare_fwd(
                ck.rbf_gram(*ops), ck.rbf_gram_plain(*ops),
                f"rbf_gram K ({name}, N={x.shape[0]} Din={x.shape[1]} "
                f"M={gp_params.num_inducing})"))
    return results, launches, e_gram


def wide_ab_phase():
    """The wide-layout A/B entry point, in-process, at its default shapes."""
    phase("wide A/B")
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.scripts import proto_wide_rhs
    ck.reset_launch_counts()                     # main path starts here
    rc = proto_wide_rhs.main(["--rows", "2995"])
    launches = dict(ck.LAUNCHES)                 # main path ends here
    print(f"proto_wide_rhs returned {rc}; launches {launches}", flush=True)
    check(rc == 0, "the wide A/B entry point reported a mismatch")
    return launches


def driver_phase(random_start_ll):
    """The time-to-LL driver in-process at a short `fast` run (phase 7b);
    `random_start_ll`: phase 7's test LL. Returns (its JSON's scalars, the
    launches of its run)."""
    phase("time to test LL (driver)")
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.scripts import bench_time_to_nll
    from gpode_tpu_torch.ops.capture import WARMUP
    out = os.path.join(ROOT, "chiprun_out", "chip_smoke_time_to_nll.json")
    rec = _Recorder()
    try:
        ck.reset_launch_counts()                 # main path starts here
        rc = bench_time_to_nll.main([
            "--preset", "fast", "--num_iter", str(DRIVER_ITERS), "--eval_every",
            "250", "--eval_draws", str(EVAL_DRAWS), "--out", out])
        launches = dict(ck.LAUNCHES)             # main path ends here
    finally:
        rec.restore()
    check(rc == 0, f"the time-to-LL driver returned {rc}")
    print(f"captured step: {rec.replays} replays", flush=True)
    check(rec.replays == DRIVER_ITERS - WARMUP,
          "the time-to-LL driver did not replay its captured step")
    with open(out) as f:
        res = json.load(f)
    noise_var = res["noise_variance"]
    ll, mse = res["final"]["test_ll"], res["final"]["test_mse"]
    print(f"init {res['init_seconds']:.2f} s; {res['train_steps_per_sec']:.2f} "
          f"steps/s over {res['final']['iter']} steps; noise variance "
          f"{min(noise_var):.4g} .. {max(noise_var):.4g}; final {EVAL_DRAWS}-draw "
          f"test LL {ll:.6f} MSE {mse:.6f} (random start, phase 7: "
          f"{random_start_ll:.6f}); crossings {res['crossings']}; launches "
          f"{launches}", flush=True)
    check(all(math.isfinite(v) and v > 0.0 for v in noise_var),
          "the driver's noise variance is not finite and positive")
    check(math.isfinite(ll) and ll > random_start_ll,
          "the driver's final test LL is not above the random start's")
    for name in MAIN_PATH_KERNELS["driver"]:
        check(launches[name] == DRIVER_ITERS,
              f"{name} launched {launches[name]} times in {DRIVER_ITERS} steps")
    for name in OFF_PATH_KERNELS["fast"]:
        check(launches[name] == 0, f"{name} launched on the driver's path")
    return {k: v for k, v in res.items() if k != "trace"}, launches


EXPERIMENT_ITERS, RESUME_ITERS, SHORT_ITERS, TINY_ITERS = 300, 200, 50, 20
# the JAX driver's artifacts of a MoCap-09 run (6 x 100 train, 2 x 120 test,
# 5 latents, 50-D data space) at EVAL_DRAWS draws
MOCAP_PREDICTIONS = {"train_pred_zs": (EVAL_DRAWS, 6, 100, 5),
                     "train_pred_ys": (EVAL_DRAWS, 6, 100, 50),
                     "test_pred_zs": (EVAL_DRAWS, 2, 120, 5),
                     "test_pred_ys": (EVAL_DRAWS, 2, 120, 50),
                     "obs_noisevar": (50,)}
MOCAP_TRACE_KEYS = {"loss", "observ_nll", "state_kl", "x0_kl", "inducing_kl",
                    "step_time", "val_ll", "val_mse"}


class _Recorder:
    """Wraps the functions a run goes through, to read what the CLI does not
    print: each `Trainer.train` call's iterations and seconds, the rows of
    each `fused_dopri5_attempt` call, and each step's loss (detached, read
    after the run), solver attempts and annealed constraint scale. An eager
    step's come from its ELBO; a captured step's (`graph_step.CapturedStep`,
    whose replays call no ELBO and whose capture computes none) from the
    terms it returns, its ELBO calls inside it not recorded; `replays` and
    `rejects` count its replayed steps and its rejects after a replayed
    graph A (no reference to a step is kept: its graphs' memory would stay
    allocated into later phases)."""

    def __init__(self):
        from gpode_tpu_torch.models import flow, gpode, shooting
        from gpode_tpu_torch.train import graph_step, trainer
        self.targets = [(trainer.Trainer, "train"),
                        (flow, "fused_dopri5_attempt"),
                        (gpode, "elbo_loss"), (shooting, "elbo_loss"),
                        (graph_step.CapturedStep, "__call__")]
        self.saved = [getattr(o, n) for o, n in self.targets]
        self.reset()
        rec, (train, attempt, v_elbo, s_elbo, captured) = self, self.saved

        def train_w(trainer_self, params, gen, *batch, start_iter=1,
                    opt_state=None):
            t0 = time.perf_counter()
            out = train(trainer_self, params, gen, *batch,
                        start_iter=start_iter, opt_state=opt_state)
            rec.trains.append((trainer_self.cfg.num_iter - start_iter + 1,
                               time.perf_counter() - t0))
            return out

        def attempt_w(x0, *a, **k):
            rec.rows.add(x0.shape[0])
            return attempt(x0, *a, **k)

        def v_elbo_w(*a, **k):
            loss, terms = v_elbo(*a, **k)
            rec.losses.append(loss.detach())
            return loss, terms

        def s_elbo_w(*a, constraint_raw_scale=None, **k):
            loss, terms = s_elbo(*a, constraint_raw_scale=constraint_raw_scale,
                                 **k)
            if not rec.in_captured:
                rec.losses.append(loss.detach())
                rec.natts.append(terms.natt)
            rec.raw_scale = constraint_raw_scale
            return loss, terms

        def captured_w(step_self, noise, *batch):
            before = step_self.replays, step_self.rejects
            rec.in_captured += 1
            try:
                terms = captured(step_self, noise, *batch)
            finally:
                rec.in_captured -= 1
            rec.replays += step_self.replays - before[0]
            rec.rejects += step_self.rejects - before[1]
            rec.losses.append(terms.loss.detach())
            rec.natts.append(terms.natt)
            return terms

        for (o, n), w in zip(self.targets, (train_w, attempt_w, v_elbo_w,
                                            s_elbo_w, captured_w)):
            setattr(o, n, w)

    def reset(self):
        self.trains, self.rows, self.losses, self.raw_scale = [], set(), [], None
        self.natts, self.in_captured, self.replays, self.rejects = [], 0, 0, 0

    def restore(self):
        for (o, n), f in zip(self.targets, self.saved):
            setattr(o, n, f)

    def steps_per_sec(self):
        iters = sum(n for n, _ in self.trains)
        return iters / sum(s for _, s in self.trains)

    def all_losses_finite(self):
        import torch
        return bool(torch.all(torch.isfinite(torch.stack(self.losses))))


def _checkpoint_params(path):
    from gpode_tpu_torch.utils.checkpoint import load_checkpoint
    return load_checkpoint(path)["params"]


def experiments_phase(tmp):
    """The CLI twins in-process into `tmp` at MoCap-09 full width (phase
    7c); returns (results, the default run's launches, the rk4 run's)."""
    phase("experiments (CLI twins)")
    import numpy as np
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops.math import softplus
    from gpode_tpu_torch.scripts import (train_mocap_gpode,
                                         train_mocap_gpode_shooting,
                                         train_vdp_gpode,
                                         train_vdp_gpode_shooting)
    shoot = train_mocap_gpode_shooting.run
    data = ["--no_plots", "--data_path", os.path.join(ROOT, "data", "mocap")]
    out, rec = {}, _Recorder()
    try:
        # -- the default recipe, 300 steps
        d1 = os.path.join(tmp, "default")
        rec.reset()
        ck.reset_launch_counts()                 # main path starts here
        _, trainer, m = shoot(data + [
            "--num_iter", str(EXPERIMENT_ITERS), "--val_freq", "100",
            "--checkpoint_every", "100", "--log_freq", "50", "--save", d1])
        launches = dict(ck.LAUNCHES)             # main path ends here
        with open(os.path.join(d1, "optimization_trace.json")) as f:
            trace = json.load(f)
        with open(os.path.join(d1, "train_args.json")) as f:
            train_args = json.load(f)
        with np.load(os.path.join(d1, "model_predictions.npz")) as z:
            shapes = {k: z[k].shape for k in z.files}
        sps = 1.0 / float(np.mean(trace["step_time"]["vals"]))
        print(f"default: {sps:.2f} steps/s (Trainer); final test LL "
              f"{m['test_ll']:.6f} MSE {m['test_mse']:.6f}; best-val iter "
              f"{m['bestval_iter']} test LL {m['test_ll_bestval']:.6f}; cal "
              f"{m['calibration']['coverage']}; launches {launches}",
              flush=True)
        for name in ("checkpt.npz", "checkpt_best.npz"):
            check(os.path.exists(os.path.join(d1, name)), f"no {name}")
        check(shapes == MOCAP_PREDICTIONS,
              f"model_predictions.npz keys/shapes {shapes}")
        check(set(trace) == MOCAP_TRACE_KEYS, f"trace keys {sorted(trace)}")
        check(train_args["num_inducing"] == 100 and train_args["max_steps"] == 8
              and train_args["plots"] is False, "train_args.json")
        check(trace["loss"]["iters"][0] == 101
              and trace["loss"]["iters"][-1] == EXPERIMENT_ITERS,
              "the trace's loss iterations")
        check(all(math.isfinite(v) for v in trace["loss"]["vals"])
              and math.isfinite(m["test_ll"]) and math.isfinite(m["test_mse"]),
              "a non-finite loss or final metric")
        for name in MAIN_PATH_KERNELS["official"]:
            check(launches[name] == EXPERIMENT_ITERS,
                  f"{name} launched {launches[name]} times in "
                  f"{EXPERIMENT_ITERS} steps of the shooting twin")
        print(f"default: the Trainer's captured step replayed {rec.replays} "
              f"of {EXPERIMENT_ITERS} steps", flush=True)
        check(rec.replays > 0, "the shooting twin's Trainer did not replay a "
              "captured step")
        for name in ("fused_rk4_segment_fwd", "fused_rk4_segment_bwd",
                     "fused_rhs_fwd", "fused_rhs_bwd"):
            check(launches[name] == 0, f"{name} launched on the dopri5 twin")
        out["default"] = dict(steps_per_sec=sps, test_ll=m["test_ll"],
                              test_mse=m["test_mse"],
                              bestval_iter=m["bestval_iter"],
                              test_ll_bestval=m["test_ll_bestval"],
                              calibration=m["calibration"]["coverage"])

        # -- --eval_only on the best-val checkpoint
        _, _, me = shoot(data + ["--save", d1, "--eval_only",
                                 "--eval_checkpoint", "checkpt_best.npz"])
        diff = abs(me["test_ll"] - m["test_ll_bestval"])
        print(f"eval_only: test LL {me['test_ll']:.9f} against the run's "
              f"best-val {m['test_ll_bestval']:.9f} (|diff| {diff:.3e})",
              flush=True)
        check(diff <= 1e-6 * abs(m["test_ll_bestval"]),
              "--eval_only does not reproduce the best-val test LL")
        out["eval_only_abs_diff"] = diff

        # -- resume: 200 in one go against 100 + --resume to 200
        args = ["--val_freq", "100", "--checkpoint_every", "100",
                "--log_freq", "50"]
        d2, d3 = os.path.join(tmp, "one_go"), os.path.join(tmp, "resumed")
        shoot(data + args + ["--num_iter", str(RESUME_ITERS), "--save", d2])
        shoot(data + args + ["--num_iter", str(RESUME_ITERS // 2),
                             "--save", d3])
        shoot(data + args + ["--num_iter", str(RESUME_ITERS), "--save", d3,
                             "--resume"])
        traces = []
        for d in (d2, d3):
            with open(os.path.join(d, "optimization_trace.json")) as f:
                t = json.load(f)["loss"]
            traces.append(dict(zip(t["iters"], t["vals"])))
        tail = range(RESUME_ITERS // 2 + 1, RESUME_ITERS + 1)
        check(all(i in traces[1] for i in tail),
              "the resumed run's trace lacks iterations")
        loss_diff = max(abs(traces[0][i] - traces[1][i]) / abs(traces[0][i])
                        for i in tail)
        p2, p3 = (_checkpoint_params(os.path.join(d, "checkpt.npz"))
                  for d in (d2, d3))
        param_diff = max(float(np.max(np.abs(p2[k] - p3[k])
                                      / (np.abs(p2[k]) + 1e-30)))
                         for k in p2)
        bits = all(np.array_equal(p2[k], p3[k]) for k in p2)
        print(f"resume: iterations {tail.start}-{tail.stop - 1}: largest "
              f"relative loss difference {loss_diff:.3e}; final parameters "
              f"largest relative difference {param_diff:.3e} "
              f"(bit-equal: {bits})", flush=True)
        check(loss_diff <= 1e-6 and param_diff <= 1e-6,
              "the resumed run differs from the run in one go")
        out["resume"] = dict(max_rel_loss_diff=loss_diff,
                             max_rel_param_diff=param_diff, bit_equal=bits)

        # -- --solver rk4
        ck.reset_launch_counts()                 # main path starts here
        shoot(data + ["--solver", "rk4", "--num_iter", str(SHORT_ITERS),
                      "--val_freq", "0", "--save", os.path.join(tmp, "rk4")])
        rk4_launches = dict(ck.LAUNCHES)         # main path ends here
        print(f"rk4: launches {rk4_launches}", flush=True)
        for name in MAIN_PATH_KERNELS["fast"]:
            check(rk4_launches[name] == SHORT_ITERS,
                  f"{name} launched {rk4_launches[name]} times in "
                  f"{SHORT_ITERS} steps of the rk4 twin")
        for name in OFF_PATH_KERNELS["fast"]:
            check(rk4_launches[name] == 0, f"{name} launched on the rk4 twin")

        # -- segment minibatching with constraint annealing
        rec.reset()
        ck.reset_launch_counts()
        shoot(data + ["--segment_minibatch", "16", "--constraint_anneal_iters",
                      str(SHORT_ITERS), "--num_iter", str(SHORT_ITERS),
                      "--val_freq", "0", "--save", os.path.join(tmp, "mb")])
        scale = float(softplus(rec.raw_scale).max())
        print(f"minibatch: attempt rows {sorted(rec.rows)}, attempt launches "
              f"{ck.LAUNCHES['fused_dopri5_attempt_fwd']}; annealed scale at "
              f"iteration {SHORT_ITERS} {scale:.9g}", flush=True)
        check(rec.rows == {5 * 6 * 16}, f"attempt rows {rec.rows}, not 480")
        check(ck.LAUNCHES["fused_dopri5_attempt_fwd"] == SHORT_ITERS,
              "the minibatched step did not launch the attempt kernel")
        check(abs(scale - 1e-3) <= 1e-6 * 1e-3 and rec.all_losses_finite(),
              "the annealed scale at its horizon is not the initial scale")
        out["minibatch"] = dict(rows=sorted(rec.rows), annealed_scale=scale)

        # -- vanilla MoCap and both VDP twins
        for name, run, extra in (
                ("mocap_vanilla", train_mocap_gpode.run, data),
                ("vdp", train_vdp_gpode.run, ["--no_plots"]),
                ("vdp_shooting", train_vdp_gpode_shooting.run, ["--no_plots"])):
            rec.reset()
            _, _, mv = run(extra + ["--num_iter", str(TINY_ITERS),
                                    "--save", os.path.join(tmp, name)])
            sps = rec.steps_per_sec()
            print(f"{name}: {sps:.3f} steps/s over {TINY_ITERS} steps; test "
                  f"LL {mv['test_ll']:.4f} MSE {mv['test_mse']:.4f}",
                  flush=True)
            check(len(rec.losses) == TINY_ITERS and rec.all_losses_finite()
                  and math.isfinite(mv["test_ll"]),
                  f"{name}: non-finite loss or test LL")
            out[name] = dict(steps_per_sec=sps, test_ll=mv["test_ll"],
                             test_mse=mv["test_mse"])
    finally:
        rec.restore()
    return out, launches, rk4_launches


# ---------------------------------------------------------------------------
# phase 7d: the `scale` preset and the solver layer
# ---------------------------------------------------------------------------

SCALE_WARMUP, SCALE_STEPS = 3, 10
SCALE_ROWS = 32 * 6 * 100
MULTISTEP_SOLVERS = ("explicit_adams", "implicit_adams", "adams", "bdf")


def _loss_and_grads(params, loss_fn, noise, ys, ts):
    """One step's loss, terms and parameter gradients (no update)."""
    params.zero_grad(set_to_none=True)
    loss, terms = loss_fn(params, noise, ys, ts)
    loss.backward()
    return float(loss.detach()), terms, {
        n: p.grad.detach().clone() for n, p in params.named_parameters()
        if p.grad is not None}


def _compare_param_grads(got, ref, what, rtol=0.0, atol_scale=1e-3, atol=0.0):
    """Every leaf: |got - ref| <= atol + atol_scale * max|ref| + rtol * |ref|.
    Returns the largest error relative to its leaf's max|ref|."""
    import torch
    check(set(got) == set(ref), f"{what}: different gradient leaves")
    worst = 0.0
    for name, b in ref.items():
        a = got[name]
        err = (a - b).abs()
        scale = float(b.abs().max())
        ok = bool(torch.all(err <= atol + atol_scale * scale + rtol * b.abs()))
        check(ok and bool(torch.all(torch.isfinite(a))),
              f"{what} d{name} disagrees (max_abs_err {float(err.max()):.3e}, "
              f"max|ref| {scale:.3e})")
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
    return worst


def _compare_to_float64(got, plain, ref64, what, ratio=1.25, atol_scale=1e-4):
    """Every leaf of the kernel path's gradients `got` against the float64
    plain path's `ref64`: max|got - ref64| <= ratio * max|plain - ref64| +
    atol_scale * max|ref64|, where `plain` is the float32 plain path's.
    Prints both distances; returns the largest of the kernel path's
    relative to its leaf's max|ref64|."""
    import torch
    check(set(got) == set(ref64) == set(plain),
          f"{what}: different gradient leaves")
    worst = 0.0
    for name, r in ref64.items():
        r = r.float()
        scale = float(r.abs().max())
        e_k = float((got[name] - r).abs().max())
        e_p = float((plain[name] - r).abs().max())
        print(f"  {what} d{name}: kernel path {e_k / scale:.3e}, plain path "
              f"{e_p / scale:.3e} of max|g64| {scale:.3e}")
        check(bool(torch.all(torch.isfinite(got[name])))
              and e_k <= ratio * e_p + atol_scale * scale,
              f"{what} d{name}: the kernel path is farther from float64 "
              f"({e_k:.3e}) than the plain path ({e_p:.3e})")
        worst = max(worst, e_k / max(scale, 1e-30))
    return worst


def scale_kernel_check(dev):
    """The dopri5 attempt kernels at the `scale` step's inputs (N=19200
    segment rows, M=256); see `attempt_kernel_check`."""
    inputs, dt, args, _, _ = main_path_inputs(dev, "scale")
    n, din = inputs[0].shape
    d, m = inputs[-1].shape
    s = inputs[-2].shape[0]
    check((n, din, d, m, s) == (SCALE_ROWS, 5, 5, 256, 256),
          "the scale step's shapes differ from the preset")
    return attempt_kernel_check(inputs, dt, args, "scale")


def attempt_kernel_check(inputs, dt, args, label):
    """The dopri5 attempt kernels at `inputs` (the segment rows x, then the
    draw's seven operands, each requiring grad): forward and cotangents
    against the plain version, the accept RMS (one float32 mean over N*D
    values) against the same mean in float64, device times of kernel and
    plain version, and the bound."""
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck

    x, params = inputs[0], inputs[1:]
    n, din = x.shape
    d, m = params[6].shape
    s = params[5].shape[0]
    print(f"  attempt kernels at the {label} step: N={n} Din={din} D={d} "
          f"M={m} S={s}")
    g = torch.randn(n, d, device=x.device,
                    generator=torch.Generator(x.device).manual_seed(7))
    rtol, atol = args.rtol, args.atol
    x5_k, err_k = ck.fused_dopri5_attempt(x, dt, *params, rtol, atol)
    x5_p, err_p, _ = ck.dopri5_attempt_plain(x, dt, *params, rtol, atol)
    e_fwd = compare_fwd(x5_k, x5_p, f"fused_dopri5_attempt_fwd x5 ({label})")
    rms32 = float(torch.sqrt(torch.mean(torch.square(err_k))))
    rms64 = float(torch.sqrt(torch.mean(torch.square(err_k.double()))))
    rms_p = float(torch.sqrt(torch.mean(torch.square(err_p))))
    print(f"  accept RMS over {err_k.numel()} values: float32 {rms32:.9g}, "
          f"float64 {rms64:.9g} (rel diff {abs(rms32 - rms64) / rms64:.3e}); "
          f"plain version {rms_p:.6g}")
    check(abs(rms32 - rms64) <= 1e-5 * rms64,
          "the float32 accept RMS differs from its float64 value")
    check((rms32 <= 1.0) == (rms_p <= 1.0), "accept decisions differ")
    e_bwd = compare_grads(
        torch.autograd.grad(x5_k, inputs, g),
        torch.autograd.grad(x5_p, inputs, g, retain_graph=True),
        f"fused_dopri5_attempt_bwd ({label})")
    dims = (din, d, m, s)
    ops = ck._kernel_operands(*[p.detach() for p in params])
    xd = x.detach()
    with torch.no_grad():
        xs = ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims)[2]
        ms_f = cuda_ms(lambda: ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims))
        ms_fp = cuda_ms(lambda: ck.dopri5_attempt_plain(
            xd, dt, *[p.detach() for p in params], rtol, atol), iters=10)
    ms_b = cuda_ms(lambda: ck._launch_dp_bwd(xs, g, dt, ops, *dims))
    ms_bp = cuda_ms(lambda: torch.autograd.grad(x5_p, inputs, g,
                                                retain_graph=True), iters=10)
    pf = param_floats(din, d, m, s)
    rows = {
        "fused_dopri5_attempt_fwd": (e_fwd, ms_f, ms_fp, *bound(
            7 * rhs_ops(n, din, d, m, s),
            4 * (n * din + pf + 2 * n * d + 6 * n * din))),
        "fused_dopri5_attempt_bwd": (e_bwd, ms_b, ms_bp, *bound(
            6 * vjp_ops(n, din, d, m, s),
            4 * (6 * n * din + n * d + pf + n * din + pf)))}
    for name, (err, ms, pms, bms, by) in rows.items():
        print(f"  {name} at N={n}, M={m}: {ms:.4f} ms (plain {pms:.4f} ms, "
              f"bound {bms:.5f} ms by {by}); max_abs_err {err:.3e}")
    del x5_p, err_p
    return rows, dict(rms_float32=rms32, rms_float64=rms64, rms_plain=rms_p)


def _peak_mib(dev, fn):
    """fn() from a fresh peak: (its result, peak MiB allocated during it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(dev) / 2**20


def scale_step_check(dev, profile_steps=0):
    """The `scale` train step: step-0 loss against the plain path, the
    plain step's peak memory with and without remat, the timed steps with
    the attempt kernels once per step each (then `profile_steps` profiled
    ones), then a forced reject."""
    import copy
    import dataclasses

    import torch
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.models.shooting import (sample_step_noise,
                                                 stack_segments)
    from gpode_tpu_torch.models.states import sample_shooting_states
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(preset_model_args("scale"),
                                               device=dev)
    check(args.remat and args.num_samples == 32 and args.num_inducing == 256,
          "the scale preset's flags")
    gen = torch.Generator(dev).manual_seed(0)
    loss_fn = shooting_loss_fn(args)
    noise0 = sample_step_noise(params, args.num_features, args.num_samples, gen)
    with torch.no_grad():
        lk = float(loss_fn(params, noise0, ys, ts)[0])
        lp = float(shooting_loss_fn(args, kernels=False)(params, noise0, ys,
                                                         ts)[0])
    print(f"  scale step-0 loss: kernels {lk:.8f}, plain {lp:.8f}")
    check(math.isfinite(lk) and abs(lk - lp) <= 1e-4 * abs(lp),
          "the scale step-0 loss through the kernels differs from the plain path")

    # one plain-path step, with and without remat
    plain_peak = {}
    for remat in (False, True):
        fn = shooting_loss_fn(dataclasses.replace(args, remat=remat),
                              kernels=False)
        (loss, _, _), peak = _peak_mib(dev, lambda: _loss_and_grads(
            params, fn, noise0, ys, ts))
        plain_peak[remat] = peak
        check(math.isfinite(loss), "non-finite plain scale loss")
    params.zero_grad(set_to_none=True)
    print(f"  plain scale step peak: {plain_peak[False]:.1f} MiB without "
          f"remat, {plain_peak[True]:.1f} MiB with")
    check(plain_peak[True] < plain_peak[False],
          "remat does not lower the plain scale step's peak memory")

    # the timed steps (the preset's kernels)
    step = make_train_step(loss_fn, params, default_optimizer(params, 5e-3))
    torch.cuda.synchronize()
    ck.reset_launch_counts()                     # main path starts here
    losses, rejected = [], 0
    for i in range(SCALE_WARMUP + SCALE_STEPS):
        if i == SCALE_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
        terms = step(sample_step_noise(params, args.num_features,
                                       args.num_samples, gen), ys, ts)
        losses.append(float(terms.loss.detach()))
        rejected += terms.natt > 1
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)                 # main path ends here
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    n_steps = SCALE_WARMUP + SCALE_STEPS
    sps = SCALE_STEPS / seconds
    print(f"  scale steps: {sps:.3f} steps/s ({1e3 / sps:.2f} ms/step) over "
          f"{SCALE_STEPS}; peak {peak:.1f} MiB; loss first {losses[0]:.4f} "
          f"last {losses[-1]:.4f}; rejected {rejected}; launches {launches}")
    check(all(math.isfinite(v) for v in losses), "non-finite scale loss")
    check(launches["fused_dopri5_attempt_fwd"] == n_steps
          and launches["fused_dopri5_attempt_bwd"] == n_steps - rejected,
          "the scale step did not launch each attempt kernel once per step")
    for name in ("fused_rhs_fwd", "fused_rhs_bwd", "fused_rk4_segment_fwd",
                 "fused_rk4_segment_bwd"):
        check(launches[name] == 0, f"{name} launched on the scale step")
    if profile_steps:
        profile_train_steps(step, lambda: sample_step_noise(
            params, args.num_features, args.num_samples, gen), ys, ts,
            profile_steps, "scale")

    # a forced reject inside the step: the interval stretched to the
    # shortest span 0.01 * 1.25^k whose plain attempt error RMS exceeds 2
    noise = sample_step_noise(params, args.num_features, args.num_samples, gen)
    with torch.no_grad():
        x = stack_segments(sample_shooting_states(params.states, noise.x0,
                                                  noise.states))
        draw = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                                 noise.rff_phase, noise.inducing)
        ops = (params.gp.z, params.gp.kernel.lengthscales,
               params.gp.kernel.variance, draw.omega, draw.phase,
               gp.kernel_rff_weights(draw.weights), draw.nu)
        for k in range(40):
            span = 0.01 * 1.25 ** k
            dt = torch.full((1,), span, device=dev)
            err = ck.dopri5_attempt_plain(x, dt, *ops, args.rtol, args.atol)[1]
            if float(err.square().mean().sqrt()) > 2.0:
                break
        else:
            raise CheckFailed("no span lifts the scale attempt's RMS above 2")
        del x, draw, ops, err
    ts_r = ts * (span / float(ts[1] - ts[0]))
    runs = {}
    for kernels in (None, False):
        ck.reset_launch_counts()
        (loss, terms, grads), peak_r = _peak_mib(dev, lambda: _loss_and_grads(
            params, shooting_loss_fn(args, kernels=kernels), noise, ys, ts_r))
        runs[kernels] = (loss, terms, grads, peak_r, dict(ck.LAUNCHES))
        print(f"  forced reject (span {span:.5g}), "
              f"{'kernels' if kernels is None else 'plain'}: loss {loss:.8f}, "
              f"attempts {terms.natt}, nfe {terms.nfe}, covered {terms.ncov}, "
              f"peak {peak_r:.1f} MiB")
    params.zero_grad(set_to_none=True)
    (l_k, t_k, g_k, peak_k, n_k), (l_p, t_p, g_p, _, _) = runs[None], runs[False]
    check(t_k.natt > 1 and t_p.natt > 1 and t_k.ncov == 2,
          "the stretched interval's attempt was not rejected, or not covered")
    check(n_k["fused_dopri5_attempt_fwd"] == 1
          and n_k["fused_dopri5_attempt_bwd"] == 0,
          "the rejected step did not start from the attempt kernel")
    check(math.isfinite(l_k) and abs(l_k - l_p) <= 1e-4 * abs(l_p),
          "the rejected step's loss differs from the plain path")
    # the reference: the plain path in float64. Both float32 paths sit
    # ~1e-3 of max|g| from it on this step's cancelling sums, so the kernel
    # path is held to the float32 plain path's own distance
    p64 = copy.deepcopy(params).double()
    noise64 = type(noise)(*(t.double() for t in (
        noise.rff_weights, noise.rff_freq, noise.rff_phase, noise.inducing,
        noise.x0, noise.states)))
    l_64, t_64, g_64 = _loss_and_grads(p64, shooting_loss_fn(args, kernels=False),
                                       noise64, ys.double(), ts_r.double())
    del p64
    print(f"  forced reject, plain float64: loss {l_64:.8f}, attempts "
          f"{t_64.natt}")
    g_err = _compare_to_float64(g_k, g_p, g_64, "forced reject")
    print(f"  forced reject: |loss diff| {abs(l_k - l_p):.3e}; kernel-path "
          f"gradients within {g_err:.3e} of each leaf's float64 max|g|")
    return dict(step0_kernels=lk, step0_plain=lp, steps_per_sec=sps,
                peak_mib=peak, rejected=rejected, loss_first=losses[0],
                loss_last=losses[-1], plain_peak_mib_no_remat=plain_peak[False],
                plain_peak_mib_remat=plain_peak[True],
                reject=dict(span=span, loss_kernels=l_k, loss_plain=l_p,
                            grad_rel_err=g_err, attempts=t_k.natt,
                            peak_mib=peak_k)), launches


def adjoint_check(dev):
    """The official step with `use_adjoint` against the taped step (the
    attempt kernels): `fused_rhs` forward and backward launched, no attempt
    kernel; loss rtol 1e-5, gradients rtol 5e-2, atol 5e-4."""
    import dataclasses

    import torch
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn

    args, params, ys, ts = build_bench_problem(preset_model_args("official"),
                                               device=dev)
    noise = sample_step_noise(params, args.num_features, args.num_samples,
                              torch.Generator(dev).manual_seed(5))
    l_t, _, g_t = _loss_and_grads(params, shooting_loss_fn(args), noise, ys, ts)
    adj = dataclasses.replace(args, use_adjoint=True)
    torch.cuda.synchronize()
    ck.reset_launch_counts()                     # main path starts here
    t0 = time.perf_counter()
    l_a, terms, g_a = _loss_and_grads(params, shooting_loss_fn(adj), noise,
                                      ys, ts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)                 # main path ends here
    params.zero_grad(set_to_none=True)
    print(f"  adjoint: loss {l_a:.8f} against taped {l_t:.8f}; forward nfe "
          f"{terms.nfe}; {seconds:.3f} s for the step; launches {launches}")
    check(launches["fused_rhs_fwd"] > 0 and launches["fused_rhs_bwd"] > 0,
          "the adjoint step did not launch fused_rhs in both directions")
    for name in ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd",
                 "fused_rk4_segment_fwd", "fused_rk4_segment_bwd"):
        check(launches[name] == 0, f"{name} launched on the adjoint step")
    check(abs(l_a - l_t) <= 1e-5 * abs(l_t), "the adjoint loss differs")
    g_err = _compare_param_grads(g_a, g_t, "adjoint vs taped", rtol=5e-2,
                                 atol_scale=0.0, atol=5e-4)
    return dict(loss=l_a, loss_taped=l_t, nfe=terms.nfe, seconds=seconds,
                grad_rel_err=g_err), launches


def multistep_check(dev):
    """A MoCap-09 shooting step (the official model) with each multistep
    solver, on the card against the CPU (loss rtol 1e-4): `fused_rhs` in
    both directions for the explicit and implicit Adams solvers and the
    VCABM, no kernel for BDF; then explicit Adams with `remat`, whose
    backward launches every forward a second time."""
    import dataclasses

    import torch
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn

    base, params, ys, ts = build_bench_problem(preset_model_args("official"),
                                               device=dev)
    _, params_c, ys_c, ts_c = build_bench_problem(base, device="cpu")
    noise_c = sample_step_noise(params_c, base.num_features, base.num_samples,
                                torch.Generator().manual_seed(9))
    noise = type(noise_c)(*(t.to(dev) for t in (
        noise_c.rff_weights, noise_c.rff_freq, noise_c.rff_phase,
        noise_c.inducing, noise_c.x0, noise_c.states)))
    out, per_step = {}, {}
    for solver in MULTISTEP_SOLVERS + ("explicit_adams_remat",):
        remat = solver.endswith("_remat")
        args = dataclasses.replace(base, solver=solver.replace("_remat", ""),
                                   remat=remat)
        torch.cuda.synchronize()
        ck.reset_launch_counts()                 # main path starts here
        t0 = time.perf_counter()
        loss, terms, _ = _loss_and_grads(params, shooting_loss_fn(args), noise,
                                         ys, ts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)             # main path ends here
        with torch.no_grad():
            loss_c = float(shooting_loss_fn(args)(params_c, noise_c, ys_c,
                                                  ts_c)[0])
        print(f"  {solver}: card {loss:.8f}, CPU {loss_c:.8f}; nfe {terms.nfe}; "
              f"{seconds:.3f} s; fused_rhs fwd {launches['fused_rhs_fwd']} "
              f"bwd {launches['fused_rhs_bwd']}")
        check(math.isfinite(loss) and abs(loss - loss_c) <= 1e-4 * abs(loss_c),
              f"{solver}: the card's loss differs from the CPU's")
        for name in ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd",
                     "fused_rk4_segment_fwd", "fused_rk4_segment_bwd"):
            check(launches[name] == 0, f"{name} launched by {solver}")
        if solver == "bdf":
            check(launches["fused_rhs_fwd"] == launches["fused_rhs_bwd"] == 0,
                  "BDF launched fused_rhs")
        else:
            check(launches["fused_rhs_fwd"] > 0 and launches["fused_rhs_bwd"] > 0,
                  f"{solver} did not launch fused_rhs in both directions")
        out[solver] = dict(loss=loss, loss_cpu=loss_c, nfe=terms.nfe,
                           seconds=seconds)
        per_step[solver] = {k: launches[k] for k in ("fused_rhs_fwd",
                                                     "fused_rhs_bwd")}
    params.zero_grad(set_to_none=True)
    plain, remat = per_step["explicit_adams"], per_step["explicit_adams_remat"]
    check(remat["fused_rhs_fwd"] == 2 * plain["fused_rhs_fwd"]
          and remat["fused_rhs_bwd"] == plain["fused_rhs_bwd"],
          "remat does not launch each forward once more in the backward")
    check(out["explicit_adams_remat"]["loss"] == out["explicit_adams"]["loss"],
          "remat changed the loss")
    return out, per_step


def solver_cli_check(tmp):
    """The VDP twin for TINY_ITERS steps with `--solver adams` and
    `--solver bdf`: finite losses and test LL."""
    from gpode_tpu_torch.scripts import train_vdp_gpode
    out, rec = {}, _Recorder()
    try:
        for solver in ("adams", "bdf"):
            rec.reset()
            _, _, mv = train_vdp_gpode.run([
                "--no_plots", "--solver", solver, "--num_iter",
                str(TINY_ITERS), "--save", os.path.join(tmp, f"vdp_{solver}")])
            sps = rec.steps_per_sec()
            print(f"  vdp --solver {solver}: {sps:.3f} steps/s over "
                  f"{TINY_ITERS} steps; test LL {mv['test_ll']:.4f} MSE "
                  f"{mv['test_mse']:.4f}", flush=True)
            check(len(rec.losses) == TINY_ITERS and rec.all_losses_finite()
                  and math.isfinite(mv["test_ll"]),
                  f"vdp --solver {solver}: non-finite loss or test LL")
            out[solver] = dict(steps_per_sec=sps, test_ll=mv["test_ll"],
                               test_mse=mv["test_mse"])
    finally:
        rec.restore()
    return out


def scale_solvers_phase(dev, tmp, profile_steps=0):
    """Phase 7d. Returns (results, the attempt kernels' rows at the scale
    shape, the scale step's launches, the adjoint step's launches,
    `fused_rhs` launches per multistep step)."""
    phase("scale and solvers")
    t0 = time.perf_counter()
    rows, rms = scale_kernel_check(dev)
    scale, scale_launches = scale_step_check(dev, profile_steps)
    adjoint, adjoint_launches = adjoint_check(dev)
    multistep, per_step = multistep_check(dev)
    cli = solver_cli_check(tmp)
    seconds = time.perf_counter() - t0
    print(f"  phase 7d: {seconds:.1f} s", flush=True)
    return (dict(accept_rms=rms, scale=scale, adjoint=adjoint,
                 multistep=multistep, cli=cli, seconds=seconds),
            rows, scale_launches, adjoint_launches, per_step)


# ---------------------------------------------------------------------------
# phase 7e: the plots, FitzHugh-Nagumo and the neural ODE
# ---------------------------------------------------------------------------

# the FHN shooting twin's defaults: 10 draws x 1 sequence x 30 states
FHN_ROWS, FHN_INDUCING = 10 * 1 * 30, 16
# draws of the FHN interpolation shooting run: 6 x 50 = 300 rows, where the
# generic dopri5 solve takes `fused_rhs` at every stage
FHN_INTERP_DRAWS = 6
# the png families of tests/test_plots.py
VDP_PLOT_FAMILIES = ("model_before_initialization.png",
                     "model_after_initialization.png", "plt_longitudinal.png",
                     "plt_longitudinal_0.png", "plt_vectorfield.png",
                     "plt_inducing_posterior.png", "plt_long_pred.png",
                     "plt_longnoise_pred.png", "plt_longnoise_pred_single.png")
MOCAP_PLOT_FAMILIES = ("plt_latents_after_optimization_train.png",
                       "plt_data_after_optimization_train.png",
                       "inducing_posterior_train.png", "plt_latents_3d.png")


def _cpu(module):
    import copy
    return copy.deepcopy(module).to("cpu")


def _noise_cpu(noise):
    return type(noise)(*(None if t is None else t.cpu() for t in (
        noise.rff_weights, noise.rff_freq, noise.rff_phase, noise.inducing,
        noise.x0)))


def _compare_arrays(got, ref, what):
    """Host arrays from the card against the CPU's: rtol 1e-4, atol
    1e-4 * max|ref|."""
    import torch
    return compare_fwd(torch.as_tensor(got), torch.as_tensor(ref), what,
                       atol_scale=1e-4)


def native_check():
    """The native host library's branch, its build seconds, and whether g++
    and matplotlib are on this machine (the native branch is required where
    g++ is)."""
    import shutil
    from gpode_tpu_torch.utils import native
    info = native.info()
    gxx = shutil.which("g++")
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    print(f"  native host library: branch {info['branch']}; "
          f"{'reused' if info.get('reused') else 'built'} in "
          f"{info.get('seconds', float('nan')):.2f} s; reason "
          f"{info.get('reason')}; g++ {gxx}; matplotlib imports: {has_mpl}",
          flush=True)
    if gxx is not None:
        check(info["branch"] == "native",
              "g++ is here but the port took the scipy branch")
    return dict(native_branch=info["branch"],
                native_build_seconds=info.get("seconds"), gxx=gxx,
                matplotlib=has_mpl), has_mpl


def plot_arrays_check(dev, vdp_params, vdp_data, mocap_params):
    """The plots' data parts on the card against the CPU on the same noise:
    the VDP field draws on both grids and their mean, the un-whitened
    inducing posterior of the VDP and the MoCap GP, and the VDP grid
    conditional (one `rbf_gram` launch per call). Returns (errors, the
    launches of the conditional's run)."""
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.plots import plots_2d

    gp_c = _cpu(vdp_params.gp)
    gen = torch.Generator(dev).manual_seed(17)
    noise = plots_2d.field_noise(vdp_params.gp, 256, gen)
    coarse = plots_2d.field_noise(vdp_params.gp, 256, gen)
    a = plots_2d.vectorfield_arrays(vdp_params.gp, vdp_data, noise, coarse)
    b = plots_2d.vectorfield_arrays(gp_c, vdp_data, _noise_cpu(noise),
                                    _noise_cpu(coarse))
    err = {k: _compare_arrays(a[k], b[k], f"vdp field {k}")
           for k in ("field", "mean", "qfield")}
    for name, gp_params in (("vdp", vdp_params.gp), ("mocap", mocap_params.gp)):
        u, z = plots_2d.unwhiten_inducing(gp_params)
        u_c, _ = plots_2d.unwhiten_inducing(_cpu(gp_params))
        err[f"{name}_unwhitened"] = _compare_arrays(
            u, u_c, f"{name} un-whitened inducing posterior (M={z.shape[0]})")
    ck.reset_launch_counts()                     # main path starts here
    _, _, mean, var = plots_2d.grid_conditional(vdp_params.gp, vdp_data)
    launches = dict(ck.LAUNCHES)                 # main path ends here
    check(launches["rbf_gram"] == 1,
          f"the grid conditional launched rbf_gram {launches['rbf_gram']} times")
    _, _, mean_c, var_c = plots_2d.grid_conditional(gp_c, vdp_data)
    err["grid_mean"] = _compare_arrays(mean, mean_c, "vdp grid conditional mean")
    err["grid_var"] = _compare_arrays(var, var_c, "vdp grid conditional var")
    return err, launches


def plot_twins_check(tmp, has_mpl):
    """The VDP twin (vanilla and `--shooting`) and the MoCap shooting twin
    at their default flags, plots on where matplotlib imports, for
    TINY_ITERS steps: finite losses, `rbf_gram` twice per VDP run (the
    before/after-initialization snapshots) and never on MoCap, the png
    families of tests/test_plots.py. Returns (results, rbf_gram launches
    per run)."""
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.scripts import (train_mocap_gpode_shooting,
                                         train_vdp_gpode,
                                         train_vdp_gpode_shooting)
    if not has_mpl:
        print("  matplotlib does not import here: the twins run with "
              "--no_plots and no figure is rendered", flush=True)
    mocap = ["--data_path", os.path.join(ROOT, "data", "mocap")]
    out, per_run, rec = {}, {}, _Recorder()
    try:
        for name, run, extra, families, grams in (
                ("vdp", train_vdp_gpode.run, [], VDP_PLOT_FAMILIES, 2),
                ("vdp_shooting", train_vdp_gpode_shooting.run, [],
                 VDP_PLOT_FAMILIES + ("plt_shooting_states.png",), 2),
                ("mocap_shooting", train_mocap_gpode_shooting.run, mocap,
                 MOCAP_PLOT_FAMILIES, 0)):
            d = os.path.join(tmp, f"plots_{name}")
            rec.reset()
            ck.reset_launch_counts()             # main path starts here
            t0 = time.perf_counter()
            _, _, m = run(extra + ["--num_iter", str(TINY_ITERS), "--save", d]
                          + ([] if has_mpl else ["--no_plots"]))
            seconds = time.perf_counter() - t0
            launches = dict(ck.LAUNCHES)         # main path ends here
            pngs = sorted(f for f in os.listdir(d) if f.endswith(".png"))
            print(f"  {name} twin: {seconds:.1f} s; test LL "
                  f"{m['test_ll']:.4f}; rbf_gram launches "
                  f"{launches['rbf_gram']}; {len(pngs)} png files", flush=True)
            check(len(rec.losses) == TINY_ITERS and rec.all_losses_finite()
                  and math.isfinite(m["test_ll"]),
                  f"{name} twin: non-finite loss or test LL")
            if has_mpl:
                missing = [f for f in families if f not in pngs]
                check(not missing, f"{name} twin: missing {missing}")
                check(launches["rbf_gram"] == grams,
                      f"{name} twin launched rbf_gram {launches['rbf_gram']} "
                      f"times, not {grams}")
            out[name] = dict(seconds=seconds, test_ll=m["test_ll"],
                             pngs=len(pngs))
            per_run[name] = launches["rbf_gram"]
    finally:
        rec.restore()
    return out, per_run


def fhn_shooting_check(dev, tmp):
    """The FHN shooting twin at its defaults (10 draws x 30 states = 300
    rows, Din=D=2, M=16, S=256): the attempt kernels at the step's inputs
    against their plain versions, the step-0 loss against the plain path
    (rtol 1e-4), then TINY_ITERS steps of the twin with the attempt forward
    once per step and its backward once per accepted step (a rejected
    whole-span attempt falls back to the plain solver). Returns (results,
    the kernel rows, the twin's launches)."""
    import numpy as np
    import torch
    from gpode_tpu_torch.data.fhn import FHN
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.models.gpode import sample_predict_noise
    from gpode_tpu_torch.models.init import (
        initialize_inducing, initialize_shooting_states_with_data)
    from gpode_tpu_torch.models.shooting import sample_step_noise, stack_segments
    from gpode_tpu_torch.models.states import sample_shooting_states
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.scripts import train_fhn_gpode
    from gpode_tpu_torch.scripts._cli import to_experiment_args
    from gpode_tpu_torch.train import experiments as ex
    from gpode_tpu_torch.train.builders import build_shooting, shooting_loss_fn

    args = to_experiment_args(train_fhn_gpode.parser().parse_args([]))
    margs = ex._shooting_margs(args.model_args(), True)
    data = FHN(s_train=args.data_obs_s, t_train=args.data_obs_t,
               noise_var=args.data_obs_noise_var, x0=np.array([[-1.0, -1.0]]))
    params = build_shooting(ex.generator("cpu", args.seed, ex._BUILD), margs,
                            data.trn.ys, device=dev)
    initialize_inducing(params.gp, data.trn.ys, float(data.trn.ts.max()),
                        rng=np.random.RandomState(args.seed))
    ys = torch.as_tensor(data.trn.ys, device=dev)
    ts = torch.as_tensor(data.trn.ts, device=dev)
    x0_noise = sample_predict_noise(ex.view(params), margs.num_features, 50,
                                    torch.Generator(dev).manual_seed(3),
                                    sample_x0=False)
    initialize_shooting_states_with_data(params, x0_noise, data.trn.ys,
                                         data.trn.ts, ex._eval_cfg(
                                             margs.solver_config()))
    noise = sample_step_noise(params, margs.num_features, margs.num_samples,
                              torch.Generator(dev).manual_seed(5))
    with torch.no_grad():
        x = stack_segments(sample_shooting_states(params.states, noise.x0,
                                                  noise.states))
        draw = gp.draw_posterior(params.gp, noise.rff_weights, noise.rff_freq,
                                 noise.rff_phase, noise.inducing)
        ops = (x, params.gp.z, params.gp.kernel.lengthscales,
               params.gp.kernel.variance, draw.omega, draw.phase,
               gp.kernel_rff_weights(draw.weights), draw.nu)
    inputs = [t.detach().clone().contiguous().requires_grad_() for t in ops]
    check((x.shape[0], params.gp.num_inducing) == (FHN_ROWS, FHN_INDUCING)
          and margs.first_step is not None,
          "the FHN shooting defaults are not 300 rows at M=16 with a "
          "whole-span first step")
    rows, rms = attempt_kernel_check(inputs, (ts[1] - ts[0]).reshape(1),
                                     margs, "FHN shooting default")
    with torch.no_grad():
        lk = float(shooting_loss_fn(margs)(params, noise, ys, ts)[0])
        lp = float(shooting_loss_fn(margs, kernels=False)(params, noise, ys,
                                                          ts)[0])
    print(f"  FHN step-0 loss: kernels {lk:.8f}, plain {lp:.8f}")
    check(math.isfinite(lk) and abs(lk - lp) <= 1e-4 * abs(lp),
          "the FHN step-0 loss through the kernels differs from the plain path")

    rec = _Recorder()
    try:
        ck.reset_launch_counts()                 # main path starts here
        t0 = time.perf_counter()
        _, _, m = train_fhn_gpode.run([
            "--shooting", "--no_plots", "--num_iter", str(TINY_ITERS),
            "--save", os.path.join(tmp, "fhn_shooting")])
        seconds = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)             # main path ends here
        rejected = sum(natt > 1 for natt in rec.natts)
        print(f"  FHN shooting twin: {seconds:.1f} s; attempt rows "
              f"{sorted(rec.rows)}; rejected whole-span attempts {rejected} "
              f"of {TINY_ITERS}; test LL {m['test_ll']:.4f} MSE "
              f"{m['test_mse']:.4f}; launches {launches}", flush=True)
        check(len(rec.losses) == TINY_ITERS and rec.all_losses_finite()
              and math.isfinite(m["test_ll"]),
              "the FHN shooting twin: non-finite loss or test LL")
        check(rec.rows == {FHN_ROWS}, f"FHN attempt rows {rec.rows}")
    finally:
        rec.restore()
    # a captured step's reject replays graph A (one attempt forward) before
    # running the step eagerly
    check(launches["fused_dopri5_attempt_fwd"] == TINY_ITERS + rec.rejects
          and launches["fused_dopri5_attempt_bwd"] == TINY_ITERS - rejected,
          f"the attempt kernels launched {launches['fused_dopri5_attempt_fwd']}"
          f" / {launches['fused_dopri5_attempt_bwd']} times in {TINY_ITERS} "
          f"FHN steps with {rejected} rejected")
    return (dict(step0_kernels=lk, step0_plain=lp, accept_rms=rms,
                 twin_seconds=seconds, rejected=rejected,
                 test_ll=m["test_ll"], test_mse=m["test_mse"]), rows, launches)


def fhn_interpolation_check(tmp):
    """The FHN interpolation driver at the twin's defaults for TINY_ITERS
    steps, vanilla and shooting at FHN_INTERP_DRAWS draws (`fused_rhs` in
    both directions, no segment kernel): finite interpolation LL and MSE.
    Returns (results, the shooting run's launches)."""
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.scripts import train_fhn_interpolation
    from gpode_tpu_torch.scripts._cli import to_experiment_args
    from gpode_tpu_torch.train.experiments import run_fhn_interpolation

    out, rec = {}, _Recorder()
    try:
        for shooting in (False, True):
            name = "shooting" if shooting else "vanilla"
            args = to_experiment_args(train_fhn_interpolation.parser()
                                      .parse_args([]))
            args.data_path = os.path.join(ROOT, "data", "fhn")
            args.num_iter = TINY_ITERS
            args.save = os.path.join(tmp, f"fhn_interp_{name}")
            if shooting:
                args.num_samples = FHN_INTERP_DRAWS
            rec.reset()
            ck.reset_launch_counts()             # main path starts here
            t0 = time.perf_counter()
            _, _, m = run_fhn_interpolation(args, shooting_variant=shooting)
            seconds = time.perf_counter() - t0
            launches = dict(ck.LAUNCHES)         # main path ends here
            print(f"  FHN interpolation ({name}): {seconds:.1f} s; interp LL "
                  f"{m['interp_ll']:.4f} MSE {m['interp_mse']:.4f}; launches "
                  f"{launches}", flush=True)
            check(len(rec.losses) == TINY_ITERS and rec.all_losses_finite()
                  and math.isfinite(m["interp_ll"])
                  and math.isfinite(m["interp_mse"]),
                  f"FHN interpolation ({name}): non-finite loss or metric")
            out[name] = dict(seconds=seconds, **m)
        for kernel in ("fused_rhs_fwd", "fused_rhs_bwd"):
            check(launches[kernel] > 0,
                  f"{kernel} not launched on the FHN interpolation shooting run")
        for kernel in ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd",
                       "fused_rk4_segment_fwd", "fused_rk4_segment_bwd"):
            check(launches[kernel] == 0,
                  f"{kernel} launched on the FHN interpolation shooting run")
    finally:
        rec.restore()
    return out, launches


def neural_ode_check(dev, tmp, has_mpl):
    """The neural-ODE twins on VDP and MoCap: the step-0 loss of the
    twin's weights on the card against the CPU (rtol 1e-4), then
    TINY_ITERS steps (plots on where matplotlib imports): finite MSE."""
    import numpy as np
    import torch
    from gpode_tpu_torch.models import neural_ode
    from gpode_tpu_torch.scripts import (train_mocap_neuralode,
                                         train_vdp_neuralode)

    mocap = ["--data_path", os.path.join(ROOT, "data", "mocap")]
    out = {}
    for name, twin, extra in (("vdp", train_vdp_neuralode, []),
                              ("mocap", train_mocap_neuralode, mocap)):
        ns = twin.parser().parse_args(extra)
        if name == "vdp":
            data, cfg = twin.problem(ns)
            ys, ts, d = data.trn.ys, data.trn.ts, 2
        else:
            data_pca, _, _, cfg = twin.problem(ns, "cpu")
            ys, ts, d = data_pca.trn.ys, data_pca.trn.ts, ns.num_latents
        losses = []
        for device in (dev, "cpu"):
            params = neural_ode.init_neural_ode(
                torch.Generator().manual_seed(ns.seed), d, ns.num_hidden,
                device=device)
            with torch.no_grad():
                losses.append(float(neural_ode.mse_loss(
                    params, None, torch.as_tensor(np.asarray(ys), device=device),
                    torch.as_tensor(np.asarray(ts), device=device), cfg)[0]))
        print(f"  neural ODE ({name}) step-0 loss: card {losses[0]:.8f}, "
              f"CPU {losses[1]:.8f}")
        check(math.isfinite(losses[0])
              and abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]),
              f"the neural ODE ({name}) step-0 loss differs from the CPU's")
        t0 = time.perf_counter()
        _, trainer, m = twin.run(extra + [
            "--num_iter", str(TINY_ITERS), "--save",
            os.path.join(tmp, f"node_{name}")]
            + ([] if has_mpl else ["--no_plots"]))
        seconds = time.perf_counter() - t0
        print(f"  neural ODE ({name}) twin: {seconds:.1f} s; train MSE "
              f"{m['train_mse']:.4f} test MSE {m['test_mse']:.4f}", flush=True)
        check(math.isfinite(m["train_mse"]) and math.isfinite(m["test_mse"])
              and all(math.isfinite(v) for v in trainer.loss_meter.vals),
              f"the neural ODE ({name}) twin: non-finite loss or MSE")
        out[name] = dict(step0_card=losses[0], step0_cpu=losses[1],
                         seconds=seconds, **m)
    return out


def plots_fhn_node_phase(dev, tmp, vdp_params, vdp_data, mocap_params):
    """Phase 7e (run after phase 9: it reads phase 8's VDP GP). Returns
    (results, the FHN attempt rows, launches by path)."""
    phase("plots, FHN and the neural ODE")
    t0 = time.perf_counter()
    out, has_mpl = native_check()
    out["plot_arrays"], grid_launches = plot_arrays_check(
        dev, vdp_params, vdp_data, mocap_params)
    out["plot_twins"], gram_per_run = plot_twins_check(tmp, has_mpl)
    out["fhn_shooting"], fhn_rows, fhn_launches = fhn_shooting_check(dev, tmp)
    out["fhn_interpolation"], interp_launches = fhn_interpolation_check(tmp)
    out["neural_ode"] = neural_ode_check(dev, tmp, has_mpl)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 7e: {out['seconds']:.1f} s", flush=True)
    return out, fhn_rows, dict(grid=grid_launches, gram_per_run=gram_per_run,
                               fhn=fhn_launches, interp=interp_launches)


# ---------------------------------------------------------------------------
# phase 7f: multi-device training
# ---------------------------------------------------------------------------

# the MoCap driver's loss meter starts after iteration 100: 120 steps give
# 20 metered losses
MESH_ITERS = 120
MESH_CHECK_TIMEOUT_S = 420
PROFILE_TRACE_STEPS = 5


def mesh_world1_check(tmp):
    """(a) A world of 1 on NCCL, in this process: the MoCap shooting twin
    at its defaults for MESH_ITERS steps without a mesh and with `--mesh
    dp=1` under both `--parallel` styles (losses and final parameters
    rtol 1e-6 against the run without), then `scripts.bench --preset
    official --mesh dp=1`."""
    import contextlib
    import io

    import numpy as np
    import torch.distributed as dist
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.scripts import bench
    from gpode_tpu_torch.scripts import train_mocap_gpode_shooting as twin
    from gpode_tpu_torch.utils.checkpoint import load_checkpoint

    runs = {}
    for tag, extra in (("no_mesh", []),
                       ("gspmd", ["--mesh", "dp=1", "--parallel", "gspmd"]),
                       ("shard_map", ["--mesh", "dp=1",
                                      "--parallel", "shard_map"])):
        save = os.path.join(tmp, f"mesh_{tag}")
        ck.reset_launch_counts()
        _, trainer, metrics = twin.run(["--no_plots", "--num_iter",
                                        str(MESH_ITERS), "--save", save,
                                        "--data_path", os.path.join(
                                            ROOT, "data", "mocap")]
                                       + extra)
        launches = dict(ck.LAUNCHES)
        params = load_checkpoint(os.path.join(save, "checkpt.npz"))["params"]
        runs[tag] = dict(losses=list(trainer.loss_meter.vals),
                         test_ll=metrics["test_ll"], params=params,
                         launches_per_step={
                             k: launches[k] / MESH_ITERS
                             for k in MAIN_PATH_KERNELS["official"]})
    check(dist.is_initialized() and dist.get_world_size() == 1
          and dist.get_backend() == "nccl",
          "--mesh dp=1 did not start a world of 1 on NCCL")
    ref = runs["no_mesh"]
    check(len(ref["losses"]) == MESH_ITERS - 100
          and all(math.isfinite(v) for v in ref["losses"]),
          "the twin's metered losses are missing or not finite")
    out = {"backend": dist.get_backend(), "steps": MESH_ITERS}
    for tag in ("gspmd", "shard_map"):
        got = runs[tag]
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], ref["losses"]))
        param_err = max(float(np.max(np.abs(got["params"][k] - v))
                              / max(float(np.max(np.abs(v))), 1e-30))
                        for k, v in ref["params"].items())
        bit_equal = (got["losses"] == ref["losses"] and all(
            np.array_equal(got["params"][k], v)
            for k, v in ref["params"].items()))
        print(f"  world of 1 ({tag}): losses of steps 101-{MESH_ITERS} max "
              f"rel diff {loss_err:.3e}, final params {param_err:.3e}, "
              f"bit-equal {bit_equal}; test LL {got['test_ll']:.6f} (no "
              f"mesh {ref['test_ll']:.6f}); attempt launches per step "
              f"{got['launches_per_step']}")
        check(loss_err <= 1e-6 and param_err <= 1e-6
              and abs(got["test_ll"] - ref["test_ll"])
              <= 1e-6 * abs(ref["test_ll"]),
              f"--mesh dp=1 ({tag}) differs from the run without a mesh")
        check(all(v > 0 for v in got["launches_per_step"].values()),
              f"--mesh dp=1 ({tag}) never launched the attempt kernels")
        out[tag] = dict(loss_max_rel_diff=loss_err,
                        param_max_rel_diff=param_err, bit_equal=bit_equal,
                        test_ll=got["test_ll"],
                        launches_per_step=got["launches_per_step"])
    out["no_mesh_test_ll"] = ref["test_ll"]

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--preset", "official", "--mesh", "dp=1",
                         "--iters", "20"])
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"  bench --mesh dp=1: {line}")
    row = json.loads(line)
    check(rc == 0 and row["mesh"] == {"dp": 1} and row["steps_per_sec"] > 0
          and math.isfinite(row["loss"]), "bench --mesh dp=1 failed")
    out["bench"] = row
    dist.destroy_process_group()
    return out


def mesh_two_ranks_check(tmp):
    """(b) Two ranks over gloo on the one card (NCCL refuses two ranks on
    one GPU), `dp=2`, the official and `fast` bench problems at full width:
    `gpode_tpu_torch.scripts.mesh_check` in two processes (its docstring
    holds the checks and limits). Returns rank 0's verdict."""
    from gpode_tpu_torch.scripts import mesh_check
    codes, outs = mesh_check.run_local(2, "official,fast",
                                       os.path.join(tmp, "mesh_check"),
                                       MESH_CHECK_TIMEOUT_S)
    for rank, (code, text) in enumerate(zip(codes, outs)):
        if code != 0:
            print(text[-4000:])
        check(code == 0, f"mesh_check rank {rank} exited {code}")
    verdict = json.loads(outs[0].strip().splitlines()[-1])
    check(not verdict["failures"], f"mesh_check: {verdict['failures']}")
    print(f"  two ranks on one card: backend {verdict['backend']}; "
          f"{verdict['seconds']:.1f} s")
    for preset, res in verdict["presets"].items():
        print(f"  {preset} ({res['rows_per_rank']} segment rows per rank):")
        for style in ("gspmd", "shard_map"):
            r = res[style]
            e = r["errors"][0]
            print(f"    {style}: loss {r['loss']:.6f} vs single process "
                  f"{r['ref_loss']:.6f} (rel {e['loss_rel_err']:.2e}); "
                  f"grads vs float32 single {e['grad_err_vs_f32_over_max']:.2e}"
                  f", vs float64 {e['grad_err_vs_f64_over_max']:.2e} (single "
                  f"float32 {e['f32_ref_err_vs_f64_over_max']:.2e}) of max|g|;"
                  f" attempts per rank {r['natt']}; launches per rank "
                  f"{r['launches']}")
            t = res[f"{style}_train"]
            print(f"    {style}: {len(t['losses'])} steps, params bit-equal "
                  f"on both ranks {t['params_bit_equal']}, steps/s per rank "
                  f"{[round(v, 2) for v in t['steps_per_sec']]}")
        print(f"    collective audit per rank: {res['audit']}")
    return verdict


def mesh_profile_check(tmp):
    """(c) `capture_trace` over PROFILE_TRACE_STEPS official steps, then
    `analyze_trace` on its output: the grouped device ms per step, beside
    the device self time of the same profile's `key_averages` (the
    `--profile-steps` figure)."""
    from gpode_tpu_torch.scripts import analyze_trace, capture_trace
    prof = capture_trace.capture(os.path.join(tmp, "trace"),
                                 steps=PROFILE_TRACE_STEPS, preset="official")
    summary = analyze_trace.report(prof.trace_path, top=10,
                                   steps=PROFILE_TRACE_STEPS)
    kernels = _device_rows(prof.key_averages())
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / PROFILE_TRACE_STEPS
    per_step = {g: v / 1e3 / PROFILE_TRACE_STEPS
                for g, v in summary["groups"].items()}
    total = summary["total_us"] / 1e3 / PROFILE_TRACE_STEPS
    print(f"  analyze_trace: {total:.4f} device ms per step; key_averages "
          f"device self time {busy_ms:.4f} ms per step")
    check(per_step.get("port kernels: fused_dopri5.cu", 0.0) > 0,
          "the traced official steps show no attempt kernel")
    return {"device_ms_per_step": total, "groups_ms_per_step": per_step,
            "key_averages_ms_per_step": busy_ms,
            "steps": PROFILE_TRACE_STEPS}


def mesh_phase(tmp):
    """Phase 7f: multi-device training (a)-(c). Returns (results, the
    world-of-1 and two-rank launches of the segment kernels)."""
    phase("mesh")
    t0 = time.perf_counter()
    out = {"world1": mesh_world1_check(tmp)}
    out["two_ranks"] = mesh_two_ranks_check(tmp)
    out["profile"] = mesh_profile_check(tmp)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 7f: {out['seconds']:.1f} s", flush=True)
    launches = {}
    for preset, kernels in (("official", MAIN_PATH_KERNELS["official"]),
                            ("fast", MAIN_PATH_KERNELS["fast"])):
        res = out["two_ranks"]["presets"][preset]
        for name in kernels:
            launches[name] = {
                "dp2_gloo_per_rank_per_step": {
                    style: [lau.get(name, 0) for lau in res[style]["launches"]]
                    for style in ("gspmd", "shard_map")}}
            if preset == "official":
                launches[name]["world1_nccl_per_step"] = {
                    style: out["world1"][style]["launches_per_step"][name]
                    for style in ("gspmd", "shard_map")}
    return out, launches


def accept_decision_check(x, params, rtol, atol):
    """The attempt kernel and the plain path near the accept threshold: at
    every span 0.01 * 1.05^k whose float64 plain error RMS lies in [0.5, 2]
    and not within 1e-3 of 1, the kernel's RMS and the float32 plain
    version's must fall on the same side of 1 (the step's accept test).
    Prints the three RMS values per span; returns them."""
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck

    def rms(err):
        return float(err.double().square().mean().sqrt())

    x64, p64 = x.double(), [p.double() for p in params]
    held = []
    for k in range(200):
        span = 0.01 * 1.05 ** k
        dt = torch.full((1,), span, device=x.device)
        with torch.no_grad():
            r64 = rms(ck.dopri5_attempt_plain(x64, dt.double(), *p64, rtol, atol)[1])
            if r64 > 2.0:
                break
            if r64 < 0.5 or abs(r64 - 1.0) < 1e-3:
                continue
            r_k = rms(ck.fused_dopri5_attempt(x, dt, *params, rtol, atol)[1])
            r_p = rms(ck.dopri5_attempt_plain(x, dt, *params, rtol, atol)[1])
        print(f"  accept test at dt={span:.5g}: error RMS kernel {r_k:.6f}, plain "
              f"{r_p:.6f}, float64 plain {r64:.6f} -> "
              f"{'accept' if r_k <= 1.0 else 'reject'} / "
              f"{'accept' if r_p <= 1.0 else 'reject'}")
        check((r_k <= 1.0) == (r_p <= 1.0),
              f"the attempt kernel and the plain path decide differently at "
              f"dt={span:.5g} (RMS {r_k:.6f} against {r_p:.6f}; float64 {r64:.6f})")
        held.append(dict(dt=span, rms_kernel=r_k, rms_plain=r_p, rms_float64=r64))
    check(any(h["rms_float64"] < 1.0 for h in held)
          and any(h["rms_float64"] > 1.0 for h in held),
          "no spans on both sides of the accept threshold")
    return held


def reject_phase(dev):
    """A forced reject on the card: `flow_forward` of the bench draw over the
    shortest span (0.01 * 1.25^k) whose whole-span attempt the plain version
    rejects, through the kernels and through the plain path. Both reject,
    take the same number of attempts, and end at the same state (rtol 1e-4,
    atol 1e-5 * max|ref|). Then `accept_decision_check` on the same draw.
    Returns the end state's max abs error and the accept checks."""
    phase("reject fallback")
    import torch
    from gpode_tpu_torch.models.flow import flow_forward
    from gpode_tpu_torch.ops import cuda_kernels as ck

    inputs, _, args, gp_params, draw = main_path_inputs(dev)
    x = inputs[0].detach()
    params = [p.detach() for p in inputs[1:]]
    for k in range(40):
        span = 0.01 * 1.25 ** k
        dt = torch.full((1,), span, device=dev)
        with torch.no_grad():
            _, err_p, _ = ck.dopri5_attempt_plain(x, dt, *params, args.rtol,
                                                  args.atol)
        if float(err_p.square().mean().sqrt()) > 2.0:
            break
    else:
        raise CheckFailed("no span lifts the attempt's error ratio above 2")
    ts = torch.tensor([0.0, span], device=dev)
    runs = {}
    for kernels in (True, False):
        cfg = args.solver_config(kernels)
        with torch.no_grad():
            before = ck.LAUNCHES["fused_dopri5_attempt_fwd"]
            xs, st = flow_forward(gp_params, draw, x, ts, cfg)
            launched = ck.LAUNCHES["fused_dopri5_attempt_fwd"] - before
        runs[kernels] = (xs[:, -1], st, launched)
        print(f"  span {span:.5g}, {'kernels' if kernels else 'plain'}: {st}, "
              f"attempt kernel launches {launched}")
    (x_k, st_k, n_k), (x_p, st_p, n_p) = runs[True], runs[False]
    check(n_k == 1 and n_p == 0, "the fallback did not start from the kernel")
    check(st_k.num_attempted > 1 and st_k.num_attempted == st_p.num_attempted,
          "the kernel path and the plain path attempt differently")
    check(st_k.num_covered == st_p.num_covered == 2,
          "the fallback did not reach the end of the span")
    err = compare_fwd(x_k, x_p, "reject fallback x(T)")
    return err, accept_decision_check(x, params, args.rtol, args.atol)


def phase_model_args(name):
    """A preset's `ModelArgs`; "official_heuristic" is the official preset
    with the train scripts' dopri5 defaults: Hairer's first-step heuristic
    and max_steps=64 (scripts/_cli.py)."""
    import dataclasses
    from gpode_tpu_torch.train.bench_setup import preset_model_args
    if name == "official_heuristic":
        return dataclasses.replace(preset_model_args("official"),
                                   first_step=None, max_steps=64)
    return preset_model_args(name)


def train_phase(dev, preset, profile_steps=0):
    """A preset's shooting train step: step-0 loss through the kernels
    against the plain path, then the timed steps with every launch counter
    set to 0 just before them. Returns (results, launches, args, params)."""
    phase(f"train ({preset})")
    import torch
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(phase_model_args(preset),
                                               device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    loss_fn = shooting_loss_fn(args)  # auto rule: 3000 rows take the kernels
    noise0 = sample_step_noise(params, args.num_features, args.num_samples, gen)
    with torch.no_grad():
        loss_k, terms_k = loss_fn(params, noise0, ys, ts)
        loss_p, terms_p = shooting_loss_fn(args, kernels=False)(params, noise0, ys, ts)
    lk, lp = float(loss_k), float(loss_p)
    print(f"step-0 loss: kernels {lk:.8f} (nfe {terms_k.nfe}), plain {lp:.8f} "
          f"(nfe {terms_p.nfe})")
    check(math.isfinite(lk) and abs(lk - lp) <= 1e-4 * abs(lp),
          "step-0 loss through the kernels differs from the plain path")
    extra = {}
    if preset == "fast":
        # the JAX package calls rk4 and dopri5 equal on this dt=0.01 grid
        # (gpode_tpu/train/bench_setup.py:40-42): printed, not checked
        with torch.no_grad():
            lo = float(shooting_loss_fn(preset_model_args("official"))(
                params, noise0, ys, ts)[0])
        print(f"step-0 loss on the same params and noise: fast {lk:.8f}, "
              f"official {lo:.8f} (rel diff {abs(lk - lo) / abs(lo):.3e})")
        extra["step0_official_same_noise"] = lo

    opt = default_optimizer(params, 5e-3)
    step = make_train_step(loss_fn, params, opt)
    torch.cuda.synchronize()
    ck.reset_launch_counts()                     # main path starts here
    losses, accepted, rejected, nfe = [], 0, 0, 0
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
        noise = sample_step_noise(params, args.num_features, args.num_samples, gen)
        terms = step(noise, ys, ts)
        losses.append(float(terms.loss.detach()))
        accepted += terms.natt == 1
        rejected += terms.natt > 1
        nfe += terms.nfe
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)                 # main path ends here
    peak = torch.cuda.max_memory_allocated(dev)
    sps = TRAIN_STEPS / seconds
    print(f"loss first {losses[0]:.6f} last {losses[-1]:.6f}; {sps:.2f} steps/s "
          f"({1e3 / sps:.3f} ms/step) over {TRAIN_STEPS} steps; attempts "
          f"accepted {accepted} rejected {rejected}; nfe {nfe}; peak memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}")
    check(all(math.isfinite(v) for v in losses), "non-finite training loss")
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = {name: launches[name] / n_steps
                for name in MAIN_PATH_KERNELS[preset]}
    print("launches per step: " + ", ".join(
        f"{name} {v:.2f}" for name, v in per_step.items()))
    for name in MAIN_PATH_KERNELS[preset]:
        check(launches[name] > 0, f"{name} never launched on the {preset} path")
        if preset == "fast":  # no reject fallback: exactly once per step
            check(launches[name] == n_steps,
                  f"{name} launched {launches[name]} times in {n_steps} steps")
    for name in OFF_PATH_KERNELS[preset]:
        check(launches[name] == 0, f"{name} launched on the {preset} path")
    if profile_steps:
        profile_train_steps(step, lambda: sample_step_noise(
            params, args.num_features, args.num_samples, gen), ys, ts,
            profile_steps, preset)
    return dict(loss_first=losses[0], loss_last=losses[-1], step0_kernels=lk,
                step0_plain=lp, steps_per_sec=sps, accepted=accepted,
                rejected=rejected, nfe=nfe, peak_bytes=peak,
                launches_per_step=per_step, **extra), \
        launches, args, params


def profile_train_steps(step, make_noise, ys, ts, n_steps, preset):
    """Device time per step by operator (torch.profiler), the device's busy
    share of the wall time, and the full table in
    chiprun_out/chip_smoke_profile_<preset>.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"profile ({preset}, {n_steps} steps)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(make_noise(), ys, ts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def dev_self_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only (kernels, memcpy/memset): the CPU operators
    # that launched them report the same time again
    kernels = _device_rows(events)
    busy_ms = sum(dev_self_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels) / n_steps
    print(f"wall {wall_ms / n_steps:.3f} ms/step (profiled); device busy "
          f"{busy_ms / n_steps:.3f} ms/step = {100 * busy_ms / wall_ms:.1f}% "
          f"of wall; {launches:.0f} device kernels/step")
    for e in sorted(kernels, key=dev_self_us, reverse=True)[:15]:
        print(f"  {dev_self_us(e) / 1e3 / n_steps:8.4f} ms/step "
              f"{e.count / n_steps:6.1f}x/step  {e.key[:80]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"chip_smoke_profile_{preset}.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


CAPTURE_PRESETS = ("official", "fast", "scale")
CAPTURE_STEPS = 30            # captured against eager from one start
CAPTURE_REJECT_STEPS = 10     # the forced-reject run; its stretched steps:
CAPTURE_REJECT_AT = (4, 7)    # replays (the capture is the third call)
CAPTURE_SYNC_STEPS = 5
CAPTURE_PROFILED = 5
CAPTURE_WINDOW = 50           # steps per timing window
CAPTURE_ROUNDS = 2            # rounds of eager, captured, captured, eager
# the device function of each segment kernel (csrc/fused_dopri5.cu,
# csrc/fused_rk4.cu), as the profiler names it
KERNEL_SYMBOLS = {"fused_dopri5_attempt_fwd": "dp_attempt_fwd_kernel",
                  "fused_dopri5_attempt_bwd": "dp_attempt_bwd_kernel",
                  "fused_rk4_segment_fwd": "rk4_fwd_kernel",
                  "fused_rk4_segment_bwd": "rk4_bwd_kernel"}


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0.0)


def _device_rows(events):
    """The device's own rows of `key_averages()`: kernels, copies and sets.
    A span of the program (`profiling.SPANS`) also has a row on the device,
    which repeats the time of the kernels inside it; it is left out."""
    from gpode_tpu_torch.utils.profiling import SPANS
    return [e for e in events
            if "CUDA" in str(e.device_type) and e.key not in SPANS]


def _max_rel(got, ref):
    """max |got - ref| / max |ref| over one tensor (0 when both are 0)."""
    scale = float(ref.abs().max())
    diff = float((got - ref).abs().max())
    return diff / scale if scale else diff


class _StepRun:
    """One copy of a bench problem's parameters with its Adam and train step
    (eager or captured), fed noise from its own generator."""

    def __init__(self, problem, captured):
        import copy
        import torch
        from gpode_tpu_torch.models.shooting import sample_step_noise
        from gpode_tpu_torch.train.builders import shooting_loss_fn
        from gpode_tpu_torch.train.graph_step import make_captured_train_step
        from gpode_tpu_torch.train.trainer import (default_optimizer,
                                                   make_train_step)
        self.args, params, self.ys, self.ts = problem
        dev = self.ys.device
        torch.cuda.synchronize()
        self.base = (torch.cuda.memory_allocated(dev),
                     torch.cuda.memory_reserved(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        self.params = copy.deepcopy(params)
        make = make_captured_train_step if captured else make_train_step
        self.step = make(shooting_loss_fn(self.args), self.params,
                         default_optimizer(self.params, 5e-3))
        self.gen = torch.Generator(dev).manual_seed(11)
        self.sample = lambda: sample_step_noise(
            self.params, self.args.num_features, self.args.num_samples,
            self.gen)

    def run(self, n, grid=None):
        """n steps; `grid(i)` the time grid of step i (default the data's).
        Returns the losses (device) and solver attempts."""
        losses, natts = [], []
        for i in range(n):
            terms = self.step(self.sample(), self.ys,
                              self.ts if grid is None else grid(i))
            losses.append(terms.loss.detach())
            natts.append(terms.natt)
        return losses, natts

    def peak_mib(self):
        """Peak allocated and reserved MiB above what was live before this
        run's parameters were copied."""
        import torch
        dev = self.ys.device
        return ((torch.cuda.max_memory_allocated(dev) - self.base[0]) / 2**20,
                (torch.cuda.max_memory_reserved(dev) - self.base[1]) / 2**20)


def _compare_runs(eager, captured, losses_e, losses_c, what):
    """The largest relative loss difference, the largest parameter
    difference (per leaf, relative to its largest magnitude) and whether
    the two runs are bit-equal; held at rtol 1e-6 and 1e-5."""
    import torch
    le, lc = torch.stack(losses_e), torch.stack(losses_c)
    loss_rel = float(((lc - le).abs() / le.abs()).max())
    param_rel = max(_max_rel(c.detach(), e.detach()) for e, c in zip(
        eager.params.parameters(), captured.params.parameters()))
    bit_equal = bool(torch.equal(le, lc)) and all(
        torch.equal(e, c) for e, c in zip(eager.params.parameters(),
                                         captured.params.parameters()))
    print(f"  {what}: {len(losses_e)} losses, largest relative difference "
          f"{loss_rel:.3e}; parameters {param_rel:.3e}; bit-equal {bit_equal}")
    check(torch.isfinite(lc).all() and loss_rel <= 1e-6 and param_rel <= 1e-5,
          f"{what}: the captured steps differ from the eager ones")
    return dict(loss_max_rel=loss_rel, param_max_rel=param_rel,
                bit_equal=bit_equal)


def _syncs_per_step(run, n):
    """Host syncs per step (`torch.cuda.set_sync_debug_mode("warn")`:
    each synchronizing CUDA call warns once)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run.run(n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / n


def _profile_run(run, n, kernels):
    """torch.profiler over n steps: device kernels per step, device busy
    share of the wall, each segment kernel's device launches against the
    `LAUNCHES` count of the same steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gpode_tpu_torch.ops import cuda_kernels as ck
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.run(n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_rows(prof.key_averages())
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    device = {name: sum(e.count for e in events if KERNEL_SYMBOLS[name] in e.key)
              for name in kernels}
    counted = {name: ck.LAUNCHES[name] - before[name] for name in kernels}
    return dict(kernels_per_step=sum(e.count for e in events) / n,
                busy_ms_per_step=busy_ms / n, wall_ms_per_step=wall_ms / n,
                busy_share=busy_ms / wall_ms, device_launches=device,
                counted_launches=counted)


def _timed_window(run, n):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, _ = run.run(n)
    float(losses[-1])               # the window ends in a host read
    return n / (time.perf_counter() - t0)


def _captured_preset(dev, preset):
    """Phase 7g for one preset: see `captured_step_phase`."""
    import statistics
    import torch
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops.capture import WARMUP
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.graph_step import capture_refusal
    problem = build_bench_problem(preset_model_args(preset), device=dev)
    reason = capture_refusal(problem[0], dev, problem[1])
    print(f" {preset}: capture_refusal {reason!r}", flush=True)
    if reason is not None:
        check(preset == "scale", f"the {preset} step is not captured: {reason}")
        return dict(refused=reason)
    kernels = MAIN_PATH_KERNELS[preset]
    runs, out = {}, {}
    for captured in (False, True):
        run = _StepRun(problem, captured)
        ck.reset_launch_counts()                 # main path starts here
        losses, natts = run.run(CAPTURE_STEPS)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)             # main path ends here
        name = "captured" if captured else "eager"
        print(f"  {name}: launches {', '.join(f'{k} {launches[k]}' for k in kernels)}"
              f"; attempts {sorted(set(natts))}; peak MiB (allocated, "
              f"reserved) above the problem's {run.peak_mib()}", flush=True)
        check(all(launches[k] == CAPTURE_STEPS for k in kernels)
              and set(natts) == {1},
              f"{preset} {name}: the segment kernels did not launch once per "
              f"step in each direction, or an attempt was rejected")
        runs[captured] = run
        out[name] = dict(launches={k: launches[k] for k in kernels},
                         peak_mib=run.peak_mib())
        out[name]["losses"] = losses
    step = runs[True].step
    check(len(step.graphs) == (2 if preset != "fast" else 1)
          and step.replays == CAPTURE_STEPS - WARMUP,
          f"{preset}: {len(step.graphs)} graphs, {step.replays} replays")
    out.update(_compare_runs(runs[False], runs[True], out["eager"].pop("losses"),
                             out["captured"].pop("losses"), preset))
    out["graphs"] = len(step.graphs)
    out["graph_launches"] = step.graph_launches
    for name, captured in (("eager", False), ("captured", True)):
        run = runs[captured]
        syncs = _syncs_per_step(run, CAPTURE_SYNC_STEPS)
        prof = _profile_run(run, CAPTURE_PROFILED, kernels)
        print(f"  {name}: {syncs:.2f} host syncs per step; "
              f"{prof['kernels_per_step']:.0f} device kernels per step; busy "
              f"{prof['busy_ms_per_step']:.3f} of {prof['wall_ms_per_step']:.3f}"
              f" ms = {100 * prof['busy_share']:.1f}%; segment kernels in "
              f"{CAPTURE_PROFILED} steps: device {prof['device_launches']}, "
              f"LAUNCHES {prof['counted_launches']}", flush=True)
        check(all(prof["device_launches"][k] == prof["counted_launches"][k]
                  == CAPTURE_PROFILED for k in kernels),
              f"{preset} {name}: a segment kernel did not run once per step "
              f"in each direction, or LAUNCHES disagrees with the device")
        out[name].update(host_syncs_per_step=syncs, **prof)
    reads = 1 if preset != "fast" else 0
    check(out["captured"]["host_syncs_per_step"] == reads,
          f"{preset}: {out['captured']['host_syncs_per_step']} host syncs per "
          f"captured step, not {reads}")
    rates = {"eager": [], "captured": []}
    for _ in range(CAPTURE_ROUNDS):
        for name in ("eager", "captured", "captured", "eager"):
            rates[name].append(_timed_window(runs[name == "captured"],
                                             CAPTURE_WINDOW))
    for name, r in rates.items():
        out[name]["steps_per_sec"] = r
        out[name]["steps_per_sec_median"] = statistics.median(r)
    print(f"  steps/s over windows of {CAPTURE_WINDOW} (eager, captured, "
          f"captured, eager) x {CAPTURE_ROUNDS}: eager "
          f"{[round(v, 2) for v in rates['eager']]}, captured "
          f"{[round(v, 2) for v in rates['captured']]}; medians "
          f"{out['eager']['steps_per_sec_median']:.2f} / "
          f"{out['captured']['steps_per_sec_median']:.2f}", flush=True)
    return out


def _captured_reject(dev):
    """A forced reject inside the captured official step: the data's grid
    stretched at CAPTURE_REJECT_AT (by the first power of 2 whose
    whole-span attempt the eager loss rejects); the captured run's losses,
    attempts and parameters equal to the eager run's."""
    import torch
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.ops.capture import WARMUP
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    problem = build_bench_problem(preset_model_args("official"), device=dev)
    args, params, ys, ts = problem
    noise = sample_step_noise(params, args.num_features, args.num_samples,
                              torch.Generator(dev).manual_seed(12))
    for k in range(1, 12):
        with torch.no_grad():
            natt = shooting_loss_fn(args)(params, noise, ys, ts * 2 ** k)[1].natt
        if natt > 1:
            break
    else:
        raise CheckFailed("no stretch of the grid rejects the attempt")
    long_ts = ts * 2 ** k

    def grid(i):
        return long_ts if i in CAPTURE_REJECT_AT else ts

    runs, seqs = {}, {}
    for captured in (False, True):
        runs[captured] = _StepRun(problem, captured)
        seqs[captured] = runs[captured].run(CAPTURE_REJECT_STEPS, grid)
    step = runs[True].step
    print(f"  forced reject: grid x {2 ** k} at steps {CAPTURE_REJECT_AT}; "
          f"attempts eager {seqs[False][1]}, captured {seqs[True][1]}; "
          f"captured replays {step.replays}, rejects {step.rejects}, host "
          f"reads {step.host_reads}", flush=True)
    check(seqs[True][1] == seqs[False][1]
          and all(seqs[False][1][i] > 1 for i in CAPTURE_REJECT_AT)
          and step.rejects == len(CAPTURE_REJECT_AT)
          and step.replays == (CAPTURE_REJECT_STEPS - WARMUP
                               - len(CAPTURE_REJECT_AT)),
          "the forced reject was not taken eagerly inside the captured step")
    out = _compare_runs(runs[False], runs[True], seqs[False][0], seqs[True][0],
                        "forced reject")
    return dict(stretch=2 ** k, attempts=seqs[True][1], rejects=step.rejects,
                replays=step.replays, **out)


def captured_step_phase(dev):
    """Phase 7g: the train step as captured CUDA graphs
    (`train/graph_step.py`) against the eager step."""
    phase("captured step")
    out = {preset: _captured_preset(dev, preset) for preset in CAPTURE_PRESETS}
    out["official"]["forced_reject"] = _captured_reject(dev)
    return out


DRAWS_ATTEMPT_CASES = {"validation": 32, "test_eval": 128}   # draws x 2 rows


def draws_attempt_phase(dev):
    """`dopri5_attempt_draws` against its plain version at the validation
    and test-evaluation shapes, timed beside its bound and the plain
    version, its resources, and the captured attempt's replay, fused and
    plain, then the launches of the validation request's solve. Returns
    (the kernel row at 32 x 2, details by shape, the solve's launches)."""
    phase("draws attempt")
    import torch
    from gpode_tpu_torch.models import flow, gp, gpode
    from gpode_tpu_torch.ops import cuda_build
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)

    _, params, _, _ = build_bench_problem(preset_model_args("official"),
                                          device=dev)
    g = params.gp
    means = params.states.mean.detach().reshape(-1, 5)
    details, row, solve = {}, None, None
    for label, draws_n in DRAWS_ATTEMPT_CASES.items():
        noise = gpode.sample_draw_noise(g, 256, draws_n,
                                        torch.Generator(dev).manual_seed(5))
        with torch.no_grad():
            draw = gp.draw_posterior(g, noise.rff_weights, noise.rff_freq,
                                     noise.rff_phase, noise.inducing)
            x = means[:2].expand(draws_n, -1, -1).contiguous()
            kern = g.kernel
            ops = (g.z.detach(), kern.lengthscales.detach(),
                   kern.variance.detach(), draw.omega, draw.phase,
                   gp.kernel_rff_weights(draw.weights), draw.nu)
            k1 = ck.draws_field_plain(x, *ops).contiguous()
            dt = torch.tensor(0.01, device=dev)
            got = ck.dopri5_attempt_draws(x, k1, dt, 1.0, *ops)
            check(all(torch.equal(a, b) for a, b in zip(
                got, ck.dopri5_attempt_draws(x, k1, dt, 1.0, *ops))),
                f"two dopri5_attempt_draws runs differ ({label})")
            want = ck.dopri5_attempt_draws_plain(x, k1, dt, 1.0, *ops)
            err = max(compare_fwd(got[0], want[0], f"dopri5_attempt_draws x_new ({label})"),
                      compare_fwd(got[2], want[2], f"dopri5_attempt_draws k7 ({label})"))
            for k in range(40):
                span = torch.tensor(0.01 * 1.25 ** k, device=dev)
                ref = float(ck.dopri5_attempt_draws_plain(x, k1, span, 1.0, *ops)[1])
                if ref > 1e3:
                    break
            ratio = float(ck.dopri5_attempt_draws(x, k1, span, 1.0, *ops)[1])
            print(f"  dopri5_attempt_draws ratio at dt={float(span):.4g} ({label}): "
                  f"{ratio:.6g} vs plain {ref:.6g}")
            check(abs(ratio - ref) <= 1e-3 * ref,
                  f"dopri5_attempt_draws error ratio disagrees ({label})")
            ms = cuda_ms(lambda: ck.dopri5_attempt_draws(x, k1, dt, 1.0, *ops))
            pms = cuda_ms(lambda: ck.dopri5_attempt_draws_plain(x, k1, dt, 1.0, *ops))
            replay = {}
            for fused in (True, False):
                att = flow.CapturedAttempt(g, draw, x, 1.0, 1e-6, 1e-6, False,
                                           fused, COMMIT_POINTS)
                att.load(draw)
                att.k1.copy_(k1)
                att.dt.fill_(0.01)
                att.capture()
                replay["fused" if fused else "plain"] = cuda_ms(att.graph.replay)
        bms, by = bound(*dp_attempt_draws(draws_n, 2, 5, 5, 100, 256))
        geo = ck.draws_attempt_geometry(draws_n, 2, 5, 5, 100, 256)
        report = print_resources(f"dopri5_attempt_draws ({label})",
                                 ck.draws_attempt_occupancy(5, 5, 100, 256, geo))
        print(f"dopri5_attempt_draws ({label}: {draws_n} draws x 2 rows): "
              f"{ms:.4f} ms kernel, {pms:.4f} ms plain, bound {bms:.5f} ms "
              f"({by}), {100 * bms / ms:.2f}% of it; captured attempt replay "
              f"{replay['fused']:.4f} ms fused, {replay['plain']:.4f} ms plain")
        details[label] = dict(draws=draws_n, rows=2, max_abs_err=err, ms=ms,
                              plain_ms=pms, bound_ms=bms, bound_by=by,
                              replay_ms=replay, blocks=geo.blocks, **report)
        if row is None:
            row, solve = (err, ms, pms, bms, by), (draw, x)
    # the validation request's solve as the program runs it: the first call
    # captures (two warm-up launches), the second replays once an attempt
    cfg = flow.SolverConfig(solver="dopri5", max_steps=512)
    grid = 0.01 * torch.arange(120, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for _ in range(2):
            ck.reset_launch_counts()
            _, stats = flow.flow_forward_batched(g, *solve, grid, cfg)
    launches = dict(ck.LAUNCHES)
    print(f"  validation solve: {stats}, launches {launches}")
    check(launches["dopri5_attempt_draws"] == stats.num_attempted,
          "the validation solve's attempt is not the draws kernel")
    check(launches["draws_commit"] == stats.num_attempted,
          "the validation solve's attempt does not commit on the device")
    lib_name, kernel, _ = ck.DRAWS_KERNEL
    built = {k: v for k, v in cuda_build.kernel_resources(lib_name).items()
             if kernel in k}
    check(len(built) == len(ck._DRAWS_VARIANTS),
          f"dopri5_attempt_draws: {len(built)} variants built")
    for key, rec in built.items():
        print(f"  dopri5_attempt_draws variant {key}: {rec['registers']} "
              f"registers, spill {rec['spill_stores']} B stores / "
              f"{rec['spill_loads']} B loads")
        check(rec["spill_stores"] == 0 and rec["spill_loads"] == 0,
              f"dopri5_attempt_draws variant {key} spills registers")
    return row, details, launches


COMMIT_POINTS = 120


def draws_commit_ops(written, elements, points):
    """(operations, bytes) of one `draws_commit` launch that writes
    `written` of `points` output times of `elements` states: per point and
    element 4 products and 3 sums (the coefficients are per point); x, k1,
    x_new and k7 read, x and k1 written, the points written, the times, the
    ratio and the three scalars read."""
    return (7 * written * elements,
            4 * ((6 + written) * elements + points + 4))


def draws_commit_phase(dev):
    """`draws_commit` at the validation request's and the test
    evaluation's states (32 and 128 draws x 2 rows x 5) and COMMIT_POINTS
    output times against its plain version, bit for bit, over a step of two
    output times and over the whole span; its device ms at the two-point
    step beside its bound and the plain version's (the two points'
    `_hermite` ops and the hand-over copies, as the host issues them), its
    registers free of spills, and one replay of the captured fused attempt
    with the commit. Returns (the kernel row at 32 x 2, details by shape)."""
    phase("draws commit")
    import numpy as np
    import torch
    from gpode_tpu_torch.models import flow, gp, gpode
    from gpode_tpu_torch.ops import cuda_build, ode
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)

    _, params, _, _ = build_bench_problem(preset_model_args("official"),
                                          device=dev)
    g = params.gp
    taus_np = (0.01 * np.arange(COMMIT_POINTS)).astype(np.float32)
    taus = torch.from_numpy(taus_np).to(dev)
    steps = {"two_points": (np.float32(taus_np[40] + np.float32(0.003)),
                            np.float32(taus_np[42] + np.float32(0.004))),
             "whole_span": (np.float32(0.0), taus_np[-1])}
    ratio = torch.tensor(0.5, device=dev)
    details, row = {}, None
    for label, draws_n in DRAWS_ATTEMPT_CASES.items():
        gen = torch.Generator(dev).manual_seed(9)
        x, k1, x_new, k7 = (torch.randn(draws_n, 2, 5, device=dev, generator=gen)
                            for _ in range(4))
        dense = torch.zeros(COMMIT_POINTS, draws_n, 2, 5, device=dev)
        scalars = {}
        for step, (tau, tau_end) in steps.items():
            scalars[step] = torch.tensor([0.01, tau, tau_end], device=dev)
            got = [dense.clone(), x.clone(), k1.clone()]
            want = [dense.clone(), x.clone(), k1.clone()]
            ck.draws_commit(ratio, scalars[step], taus, *got, x_new, k7)
            ck.draws_commit_plain(ratio, scalars[step], taus, *want, x_new, k7)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"draws_commit differs from its plain version ({label}, {step})")
        tau, tau_end = steps["two_points"]
        buf = [dense.clone(), x.clone(), k1.clone()]
        ms = cuda_ms(lambda: ck.draws_commit(ratio, scalars["two_points"], taus,
                                             *buf, x_new, k7))

        def host_commit():
            for j in (41, 42):
                ode._hermite(taus_np[j], tau, tau_end, x, k1, x_new, k7)
            buf[1].copy_(x_new)
            buf[2].copy_(k7)

        pms = cuda_ms(host_commit)
        noise = gpode.sample_draw_noise(g, 256, draws_n,
                                        torch.Generator(dev).manual_seed(5))
        with torch.no_grad():
            draw = gp.draw_posterior(g, noise.rff_weights, noise.rff_freq,
                                     noise.rff_phase, noise.inducing)
            att = flow.CapturedAttempt(g, draw, x, 1.0, 1e-6, 1e-6, False,
                                       True, COMMIT_POINTS)
            att.load(draw)
            att.dense_output(taus_np, x)
            att.k1.copy_(k1)
            att.scalars.copy_(scalars["two_points"])
            att.capture()
            replay = cuda_ms(att.graph.replay)
        elements = draws_n * 2 * 5
        bms, by = bound(*draws_commit_ops(2, elements, COMMIT_POINTS))
        print(f"draws_commit ({label}: {draws_n} draws x 2 rows x 5, "
              f"{COMMIT_POINTS} times, 2 written): {ms:.4f} ms kernel, "
              f"{pms:.4f} ms plain (2 _hermite points and the hand-over "
              f"copies), bound {bms:.6f} ms ({by}), {100 * bms / ms:.2f}% of "
              f"it; captured fused attempt with the commit {replay:.4f} ms")
        details[label] = dict(draws=draws_n, rows=2, points=COMMIT_POINTS,
                              written=2, ms=ms, plain_ms=pms, bound_ms=bms,
                              bound_by=by, replay_with_commit_ms=replay)
        if row is None:
            row = (0.0, ms, pms, bms, by)
    built = {k: v for k, v in cuda_build.kernel_resources("dopri5_draws").items()
             if "draws_commit_kernel" in k}
    check(len(built) == 1, f"draws_commit: {len(built)} kernels built")
    for key, rec in built.items():
        print(f"  draws_commit {key}: {rec['registers']} registers, spill "
              f"{rec['spill_stores']} B stores / {rec['spill_loads']} B loads")
        check(rec["spill_stores"] == 0 and rec["spill_loads"] == 0,
              "draws_commit spills registers")
        details["registers"] = rec["registers"]
    return row, details


# `draw_solve` shapes: (factors, M, right-hand columns a factor); the first
# is the train step's (5 latents, 100 inducing points, one draw), "m256" the
# `scale` step's (256 inducing points: the packed layout)
DRAW_SOLVE_CASES = {"train": (5, 100, 1), "draws32": (5, 100, 32),
                    "m128": (5, 128, 1), "m256": (5, 256, 1)}
# forward + backward ms at "m256" that the packed kernels aim under
DRAW_SOLVE_M256_TARGET_MS = 0.30
# (direction, M, R) whose resources the phase reads: every kernel of both
# layouts, at one column and at the most columns its layout takes at M
DRAW_SOLVE_RESOURCES = [(d, 100, 1) for d in ("fwd", "bwd")] + [
    (d, 128, 32) for d in ("fwd", "bwd")] + [
    (d, 256, r) for d in ("fwd", "bwd_cols", "bwd_rows", "bwd_sym")
    for r in (1, 32)]


def draw_solve_phase(dev):
    """The posterior draw's `draw_solve` kernels at DRAW_SOLVE_CASES against
    the float64 library chain (nu and its cotangents in K, u and v within
    2e-3 of the largest entry, as the float32 chain), reruns bit-identical;
    each kernel's device ms beside its bound (`benchmark/opcounts_draw.py`),
    its plain version's (the forward's library factor and solves in the
    kernels' layout, `draw_solve_bwd_plain`) and the library chain's as the
    draw ran it before (`library_ms`: its forward; for the backward, its
    forward and backward less the forward), at "m256" (the packed layout,
    its backward three launches) beside DRAW_SOLVE_M256_TARGET_MS;
    resources free of spills. Returns (the kernel rows at the train shape,
    details by kernel)."""
    phase("draw solve")
    import ctypes

    import torch
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.ops import cuda_build
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops import math as om
    from gpode_tpu_torch.ops.kernels import rbf_K

    def chain(k3, u, v):
        return gp.draw_solve_plain(k3, u.permute(1, 2, 0),
                                   v.permute(1, 2, 0)).transpose(0, 1)

    details = {"draw_solve_fwd": {"shapes": {}},
               "draw_solve_bwd": {"shapes": {}}}
    rows = {}
    for label, (b, m, r) in DRAW_SOLVE_CASES.items():
        gen = torch.Generator().manual_seed(11)
        params = gp.init_svgp(gen, 5, b, m).to(dev)
        k3 = rbf_K(params.kernel, params.z).detach().contiguous()
        u, v, g = (torch.randn(b, r, m, generator=gen).to(dev)
                   for _ in range(3))

        def run(fn, dtype):
            args = [t.to(dtype).requires_grad_() for t in (k3, u, v)]
            nu = fn(*args)
            return (nu.detach(),) + torch.autograd.grad(nu, args, g.to(dtype))

        def kernels(k, uu, vv):
            return ck._DrawSolveFn.apply(k, uu, vv, om.DEFAULT_JITTER)

        got = run(kernels, torch.float32)
        check(all(torch.equal(a, c) for a, c in zip(got, run(kernels,
                                                             torch.float32))),
              f"draw_solve reruns differ ({label})")
        plain = run(chain, torch.float32)
        exact = run(chain, torch.float64)
        errs = {}
        for name, kern, lib, ref in zip(("nu", "g_K", "g_u", "g_v"), got,
                                        plain, exact):
            scale = float(ref.abs().max())
            errs[name] = (float((kern.double() - ref).abs().max()) / scale,
                          float((lib.double() - ref).abs().max()) / scale)
            check(errs[name][0] <= 2e-3,
                  f"draw_solve {name} off the float64 chain by {errs[name][0]:.3e} "
                  f"({label})")
        L, a, nu = ck._draw_solve_fwd(k3, u, v, om.DEFAULT_JITTER)
        gk, gu, gv, work = (torch.empty_like(t) for t in (L, a, a, L))
        lib = ck._lib("draw_solve")
        stream = ck._stream(dev)
        ptrs_f = [ck._ptr(t) for t in (k3, u, v)]
        outs_f = [ck._ptr(t) for t in (L, a, nu)]
        jitter = ctypes.c_float(om.DEFAULT_JITTER)
        fwd_ms = cuda_ms(lambda: lib.gpode_draw_solve_fwd(
            *ptrs_f, jitter, *outs_f, b, m, r, stream))
        packed = ck.draw_solve_geometry(b, m, r).layout == "packed"
        if packed:
            ptrs_b = [ck._ptr(t) for t in (L, a, v, g, work, gk, gu, gv)]
            bwd_ms = cuda_ms(lambda: lib.gpode_draw_solve_bwd_slabs(
                *ptrs_b, b, m, r, stream))
        else:
            ptrs_b = [ck._ptr(t) for t in (L, a, v, g, gk, gu, gv)]
            bwd_ms = cuda_ms(lambda: lib.gpode_draw_solve_bwd(*ptrs_b, b, m, r,
                                                              stream))

        def plain_fwd():
            lf = om.cholesky_jittered(k3)
            af = om.solve_lower(lf, u.mT)
            om.solve_upper_from_lower(lf, v.mT - af)

        plain_fwd_ms = cuda_ms(plain_fwd)
        slab = ck._DRAW_SOLVE_SLAB_COLS if packed else None
        plain_bwd_ms = cuda_ms(lambda: ck.draw_solve_bwd_plain(L, a, v, g,
                                                               slab=slab))
        # the library chain as `draw_posterior` ran it: u_prior and v
        # (M, D) columns of one draw's noise, nu (D, M)
        u_draw = u.permute(1, 2, 0).contiguous().requires_grad_()
        v_draw = v.permute(1, 2, 0).contiguous().requires_grad_()
        k_leaf = k3.clone().requires_grad_()
        g_draw = g.transpose(0, 1).contiguous()

        def library_fwd():
            with torch.no_grad():
                gp.draw_solve_plain(k_leaf, u_draw, v_draw)

        def library_both():
            out = gp.draw_solve_plain(k_leaf, u_draw, v_draw)
            torch.autograd.grad(out, (k_leaf, u_draw, v_draw), g_draw)

        lib_fwd_ms = cuda_ms(library_fwd)
        lib_both_ms = cuda_ms(library_both)
        (fo, fb), (bo, bb) = draw_solve_fwd(b, m, r), draw_solve_bwd(b, m, r)
        f_bms, f_by = bound(fo, fb)
        b_bms, b_by = bound(bo, bb)
        print(f"draw_solve ({label}: {b} factors, M={m}, R={r}): forward "
              f"{fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f}, library "
              f"{lib_fwd_ms:.4f}, bound {f_bms:.6f} ({f_by})), backward "
              f"{bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, library "
              f"{lib_both_ms - lib_fwd_ms:.4f} of {lib_both_ms:.4f} with its "
              f"forward, bound {b_bms:.6f} ({b_by})); errors against float64 "
              + ", ".join(f"{k} {e[0]:.2e} (chain {e[1]:.2e})"
                          for k, e in errs.items()), flush=True)
        for name, ms, pms, lms, bms, by in (
                ("draw_solve_fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms, f_bms, f_by),
                ("draw_solve_bwd", bwd_ms, plain_bwd_ms,
                 lib_both_ms - lib_fwd_ms, b_bms, b_by)):
            err = errs["nu"][0] if name.endswith("fwd") else max(
                errs[k][0] for k in ("g_K", "g_u", "g_v"))
            details[name]["shapes"][label] = dict(
                factors=b, num_inducing=m, columns=r, ms=ms, plain_ms=pms,
                library_ms=lms, bound_ms=bms, bound_by=by, max_rel_err=err)
            if label == "train":
                rows[name] = (err, ms, pms, bms, by)
                details[name]["library_ms"] = lms
        if label == "m256":
            both = fwd_ms + bwd_ms
            print(f"draw_solve m256: forward + backward {both:.4f} ms against "
                  f"the library chain's {lib_both_ms:.4f} ms (target "
                  f"{DRAW_SOLVE_M256_TARGET_MS} ms: "
                  f"{'met' if both <= DRAW_SOLVE_M256_TARGET_MS else 'NOT met'})",
                  flush=True)
            details["m256_both_ms"] = both
            details["m256_library_ms"] = lib_both_ms
    for direction, m, r in DRAW_SOLVE_RESOURCES:
        rep = ck.draw_solve_occupancy(direction, m, r)
        print(f"  draw_solve {direction} resources at M={m}, R={r}: "
              f"{rep['registers']} registers, {rep['threads']} threads, "
              f"{rep['smem_bytes']} B shared, {rep['blocks_per_sm']} "
              f"block(s) per SM, local {rep['local_bytes']} B, spill "
              f"{rep['spill_stores']} / {rep['spill_loads']} B")
        check(rep["local_bytes"] == 0 and rep["spill_stores"] == 0
              and rep["spill_loads"] == 0,
              f"draw_solve {direction} spills at M={m}, R={r}")
    built = cuda_build.kernel_resources("draw_solve")
    check(len(built) == len(ck.DRAW_SOLVE_KERNELS) and all(
        rec["spill_stores"] == 0 and rec["spill_loads"] == 0
        for rec in built.values()), "a draw_solve kernel spills")
    return rows, details


# `state_entropy` shapes: (sequences, shooting states, D); "train" is the
# MoCap train step's
STATE_ENTROPY_CASES = {"train": (6, 99, 5), "d2": (6, 99, 2), "d8": (6, 99, 8)}


def state_entropy_counts(n, d):
    """(forward, backward) of the `state_entropy` kernels over n factors of
    dimension d, each (operations, bytes): L L^T + jitter I, the Cholesky
    (a square root and a reciprocal a column), the logs and their sum; the
    backward again the factor, then C^{-1} L and C^{-T} X on the lower
    triangle and the scaling. Each input float read once, each output
    written once."""
    p = d * (d + 1) // 2
    gram = sum(2 * j + 1 for i in range(d) for j in range(i + 1)) + d
    chol = sum(2 * j + 2 + sum(2 * j + 1 for _ in range(j + 1, d))
               for j in range(d))
    fwd = gram + chol + 2 * d + 2
    solves = sum(2 * (i - j) + 1 for j in range(d) for i in range(j, d))
    solves += sum(2 * (d - 1 - i) + 1 for j in range(d) for i in range(j, d))
    bwd = gram + chol + solves + p
    return (n * fwd, 4 * n * (p + 1)), (n * bwd, 4 * n * (2 * p + 1))


def state_entropy_phase(dev):
    """The shooting states' `state_entropy` kernels at STATE_ENTROPY_CASES
    against the unrolled chain (`states.shooting_entropy` under
    kernels=False): the forward within 1e-6 of the chain in float32 and
    1e-5 of it in float64, the cotangent bit for bit autograd's through the
    chain and within 1e-5 of float64 (of the largest entry), reruns
    bit-identical; each
    kernel's device ms beside its bound (`state_entropy_counts`), its plain
    version's (the chain's forward; `state_entropy_bwd_plain`) and the
    chain's as the step ran it before (`library_ms`: its forward; for the
    backward, its forward and backward less the forward); at "train" both
    kernels against the chain's forward and backward; every instantiation
    free of spills. Returns (the kernel rows at the train shape, details by
    kernel)."""
    phase("state entropy")
    import ctypes

    import torch
    from gpode_tpu_torch.models import states
    from gpode_tpu_torch.ops import cuda_build
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.ops import math as om

    jitter = om.DEFAULT_JITTER
    details = {"state_entropy_fwd": {"shapes": {}},
               "state_entropy_bwd": {"shapes": {}}}
    rows = {}
    for label, (nseq, t1, d) in STATE_ENTROPY_CASES.items():
        n, p = nseq * t1, d * (d + 1) // 2
        gen = torch.Generator().manual_seed(13)
        post = states.init_shooting_states(gen, nseq, t1, d, device=dev)
        diag = torch.eye(d, dtype=torch.bool)[tuple(torch.tril_indices(d, d))]
        z = torch.randn(2, nseq, t1, p, generator=gen)
        with torch.no_grad():
            post.tril_packed.copy_(torch.where(
                diag, 0.1 * torch.exp(0.3 * z[0]), 0.02 * z[1]))
        g = torch.randn(nseq, t1, generator=gen).to(dev)

        def run(kernels, dtype=torch.float32):
            q = post if dtype == torch.float32 else states.ShootingStatePosterior(
                post.x0, post.mean, post.tril_packed.detach().double())
            out = states.shooting_entropy(q, kernels=kernels)
            return out.detach(), torch.autograd.grad(out, q.tril_packed,
                                                     g.to(dtype))[0]

        got = run(None)
        check(all(torch.equal(a, b) for a, b in zip(got, run(None))),
              f"state_entropy reruns differ ({label})")
        chain, exact = run(False), run(False, torch.float64)

        def rel(a, b):
            return float((a.double() - b).abs().max() / b.abs().max())

        bits = int((got[1] != chain[1]).sum())
        check(bits == 0, f"state_entropy's gradient differs from the chain's "
              f"in {bits} of {got[1].numel()} entries ({label})")
        errs = {"fwd_chain": rel(got[0], chain[0].double()),
                "fwd": rel(got[0], exact[0]), "bwd": rel(got[1], exact[1]),
                "chain_fwd": rel(chain[0], exact[0]),
                "chain_bwd": rel(chain[1], exact[1])}
        check(errs["fwd_chain"] <= 1e-6 and errs["fwd"] <= 1e-5
              and errs["bwd"] <= 1e-5, f"state_entropy off its references "
              f"({label}): {errs}")
        tril = post.tril_packed.detach()
        ent, grad = torch.empty(nseq, t1, device=dev), torch.empty_like(tril)
        lib, stream = ck._lib("state_entropy"), ck._stream(dev)
        c_jitter = ctypes.c_float(jitter)
        const = ctypes.c_float(d * (1.0 + math.log(2.0 * math.pi)))
        fwd_ms = cuda_ms(lambda: lib.gpode_state_entropy_fwd(
            ck._ptr(tril), c_jitter, const, ck._ptr(ent), n, d, stream))
        bwd_ms = cuda_ms(lambda: lib.gpode_state_entropy_bwd(
            ck._ptr(tril), ck._ptr(g), c_jitter, ck._ptr(grad), n, d, stream))
        q = states.ShootingStatePosterior(post.x0, post.mean, tril.clone())

        def chain_fwd():
            with torch.no_grad():
                states.shooting_entropy(q, kernels=False)

        def chain_both():
            out = states.shooting_entropy(q, kernels=False)
            torch.autograd.grad(out, q.tril_packed, g)

        chain_fwd_ms, chain_both_ms = cuda_ms(chain_fwd), cuda_ms(chain_both)
        plain_bwd_ms = cuda_ms(lambda: ck.state_entropy_bwd_plain(tril, g, d))
        (fo, fb), (bo, bb) = state_entropy_counts(n, d)
        f_bms, f_by = bound(fo, fb)
        b_bms, b_by = bound(bo, bb)
        print(f"state_entropy ({label}: {nseq} x {t1} factors, D={d}): "
              f"forward {fwd_ms:.4f} ms (chain {chain_fwd_ms:.4f}, bound "
              f"{f_bms:.6f} ({f_by})), backward {bwd_ms:.4f} ms (plain "
              f"{plain_bwd_ms:.4f}, chain {chain_both_ms - chain_fwd_ms:.4f} "
              f"of {chain_both_ms:.4f} with its forward, bound {b_bms:.6f} "
              f"({b_by})); forward + backward {fwd_ms + bwd_ms:.4f} ms against "
              f"the chain's {chain_both_ms:.4f}; errors "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), flush=True)
        for name, ms, pms, lms, bms, by, err in (
                ("state_entropy_fwd", fwd_ms, chain_fwd_ms, chain_fwd_ms,
                 f_bms, f_by, errs["fwd"]),
                ("state_entropy_bwd", bwd_ms, plain_bwd_ms,
                 chain_both_ms - chain_fwd_ms, b_bms, b_by, errs["bwd"])):
            details[name]["shapes"][label] = dict(
                factors=n, dim=d, ms=ms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by, max_rel_err=err)
            if label == "train":
                rows[name] = (err, ms, pms, bms, by)
                details[name]["library_ms"] = lms
        if label == "train":
            details["state_entropy_fwd"]["both_ms"] = fwd_ms + bwd_ms
            details["state_entropy_fwd"]["chain_both_ms"] = chain_both_ms
    for direction in ("fwd", "bwd"):
        for d in range(1, om.SMALL_CHOL_MAX_DIM + 1):
            rep = ck.state_entropy_occupancy(direction, d)
            print(f"  state_entropy {direction} resources at D={d}: "
                  f"{rep['registers']} registers, {rep['threads']} threads, "
                  f"{rep['blocks_per_sm']} block(s) per SM, local "
                  f"{rep['local_bytes']} B, spill {rep['spill_stores']} / "
                  f"{rep['spill_loads']} B")
            check(rep["local_bytes"] == 0 and rep["spill_stores"] == 0
                  and rep["spill_loads"] == 0,
                  f"state_entropy {direction} spills at D={d}")
    built = cuda_build.kernel_resources("state_entropy")
    check(len(built) == 2 * om.SMALL_CHOL_MAX_DIM and all(
        rec["spill_stores"] == 0 and rec["spill_loads"] == 0
        for rec in built.values()), "a state_entropy kernel spills")
    return rows, details


def eval_phase(dev, args, params):
    """The projected scorer of `scripts/bench_time_to_nll.py` on the port:
    EVAL_DRAWS posterior draws from the MoCap-09 test split's start states,
    the preset's solver with max_steps >= 512 and the step-size heuristic,
    LL and MSE in the 50-D data space. Held: finite, and the device metric
    equal to the host metric on the same predictions (rtol 1e-4)."""
    phase("eval")
    import dataclasses

    import numpy as np
    import torch
    from gpode_tpu_torch.data.mocap import latent_to_data_projector
    from gpode_tpu_torch.models.gpode import (GPODEParams, predict,
                                              sample_predict_noise)
    from gpode_tpu_torch.models.likelihoods import project
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import load_bench_data
    from gpode_tpu_torch.train.builders import make_projector
    from gpode_tpu_torch.train.evaluation import make_projected_scorer
    from gpode_tpu_torch.train.metrics import (compute_summary,
                                               mixture_summary_device)

    data_pca, data_full = load_bench_data()
    cfg = args.solver_config()
    eval_cfg = dataclasses.replace(cfg, max_steps=max(512, cfg.max_steps),
                                   first_step=None)
    projector = latent_to_data_projector(data_pca)
    ys_true = np.asarray(data_full.tst.ys, np.float32)
    ts, x0 = data_pca.tst.ts, data_pca.tst.ys[:, 0]
    scorer = make_projected_scorer(eval_cfg, projector, ys_true, ts, x0,
                                   device=dev)
    view = GPODEParams(params.gp, params.states.x0, params.likelihood)
    noise = sample_predict_noise(view, args.num_features, EVAL_DRAWS,
                                 torch.Generator(dev).manual_seed(1),
                                 sample_x0=False)
    ck.reset_launch_counts()
    ll, mse = (float(v) for v in scorer(view, noise))  # first call, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EVAL_REPEATS):
        float(scorer(view, noise)[0])
    seconds = (time.perf_counter() - t0) / EVAL_REPEATS
    launches = dict(ck.LAUNCHES)
    print(f"test split: {ys_true.shape[0]} sequences x {ys_true.shape[1]} "
          f"steps, {EVAL_DRAWS} draws, solver {eval_cfg.solver}; LL {ll:.6f} "
          f"MSE {mse:.6f}; {seconds:.4f} s per eval; launches {launches}")
    check(math.isfinite(ll) and math.isfinite(mse), "non-finite test LL or MSE")
    # below 256 rows per draw the rhs is the batched plain evaluation, as
    # under the JAX package's vmap
    check(launches["fused_rhs_fwd"] == 0, "the eval rhs took the kernel at "
          f"{ys_true.shape[0]} rows per draw")

    with torch.no_grad():
        zs = predict(view, noise, torch.as_tensor(ts, device=dev), eval_cfg,
                     x0=torch.as_tensor(x0, device=dev))
        ys_pred = project(make_projector(projector, dev), zs)
        var = view.likelihood.variance
        d_ll, d_mse = (float(v) for v in mixture_summary_device(
            torch.as_tensor(ys_true, device=dev), ys_pred, var))
    h_ll, h_mse = compute_summary(ys_true, ys_pred.cpu().numpy(),
                                  var.cpu().numpy())
    print(f"  predictions {tuple(ys_pred.shape)}: device LL {d_ll:.6f} MSE "
          f"{d_mse:.6f}, host LL {h_ll:.6f} MSE {h_mse:.6f}")
    for name, dv, hv in (("LL", d_ll, h_ll), ("MSE", d_mse, h_mse)):
        check(abs(dv - hv) <= 1e-4 * abs(hv),
              f"device {name} differs from the host metric")
    check(abs(ll - d_ll) <= 1e-4 * abs(d_ll) and abs(mse - d_mse) <= 1e-4 * abs(d_mse),
          "the scorer differs from predict -> project -> metric")
    return dict(ll=ll, mse=mse, host_ll=h_ll, host_mse=h_mse,
                seconds_per_eval=seconds, draws=EVAL_DRAWS,
                solver=eval_cfg.solver)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="after the timed steps, profile this many more "
                             "train steps (torch.profiler); 0 = off")
    opts = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    card = device_phase()
    import torch
    dev = torch.device("cuda")
    build_seconds = build_phase()
    gemm = gemm_ms(dev)
    kernels, err_scaled_long_span, resources = kernel_phase(dev, gemm)
    rk4_rows, rk4_resources = rk4_kernel_phase(dev, gemm)
    kernels.update(rk4_rows)
    resources.update(rk4_resources)
    wide_rows, wide_resources = gram_wide_kernel_phase(dev, gemm)
    kernels.update(wide_rows)
    resources.update(wide_resources)
    train, launches, _, _ = train_phase(dev, "official", opts.profile_steps)
    train["reject_fallback_max_abs_err"], train["accept_decisions"] = \
        reject_phase(dev)
    heuristic, heuristic_launches, _, _ = train_phase(dev, "official_heuristic")
    fast, fast_launches, fast_args, fast_params = train_phase(
        dev, "fast", opts.profile_steps)
    evaluation = eval_phase(dev, fast_args, fast_params)
    (kernels["dopri5_attempt_draws"], draws_details,
     predict_launches) = draws_attempt_phase(dev)
    kernels["draws_commit"], commit_details = draws_commit_phase(dev)
    draw_rows, draw_details = draw_solve_phase(dev)
    kernels.update(draw_rows)
    entropy_rows, entropy_details = state_entropy_phase(dev)
    kernels.update(entropy_rows)
    draw_details.update(entropy_details)
    driver, driver_launches = driver_phase(evaluation["ll"])
    with tempfile.TemporaryDirectory() as tmp:
        experiments, exp_launches, exp_rk4_launches = experiments_phase(tmp)
        (scale_solvers, scale_rows, scale_launches, adjoint_launches,
         multistep_launches) = scale_solvers_phase(dev, tmp,
                                                   opts.profile_steps)
    captured = captured_step_phase(dev)
    vdp, vdp_params, vdp_data = vdp_phase(dev, "default", opts.profile_steps)
    vdp_golden, _, _ = vdp_phase(dev, "golden", opts.profile_steps)
    field, field_launches, e_gram = field_phase(dev, vdp_params, vdp_data,
                                                fast_args, fast_params)
    with tempfile.TemporaryDirectory() as tmp:
        plots_fhn_node, fhn_rows, p7e = plots_fhn_node_phase(
            dev, tmp, vdp_params, vdp_data, fast_params)
    with tempfile.TemporaryDirectory() as tmp:
        mesh, mesh_launches = mesh_phase(tmp)
    kernels["rbf_gram"] = (max(kernels["rbf_gram"][0], e_gram),
                           *kernels["rbf_gram"][1:])
    path_launches = {"official": launches, "fast": fast_launches,
                     "official_heuristic": heuristic_launches,
                     "driver": driver_launches,
                     "experiments": exp_launches,
                     "experiments_rk4": exp_rk4_launches,
                     "scale": scale_launches, "adjoint": adjoint_launches,
                     "field": field_launches, "wide_ab": wide_ab_phase(),
                     "predict": predict_launches, "draw": launches,
                     "entropy": launches}

    phase("result")
    gemm_after = gemm_ms(dev)
    gemm_ratios = {name: row[1] / gemm for name, row in kernels.items()}
    print("ratio to the yardstick: " + ", ".join(
        f"{name} {r:.4f}" for name, r in gemm_ratios.items()))
    rows = []
    for name, (err, ms, pms, bms, by) in kernels.items():
        # launches from the path that runs the kernel, counted from 0
        path = next(path_launches[p] for p, names in MAIN_PATH_KERNELS.items()
                    if name in names)
        check(path[name] > 0, f"{name} never launched on its main path")
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": path[name],
               "max_abs_err": err, "ms": ms, "plain_ms": pms,
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        if name in scale_rows:  # the attempt kernels at the scale step too
            s_err, s_ms, s_pms, s_bms, s_by = scale_rows[name]
            row["scale"] = {"rows": SCALE_ROWS, "num_inducing": 256,
                            "launches": scale_launches[name],
                            "max_abs_err": s_err, "ms": s_ms,
                            "plain_ms": s_pms, "bound_ms": s_bms,
                            "bound_by": s_by}
        if name in fhn_rows:  # the attempt kernels at the FHN default too
            f_err, f_ms, f_pms, f_bms, f_by = fhn_rows[name]
            row["fhn"] = {"rows": FHN_ROWS, "num_inducing": FHN_INDUCING,
                          "launches": p7e["fhn"][name], "max_abs_err": f_err,
                          "ms": f_ms, "plain_ms": f_pms, "bound_ms": f_bms,
                          "bound_by": f_by}
        if name in mesh_launches:  # the segment kernels under --mesh too
            row["mesh"] = mesh_launches[name]
        for preset in ("official", "fast", "scale"):
            got = captured[preset].get("captured", {}).get("launches", {})
            if name in got:  # in CAPTURE_STEPS captured steps (phase 7g)
                row.setdefault("captured", {})[preset] = got[name]
        if name in ("fused_rhs_fwd", "fused_rhs_bwd"):
            row["launches_per_step"] = {
                "adjoint": adjoint_launches[name],
                **{k: v[name] for k, v in multistep_launches.items()},
                "fhn_interpolation_shooting": p7e["interp"][name] / TINY_ITERS}
        if name == "dopri5_attempt_draws":
            row["shapes"] = draws_details
        if name == "draws_commit":
            row["shapes"] = commit_details
        if name in draw_details:
            row["library_ms"] = draw_details[name]["library_ms"]
            row["shapes"] = draw_details[name]["shapes"]
        if name == "rbf_gram":
            row["launches_per_run"] = {"plots_grid_conditional":
                                       p7e["grid"][name], **{
                                           f"{k}_twin": v for k, v in
                                           p7e["gram_per_run"].items()}}
        rows.append(row)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_seconds": build_seconds,
                   "gemm_ms": [gemm, gemm_after], "gemm_ratios": gemm_ratios,
                   "err_scaled_long_span_max_abs_err": err_scaled_long_span,
                   "kernels": rows, "kernel_resources": resources,
                   "train": train, "train_fast": fast,
                   "train_official_heuristic": heuristic,
                   "eval_fast": evaluation, "time_to_nll": driver,
                   "experiments": experiments,
                   "scale_and_solvers": scale_solvers,
                   "captured_step": captured, "vdp": vdp,
                   "vdp_golden": vdp_golden, "field": field,
                   "plots_fhn_neural_ode": plots_fhn_node, "mesh": mesh,
                   "wall_seconds": time.perf_counter() - t_start},
                  f, indent=1)
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: no result line, non-zero exit
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
