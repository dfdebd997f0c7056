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
     is held at 1 substep (the fast step) and at 3, its backward also at
     M=256 (the `m256_fast` shape) and for bit-identical reruns. `rbf_gram`
     is held at the same N=3000, M=100, at M=256 and at N=77 (a ragged last
     tile); the three wide-layout rhs functions against their plain versions
     at N=2995 and 3000, M=100 and 256, the wide backward also for
     bit-identical reruns. Bounds read the function,
     not the formulation: the wide kernels take the per-dim rhs's counts.
     The dopri5 attempt's backward is held and timed at M=256 too, the rk4
     segment's timed at 3 substeps and at M=256. For every backward kernel
     it prints registers and spill bytes (the build's ptxas record), block
     size, dynamic shared memory and resident blocks and warps per SM (the
     occupancy query); the two segment backward kernels must be free of
     spills and take at most 3.7x (dopri5) and 2.45x (rk4) one fused_rhs
     backward launch of this call;
  4. train: the official-recipe shooting train step (dopri5, whole-span
     first step, 5 MC draws, no frozen mask as in bench.py): the step-0 loss
     against the same step through the plain path at rtol 1e-4, then 3
     warm-up and 20 timed steps with every launch counter set to 0 just
     before them;
  5. reject fallback: `flow_forward` of the bench draw over a span whose
     whole-span attempt is rejected, through the kernels and through the
     plain path, held equal (rtol 1e-4);
  6. fast train: the same for the `fast` preset (rk4, one step per
     interval), which must launch each rk4 segment kernel once per step and
     neither the dopri5 attempt nor the standalone rhs; prints its step-0
     loss beside the official step's on the same params and noise;
  7. eval: the projected scorer (128-draw posterior predictive, test LL and
     MSE in the 50-D data space of the MoCap-09 test split) on the params
     after phase 6, its device metric held against the host metric on the
     same predictions (rtol 1e-4);
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
 11. a `{"kernels": [...]}` line, a copy of all results in
     chiprun_out/chip_smoke.json, and as the last line
     `{"ok": true, "device": {...}}`.

`--profile-steps N` adds a torch.profiler breakdown of N more train steps
after phases 4, 6 and 8 (device time by operator, device busy share).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM3 bandwidth. Bounds count one operation per flop or transcendental.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TRAIN_WARMUP, TRAIN_STEPS = 3, 20
KERNEL_ITERS = 50
EVAL_DRAWS, EVAL_REPEATS = 128, 3

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
           "fused_rhs_wide_bwd": "gpode_tpu_torch/csrc/fused_rhs_wide.cu"}
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
}
# The two segment backward kernels before their redesign (PERF.md; NVIDIA
# H100 80GB HBM3, 700.00 W): device ms per launch and the ratio to one
# fused_rhs backward launch of the same call. Held here: the ratio now is at
# most `limit` (1.4x faster than before, whatever card the call lands on).
EARLIER = {"fused_dopri5_attempt_bwd": dict(ms=0.8809, ratio=5.17, limit=3.7),
           "fused_rk4_segment_bwd": dict(ms=0.5846, ratio=3.43, limit=2.45)}

# the kernels each path must launch, and those a train path must not
MAIN_PATH_KERNELS = {
    "official": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd"),
    "fast": ("fused_rk4_segment_fwd", "fused_rk4_segment_bwd"),
    "field": ("rbf_gram",),
    "wide_ab": ("fused_rhs_fwd", "fused_rhs_bwd", "fused_rhs_wide_fwd",
                "fused_rhs_wide2_fwd", "fused_rhs_wide_bwd"),
}
OFF_PATH_KERNELS = {
    "official": (),
    "fast": ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd",
             "fused_rhs_fwd", "fused_rhs_bwd"),
}


def phase(name):
    print(f"== {name}", flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# work counts for the bounds
# ---------------------------------------------------------------------------

def rhs_ops(n, din, d, m, s):
    """One rhs evaluation: flops plus cos/exp."""
    return n * d * (s * (2 * din + 3) + m * (3 * din + 3)) + n * d * (s + m)


def vjp_ops(n, din, d, m, s):
    """One rhs VJP (csrc/rhs_tile.cuh rhs_vjp_row_dim): per feature 6*Din+13
    flops and sin+cos, per inducing point 14*Din+9 flops and one exp."""
    return n * d * (s * (6 * din + 13) + m * (14 * din + 9)) + n * d * (2 * s + m)


def gram_ops(n, din, d, m):
    """One dimwise Gram: 3*Din+3 flops and one exp per output element."""
    return n * d * m * (3 * din + 3) + n * d * m


def param_floats(din, d, m, s):
    return m * din + d * din + d + din * s * d + 2 * s * d + d * m


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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


def kernel_phase(dev):
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
        ms_f = cuda_ms(lambda: ck._launch_rhs_fwd(xd, ops, *dims))
        ms_fp = cuda_ms(lambda: ck.fused_rhs_plain(xd, *[p.detach() for p in params]))
    ms_b = cuda_ms(lambda: ck._launch_rhs_bwd_packed(xd, g, ops, *dims))
    ms_bp = cuda_ms(lambda: torch.autograd.grad(f_p, inputs, g, retain_graph=True))
    out["fused_rhs_fwd"] = (e_fwd, ms_f, ms_fp, *bound(
        rhs_ops(n, din, d, m, s), 4 * (n * din + pf + n * d)))
    out["fused_rhs_bwd"] = (e_bwd, ms_b, ms_bp, *bound(
        vjp_ops(n, din, d, m, s), 4 * (n * din + n * d + pf + n * din + pf)))
    resources = {"fused_rhs_bwd": print_backward_resources(
        "fused_rhs_bwd", ck.rhs_bwd_occupancy(n, *dims, dev))}

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
        _, _, xs = ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims)
        ms_df = cuda_ms(lambda: ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims))
        ms_dfp = cuda_ms(lambda: ck.dopri5_attempt_plain(
            xd, dt, *[p.detach() for p in params], rtol, atol))
    ms_db = cuda_ms(lambda: ck._launch_dp_bwd(xs, g, dt, ops, *dims))
    ms_dbp = cuda_ms(lambda: torch.autograd.grad(x5_p, inputs, g, retain_graph=True))
    out["fused_dopri5_attempt_fwd"] = (max(e_dfwd, e_x5_long), ms_df, ms_dfp, *bound(
        7 * rhs_ops(n, din, d, m, s), 4 * (n * din + pf + 2 * n * d + 6 * n * din)))
    first = ck._launch_dp_bwd(xs, g, dt, ops, *dims)
    second = ck._launch_dp_bwd(xs, g, dt, ops, *dims)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "two fused_dopri5_attempt backward runs differ")
    print("  fused_dopri5_attempt_bwd: two runs bit-identical")

    # the backward at M=256 (the m256 shape): held and timed
    inputs256, dt256, args256, _, _ = main_path_inputs(dev, "m256")
    m256 = inputs256[1].shape[0]
    check(m256 == 256, "the m256 preset has not M=256")
    x5_k, _ = ck.fused_dopri5_attempt(inputs256[0], dt256, *inputs256[1:],
                                      args256.rtol, args256.atol)
    x5_p, _, xs256 = ck.dopri5_attempt_plain(inputs256[0], dt256, *inputs256[1:],
                                             args256.rtol, args256.atol)
    e_dbwd = max(e_dbwd, compare_grads(
        torch.autograd.grad(x5_k, inputs256, g),
        torch.autograd.grad(x5_p, inputs256, g), "fused_dopri5_attempt_bwd (M=256)"))
    ops256 = ck._kernel_operands(*[p.detach() for p in inputs256[1:]])
    xs256 = xs256.detach().contiguous()
    ms_db256 = cuda_ms(lambda: ck._launch_dp_bwd(xs256, g, dt256, ops256,
                                                 din, d, m256, s))
    print(f"  fused_dopri5_attempt_bwd at M=256: {ms_db256:.4f} ms per launch")

    out["fused_dopri5_attempt_bwd"] = (e_dbwd, ms_db, ms_dbp, *bound(
        6 * vjp_ops(n, din, d, m, s), 4 * (6 * n * din + n * d + pf + n * din + pf)))

    print_kernel_rows(out)
    geo = ck.segment_bwd_geometry(n, *dims, 6, ck._sms(dev))
    report = print_backward_resources(
        "fused_dopri5_attempt_bwd", ck.segment_bwd_occupancy(6, *dims, geo))
    check_variants_free_of_spills("fused_dopri5_attempt_bwd", 6)
    resources["fused_dopri5_attempt_bwd"] = dict(
        report_redesigned("fused_dopri5_attempt_bwd", ms_db,
                          out["fused_dopri5_attempt_bwd"][3], ms_b, report),
        blocks=geo.blocks, rows_per_block=geo.rows_per_block, ms_m256=ms_db256)
    return out, e_err_long, resources


def long_span_error_check(x, params, rtol, atol):
    """The attempt kernel over the shortest span (0.01 * 1.25^k) whose plain
    error estimate exceeds 1e3, far above its rounding (about 0.1 at
    rtol = atol = 1e-6): err_scaled against the plain version at rtol 1e-3
    with atol 1e-4 * max|ref|. Over such a span the six-stage chain
    amplifies rounding, so x5 is held against the plain version in float64:
    the kernel's error may be at most 4 times the float32 plain version's
    (1e-6 * max|ref| at the least). Returns the max abs errors of x5 (against
    the float32 plain version) and of err_scaled."""
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
        x5_64, _, _ = ck.dopri5_attempt_plain(
            x.double(), dt.double(), *[p.double() for p in params], rtol, atol)
    e_k64 = float((x5_k.double() - x5_64).abs().max())
    e_p64 = float((x5_p.double() - x5_64).abs().max())
    limit = max(4 * e_p64, 1e-6 * float(x5_64.abs().max()))
    print(f"  fused_dopri5_attempt_fwd x5 at dt={span:.5g} vs float64: kernel "
          f"{e_k64:.3e}, plain float32 {e_p64:.3e} (limit {limit:.3e}, "
          f"max|ref| {float(x5_64.abs().max()):.3e})")
    check(math.isfinite(e_k64) and e_k64 <= limit,
          f"fused_dopri5_attempt_fwd x5 at dt={span:.5g} is off beyond rounding")
    err = float((err_k - err_p).abs().max())
    scale = float(err_p.abs().max())
    ok = bool(torch.all((err_k - err_p).abs() <= 1e-3 * err_p.abs() + 1e-4 * scale))
    print(f"  fused_dopri5_attempt_fwd err_scaled at dt={span:.5g}: max_abs_err "
          f"{err:.3e} (max|ref| {scale:.3e})")
    check(ok and math.isfinite(err),
          f"fused_dopri5_attempt_fwd err_scaled disagrees at dt={span:.5g}")
    return float((x5_k - x5_p).abs().max()), err


def rk4_kernel_phase(dev, rhs_bwd_ms):
    """The rk4 segment kernels at the fast step's inputs, at its 1 substep
    and at 3 (the reverse sweep across steps); the backward also at M=256
    (the m256_fast shape) and twice for bit-identical cotangents. The rows'
    times are at 1 substep; the backward is also timed at 3 substeps and at
    M=256. `rhs_bwd_ms`: one fused_rhs backward launch of this call. Returns
    the two kernel rows and the backward's resource report."""
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
        _, xs = ck._launch_rk4_fwd(xd, dt, 1, ops, *dims)
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
    ms_b3 = cuda_ms(lambda: ck._launch_rk4_bwd(xs3, g, dt, 3, ops, *dims))
    print(f"  fused_rk4_segment_bwd at 3 substeps: {ms_b3:.4f} ms per launch")

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
    with torch.no_grad():
        _, xs256 = ck._launch_rk4_fwd(inputs256[0].detach(), dt256, sub256,
                                      ops256, din, d, 256, s)
    ms_b256 = cuda_ms(lambda: ck._launch_rk4_bwd(xs256, g, dt256, sub256, ops256,
                                                 din, d, 256, s))
    print(f"  fused_rk4_segment_bwd at M=256: {ms_b256:.4f} ms per launch")

    pf = param_floats(din, d, m, s)
    out = {
        "fused_rk4_segment_fwd": (e_fwd, ms_f, ms_fp, *bound(
            4 * rhs_ops(n, din, d, m, s), 4 * (n * din + pf + n * d + 4 * n * din))),
        "fused_rk4_segment_bwd": (e_bwd, ms_b, ms_bp, *bound(
            4 * vjp_ops(n, din, d, m, s), 4 * (4 * n * din + n * d + pf + n * din + pf))),
    }
    print_kernel_rows(out)
    geo = ck.segment_bwd_geometry(n, *dims, 4, ck._sms(dev))
    report = print_backward_resources(
        "fused_rk4_segment_bwd", ck.segment_bwd_occupancy(4, *dims, geo))
    check_variants_free_of_spills("fused_rk4_segment_bwd", 4)
    resources = dict(
        report_redesigned("fused_rk4_segment_bwd", ms_b,
                          out["fused_rk4_segment_bwd"][3], rhs_bwd_ms, report),
        blocks=geo.blocks, rows_per_block=geo.rows_per_block,
        ms_3_substeps=ms_b3, ms_m256=ms_b256)
    return out, resources


def print_kernel_rows(out):
    for name, (err, ms, pms, bms, by) in out.items():
        print(f"{name}: {ms:.4f} ms kernel, {pms:.4f} ms plain, bound "
              f"{bms:.4f} ms ({by}), max_abs_err {err:.3e}")


def print_backward_resources(name, report):
    """One backward kernel's registers and spills (the build's ptxas record),
    block size, dynamic shared memory and residency (the occupancy query)."""
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


def check_variants_free_of_spills(name, stages):
    """Every instantiated variant of a segment backward kernel (one per range
    of Din), from the build's ptxas record: the table the launch geometry
    selects from is what was built, and none of it spills."""
    from gpode_tpu_torch.ops import cuda_build
    from gpode_tpu_torch.ops import cuda_kernels as ck
    lib_name, kernel = {6: ("fused_dopri5", "dp_attempt_bwd_kernel"),
                        4: ("fused_rk4", "rk4_bwd_kernel")}[stages]
    built = {k: v for k, v in cuda_build.kernel_resources(lib_name).items()
             if kernel in k}
    for dp, rt, maxt in ck._SEG_BWD_VARIANTS[stages]:
        key = f"{kernel}ILi{dp}ELi{rt}ELi{maxt}EE"
        found = [v for k, v in built.items() if key in k]
        check(len(found) == 1, f"{name}: {len(found)} builds of {key}")
        print(f"  {name} variant <{dp}, {rt}, {maxt}>: {found[0]['registers']} "
              f"registers, spill {found[0]['spill_stores']} B stores / "
              f"{found[0]['spill_loads']} B loads")
        check(found[0]["spill_stores"] == 0 and found[0]["spill_loads"] == 0,
              f"{name} variant <{dp}, {rt}, {maxt}> spills registers")
    check(len(built) == len(ck._SEG_BWD_VARIANTS[stages]),
          f"{name}: {len(built)} variants built, the geometry selects from "
          f"{len(ck._SEG_BWD_VARIANTS[stages])}")


def report_redesigned(name, ms, bound_ms, rhs_bwd_ms, report):
    """A redesigned segment backward against its earlier time, one fused_rhs
    backward launch of this call, and its bound; holds the ratio limit and
    the kernel free of spills."""
    was = EARLIER[name]
    ratio = ms / rhs_bwd_ms
    print(f"{name}: {ms:.4f} ms per launch ({was['ms']:.4f} ms before the "
          f"redesign: {was['ms'] / ms:.2f}x); {ratio:.2f}x one fused_rhs backward "
          f"launch of this call ({rhs_bwd_ms:.4f} ms; {was['ratio']:.2f}x before, "
          f"limit {was['limit']:.2f}x); {100 * bound_ms / ms:.1f}% of its bound "
          f"({bound_ms:.4f} ms)")
    check(ratio <= was["limit"], f"{name} takes {ratio:.2f}x a fused_rhs backward "
          f"launch, over the limit {was['limit']:.2f}x")
    check(report["spill_stores"] == 0 and report["spill_loads"] == 0,
          f"{name} spills registers")
    return dict(ms=ms, earlier_ms=was["ms"], ratio_to_rhs_bwd=ratio,
                earlier_ratio=was["ratio"], bound_share=bound_ms / ms, **report)


def gram_wide_kernel_phase(dev):
    """`rbf_gram` and the three wide-layout rhs kernels at the MoCap-09 step's
    inputs (and the M=256 preset's), each against its plain version on the
    same operands. Times are at N=3000, M=100. Returns the four kernel rows
    and the wide backward's resource report."""
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
        z, ls, var = params[0], params[1], params[2]
        inv_ls = (1.0 / ls).contiguous()
        ms_g = cuda_ms(lambda: ck._launch_rbf_gram(x, z, inv_ls, var))
        ms_gp = cuda_ms(lambda: ck.rbf_gram_plain(x, z, ls, var))
    out["rbf_gram"] = (e_gram, ms_g, ms_gp, *bound(
        gram_ops(n, din, d, m),
        4 * (n * din + m * din + d * din + d + d * n * m)))

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
            errs["fused_rhs_wide2_fwd"] = max(errs["fused_rhs_wide2_fwd"], compare_fwd(
                wr.fused_rhs_wide2(xx, *pp), wr.fused_rhs_wide2_plain(xx, *pp),
                f"fused_rhs_wide2_fwd f ({what})"))
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
        print("  fused_rhs_wide_bwd: two runs bit-identical at every shape")
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
    resources = print_backward_resources(
        "fused_rhs_wide_bwd", wr.wide_bwd_occupancy(din, d, sp, mp))
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
    # one row, far below the 256-row gate: the rhs is the plain path
    check(sum(launches.values()) == 0, "a kernel launched on the 1-row VDP path")
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


def reject_phase(dev):
    """A forced reject on the card: `flow_forward` of the bench draw over the
    shortest span (0.01 * 1.25^k) whose whole-span attempt the plain version
    rejects, through the kernels and through the plain path. Both reject,
    take the same number of attempts, and end at the same state (rtol 1e-4,
    atol 1e-5 * max|ref|)."""
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
    return compare_fwd(x_k, x_p, "reject fallback x(T)")


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

    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
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
                rejected=rejected, nfe=nfe, peak_bytes=peak, **extra), \
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
    kernels = [e for e in events if "CUDA" in str(e.device_type)]
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
    card = device_phase()
    import torch
    dev = torch.device("cuda")
    build_seconds = build_phase()
    kernels, err_scaled_long_span, backward = kernel_phase(dev)
    rk4_rows, backward["fused_rk4_segment_bwd"] = rk4_kernel_phase(
        dev, kernels["fused_rhs_bwd"][1])
    kernels.update(rk4_rows)
    wide_rows, backward["fused_rhs_wide_bwd"] = gram_wide_kernel_phase(dev)
    kernels.update(wide_rows)
    train, launches, _, _ = train_phase(dev, "official", opts.profile_steps)
    train["reject_fallback_max_abs_err"] = reject_phase(dev)
    fast, fast_launches, fast_args, fast_params = train_phase(
        dev, "fast", opts.profile_steps)
    evaluation = eval_phase(dev, fast_args, fast_params)
    vdp, vdp_params, vdp_data = vdp_phase(dev, "default", opts.profile_steps)
    vdp_golden, _, _ = vdp_phase(dev, "golden", opts.profile_steps)
    field, field_launches, e_gram = field_phase(dev, vdp_params, vdp_data,
                                                fast_args, fast_params)
    kernels["rbf_gram"] = (max(kernels["rbf_gram"][0], e_gram),
                           *kernels["rbf_gram"][1:])
    path_launches = {"official": launches, "fast": fast_launches,
                     "field": field_launches, "wide_ab": wide_ab_phase()}

    phase("result")
    rows = []
    for name, (err, ms, pms, bms, by) in kernels.items():
        # launches from the path that runs the kernel, counted from 0
        path = next(path_launches[p] for p, names in MAIN_PATH_KERNELS.items()
                    if name in names)
        check(path[name] > 0, f"{name} never launched on its main path")
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": path[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_seconds": build_seconds,
                   "err_scaled_long_span_max_abs_err": err_scaled_long_span,
                   "kernels": rows, "backward_kernels": backward,
                   "train": train, "train_fast": fast,
                   "eval_fast": evaluation, "vdp": vdp,
                   "vdp_golden": vdp_golden, "field": field}, f, indent=1)
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
