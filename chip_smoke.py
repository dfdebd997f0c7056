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
  3. kernels: on the inputs of the official MoCap-09 train step (N=3000
     segment rows, Din=D=5, M=100 inducing points, S=256 features) holds
     each kernel against its plain PyTorch version — forward rtol 1e-4
     (atol 1e-5 * max|ref|), cotangents atol 1e-3 * max|g| — and times the
     kernel, the plain version and the least time the card could take;
  4. train: the official-recipe shooting train step (dopri5, whole-span
     first step, 5 MC draws, no frozen mask as in bench.py): the step-0 loss
     against the same step through the plain path at rtol 1e-4, then 3
     warm-up and 20 timed steps with every launch counter set to 0 just
     before them;
  5. reject fallback: `flow_forward` of the bench draw over a span whose
     whole-span attempt is rejected, through the kernels and through the
     plain path, held equal (rtol 1e-4);
  6. a `{"kernels": [...]}` line, a copy of all results in
     chiprun_out/chip_smoke.json, and as the last line
     `{"ok": true, "device": {...}}`.

`--profile-steps N` adds a torch.profiler breakdown of N more train steps
after phase 4 (device time by operator, device busy share).
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

NAMES = ("x", "z", "lengthscales", "variance", "omega", "phase", "weights", "nu")
SOURCES = {"fused_rhs_fwd": "gpode_tpu_torch/csrc/fused_rhs.cu",
           "fused_rhs_bwd": "gpode_tpu_torch/csrc/fused_rhs.cu",
           "fused_dopri5_attempt_fwd": "gpode_tpu_torch/csrc/fused_dopri5.cu",
           "fused_dopri5_attempt_bwd": "gpode_tpu_torch/csrc/fused_dopri5.cu"}
REPLACES = {
    "fused_rhs_fwd": "gpode_tpu/ops/pallas_kernels.py:252",
    "fused_rhs_bwd": "gpode_tpu/ops/pallas_kernels.py:467",
    "fused_dopri5_attempt_fwd": "gpode_tpu/ops/pallas_kernels.py:979",
    "fused_dopri5_attempt_bwd": "gpode_tpu/ops/pallas_kernels.py:1027",
}
MAIN_PATH_KERNELS = ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd")


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
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main_path_inputs(dev):
    """The official step's kernel inputs: the flattened shooting states and
    one posterior draw of the bench problem."""
    import torch
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.models.shooting import sample_step_noise, stack_segments
    from gpode_tpu_torch.models.states import sample_shooting_states
    from gpode_tpu_torch.train.bench_setup import build_bench_problem

    args, params, ys, ts = build_bench_problem(device=dev)
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


def compare_fwd(got, ref, what):
    import torch
    got, ref = got.detach(), ref.detach()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = bool(torch.all((got - ref).abs() <= 1e-4 * ref.abs() + 1e-5 * scale))
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
    ms_b = cuda_ms(lambda: ck._launch_rhs_bwd(xd, g, ops, *dims))
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
        _, _, xs = ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims)
        ms_df = cuda_ms(lambda: ck._launch_dp_fwd(xd, dt, rtol, atol, ops, *dims))
        ms_dfp = cuda_ms(lambda: ck.dopri5_attempt_plain(
            xd, dt, *[p.detach() for p in params], rtol, atol))
    ms_db = cuda_ms(lambda: ck._launch_dp_bwd(xs, g, dt, ops, *dims))
    ms_dbp = cuda_ms(lambda: torch.autograd.grad(x5_p, inputs, g, retain_graph=True))
    out["fused_dopri5_attempt_fwd"] = (max(e_dfwd, e_x5_long), ms_df, ms_dfp, *bound(
        7 * rhs_ops(n, din, d, m, s), 4 * (n * din + pf + 2 * n * d + 6 * n * din)))
    out["fused_dopri5_attempt_bwd"] = (e_dbwd, ms_db, ms_dbp, *bound(
        6 * vjp_ops(n, din, d, m, s), 4 * (6 * n * din + n * d + pf + n * din + pf)))

    for name, (err, ms, pms, bms, by) in out.items():
        print(f"{name}: {ms:.4f} ms kernel, {pms:.4f} ms plain, bound "
              f"{bms:.4f} ms ({by}), max_abs_err {err:.3e}")
    return out, e_err_long


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


def train_phase(dev, profile_steps=0):
    phase("train")
    import torch
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.ops import cuda_kernels as ck
    from gpode_tpu_torch.train.bench_setup import build_bench_problem
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(device=dev)
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
    for name in MAIN_PATH_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    if profile_steps:
        profile_train_steps(step, lambda: sample_step_noise(
            params, args.num_features, args.num_samples, gen), ys, ts,
            profile_steps)
    return dict(loss_first=losses[0], loss_last=losses[-1], step0_kernels=lk,
                step0_plain=lp, steps_per_sec=sps, accepted=accepted,
                rejected=rejected, nfe=nfe, peak_bytes=peak), launches


def profile_train_steps(step, make_noise, ys, ts, n_steps):
    """Device time per step by operator (torch.profiler), the device's busy
    share of the wall time, and the full table in
    chiprun_out/chip_smoke_profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"profile ({n_steps} steps)")
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
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


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
    kernels, err_scaled_long_span = kernel_phase(dev)
    train, launches = train_phase(dev, opts.profile_steps)
    train["reject_fallback_max_abs_err"] = reject_phase(dev)

    phase("result")
    rows = []
    for name, (err, ms, pms, bms, by) in kernels.items():
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_seconds": build_seconds,
                   "err_scaled_long_span_max_abs_err": err_scaled_long_span,
                   "kernels": rows, "train": train}, f, indent=1)
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
