"""Traffic kind `train`: a closed loop of back-to-back train steps of the
program's step object, each on fresh noise from the run's device generator.

Set-up builds the step (the program's builders, the benchmark's initial
values, `make_step` over the model's loss and Adam), drives it through the
compared steps and `warmup_steps` more, so that every kernel is built and
a captured step is captured before the window. The compared steps reach
past the capture: a captured step runs its first steps eagerly, captures
at step `replay_from` and replays from there, so that the later compared
steps are replays with their inputs copied in, as in the window. The
window then runs steps until `--seconds` have passed and ends in a host
read of the last step's loss. After it, the reference follows the
compared steps from the same initial values and noise.

Workload parameters: `compared_steps`, `replay_from` (the first step that
the captured step replays; its planted faults' start), `warmup_steps`,
`sync_steps` and `trace_steps` (units of a `--trace 1` run's sync count
and profile), and `rate_metric` (the end-to-end metric that the step rate
is reported as; `train_steps_per_s` when not given).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, inputs, tracing
from benchmark.reference.common import Arith, train as reference_train


class Setup:
    """The step object driven through the compared steps, with what the
    comparison needs of them."""

    def __init__(self, cell):
        self.cell = cell
        cfg, dev, model = cell.config, cell.device, cell.model
        # the data and initial values are the configuration's, the same
        # for every seed: the seed draws the noise of every step or request
        self.data = inputs.load_data(cfg)
        self.values = model.init_values(cfg, self.data, cfg["init_seed"])
        self.ys, self.ts, self.shapes = model.train_batch(self.data, dev)
        cell.log("data and initial values made")
        self.params = model.build_params(cfg, self.data, self.values, dev)
        self.step = model.train_step(cfg, self.params, self.ys, self.ts)
        self.gen = torch.Generator(dev).manual_seed(inputs.device_seed(cell.seed, 3))
        b1 = cfg["optimizer"]["b1"]
        n = cell.workload["params"]["compared_steps"]
        self.noises, losses, moments = [], [], []
        for i in range(n):
            noise = self.noise()
            self.noises.append({k: v.clone() for k, v in noise.items()})
            losses.append(self.step(noise).loss.detach())
            if i in (0, n - 2, n - 1):
                moments.append(self.step.first_moment())
        after = {k: p.detach().clone() for k, p in self.params.named_parameters()}
        cell.log(f"compared steps run; step counters {self.step.stats()}")
        # a step's gradient as Adam took it, from its first moment m_t =
        # b1 m_(t-1) + (1 - b1) g_t: the first step's, and the last's
        first, before_last, last = moments[0], moments[-2], moments[-1]
        self.program = {
            "losses": [float(x) for x in losses],
            "grads": {k: m / (1.0 - b1) for k, m in first.items()},
            "grads_last": {k: (last[k].double() - b1 * before_last[k].double())
                           / (1.0 - b1) for k in last},
            "change": {k: after[k].double().cpu()
                       - torch.as_tensor(self.values[k]).double()
                       for k in after}}

    def noise(self) -> dict:
        return self.cell.model.train_noise(self.cell.config, self.shapes,
                                           self.gen, self.cell.device)

    def unit(self):
        return self.step(self.noise())

    def traced_unit(self):
        with record_function("bench.step"):
            return self.step(self.noise())

    def free_program(self):
        """Drop the program's state before the reference runs."""
        self.step = self.params = None
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, ar: Arith, fault: str | None = None) -> dict:
        """The reference's losses, first and last gradients and change over
        the compared steps, from the same values and noise."""
        cfg, dev = self.cell.config, self.cell.device
        ref = self.cell.reference
        cast = lambda a: torch.as_tensor(a).to(dev, ar.dtype)  # noqa: E731
        values = {k: cast(v) for k, v in self.values.items()}
        data = {"ys": cast(self.ys.cpu()), "ts": self.ts.cpu().double()}
        noises = [{k: cast(v) for k, v in n.items()} for n in self.noises]
        opt = cfg["optimizer"]
        losses, grads, last = reference_train(
            lambda v, nz: ref.train_loss(v, nz, data, cfg, ar, fault=fault),
            values, noises, opt, opt["frozen"], fault=fault,
            replay_from=self.cell.workload["params"].get("replay_from"))
        cpu = lambda g: {k: v.double().cpu() for k, v in g.items()}  # noqa: E731
        return {"losses": losses, "grads": cpu(grads[0]),
                "grads_last": cpu(grads[-1]),
                "change": {k: (last[k] - values[k]).double().cpu() for k in values}}


def calibrate_seed(cell, control: Arith, with_faults: bool) -> list:
    """[(source, readings)] of one seed without a measured window: the
    program's compared steps against the reference, and with `with_faults`
    the control's and each planted fault's, in the reference put in the
    program's place (a step that leaves its state unchanged reads 1 on
    `change` by construction and needs no run)."""
    setup = Setup(cell)
    setup.free_program()
    ref = setup.reference(Arith())
    rows = [("program", compare.train_readings(setup.program, ref))]
    if with_faults:
        rows.append(("control", compare.train_readings(setup.reference(control), ref)))
        faults = ["half_batch"]
        if cell.workload["params"].get("replay_from"):
            faults += ["stale_noise", "stuck_count"]
        for fault in faults:
            rows.append((fault, compare.train_readings(
                setup.reference(Arith(), fault=fault), ref)))
    return rows


def run(cell) -> dict:
    setup = Setup(cell)
    for _ in range(cell.workload["params"]["warmup_steps"]):
        setup.unit()
    cell.sync()
    setup_s = time.perf_counter() - cell.t_start

    losses, stamps, nfe = [], [], 0
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    while True:
        terms = setup.unit()
        losses.append(terms.loss.detach())
        nfe += terms.nfe
        stamps.append(time.perf_counter())
        if stamps[-1] >= deadline:
            break
    float(losses[-1])                       # the window ends in a host read
    window_s = time.perf_counter() - t0
    steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    gaps = np.diff([t0] + stamps) * 1e3
    cell.log(f"window: {steps} steps in {window_s!r} s; host ms between step "
             f"returns: quartiles {np.percentile(gaps, [25, 50, 75]).tolist()}, "
             f"max {gaps.max()!r}; step counters {setup.step.stats()}")

    p = cell.workload["params"]
    ctx = cell.context(shapes=setup.shapes,
                       wall_s_per_unit=window_s / steps, nfe_per_unit=nfe / steps)
    if cell.trace and cell.device.type == "cuda":
        ctx.syncs_per_unit = tracing.syncs_per_unit(setup.unit, p["sync_steps"])
        ctx.trace = tracing.profile_units(setup.traced_unit, p["trace_steps"])
    peak = cell.memory_peak()
    setup.free_program()

    t_ref = time.perf_counter()
    readings = compare.train_readings(setup.program, setup.reference(Arith()))
    cell.log(f"reference: {time.perf_counter() - t_ref!r} s")
    rate = p.get("rate_metric", "train_steps_per_s")
    return {"e2e": {"setup_s": setup_s, rate: steps / window_s},
            "attempted": steps, "failed": failed, "readings": readings,
            "memory_peak_bytes": peak, "context": ctx}
