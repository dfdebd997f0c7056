"""Traffic kind `predict`: a closed loop of validation requests against fixed
parameters, as a training run makes one every few hundred steps. A request
draws `draws` posterior field draws' noise from its own device generator
(seeded from the run's seed and the request's index), runs the program's
scorer over the `split` (predictions from the observed first states, one
batched adaptive solve, projected to the data space, scored as a Gaussian
mixture) and ends in the host read of its log-likelihood and MSE. Its
latency runs from the generator's creation to that read.

After the window the reference scores `checked_requests` requests again:
the slowest one and the rest drawn from the seed, each from the same noise.

Workload parameters: `split`, `draws`, `warmup_requests`,
`checked_requests` and `trace_requests`.
"""

from __future__ import annotations

import gc
import itertools
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, inputs, tracing
from benchmark.reference.common import Arith

REQUEST_STREAM, WARMUP_STREAM, CHECK_STREAM = 4, 5, 6


class Setup:
    def __init__(self, cell):
        self.cell = cell
        cfg, dev = cell.config, cell.device
        p = cell.workload["params"]
        self.split, self.draws = p["split"], p["draws"]
        # the data and initial values are the configuration's, the same
        # for every seed: the seed draws the noise of every step or request
        self.data = inputs.load_data(cfg)
        self.values = cell.model.init_values(cfg, self.data, cfg["init_seed"])
        cell.log("data and initial values made")
        self.params = cell.model.build_params(cfg, self.data, self.values, dev)
        self.score = cell.model.predict_scorer(cfg, self.data, self.split, dev)
        self.d = self.data["train_latent"].shape[-1]

    def noise(self, *stream) -> dict:
        gen = torch.Generator(self.cell.device).manual_seed(
            inputs.device_seed(self.cell.seed, *stream))
        return inputs.predict_noise(self.cell.config, self.draws, self.d, gen,
                                    self.cell.device)

    def request(self, *stream):
        ll, mse = self.score(self.params, self.noise(*stream))
        return float(ll), float(mse)

    def free_program(self):
        self.params = self.score = None
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, indices, ar: Arith, fault: str | None = None) -> list:
        """The reference's (ll, mse) of the window's requests `indices`."""
        cfg, dev, s = self.cell.config, self.cell.device, self.split
        cast = lambda a: torch.as_tensor(a).to(dev, ar.dtype)  # noqa: E731
        values = {k: cast(v) for k, v in self.values.items()}
        data = {"x0": cast(self.data[f"{s}_latent"][:, 0]),
                "ts": self.data[f"{s}_ts"].astype(np.float64),
                "ys": cast(self.data[f"{s}_full"]),
                "projector": {k: cast(v) for k, v in self.data["projector"].items()}}
        out = []
        for i in indices:
            noise = {k: cast(v) for k, v in self.noise(REQUEST_STREAM, i).items()}
            with torch.no_grad():
                out.append(self.cell.reference.predict_scores(
                    values, noise, data, cfg, ar, fault=fault))
        return out


def calibrate_seed(cell, control: Arith, with_faults: bool) -> list:
    """[(source, readings)] of one seed without a measured window: the
    program's first `checked_requests` requests against the reference, and
    with `with_faults` the control's and each planted fault's, in the
    reference put in the program's place."""
    setup = Setup(cell)
    k = cell.workload["params"]["checked_requests"]
    answers = [setup.request(REQUEST_STREAM, i) for i in range(k)]
    setup.free_program()
    idx = list(range(k))
    ref = setup.reference(idx, Arith())
    rows = [("program", compare.predict_readings(answers, ref))]
    if with_faults:
        rows.append(("control", compare.predict_readings(
            setup.reference(idx, control), ref)))
        for fault in ("half_batch", "answer"):
            rows.append((fault, compare.predict_readings(
                setup.reference(idx, Arith(), fault=fault), ref)))
    return rows


def run(cell) -> dict:
    setup = Setup(cell)
    p = cell.workload["params"]
    for i in range(p["warmup_requests"]):
        setup.request(WARMUP_STREAM, i)
    cell.sync()
    setup_s = time.perf_counter() - cell.t_start

    answers, latencies = [], []
    deadline = time.perf_counter() + cell.seconds
    while True:
        t0 = time.perf_counter()
        answers.append(setup.request(REQUEST_STREAM, len(answers)))
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if t1 >= deadline:
            break
    n = len(answers)
    failed = sum(not (math.isfinite(a) and math.isfinite(b)) for a, b in answers)
    lat_ms = np.asarray(latencies) * 1e3
    cell.log(f"window: {n} requests; latency ms min {lat_ms.min()!r} median "
             f"{np.median(lat_ms)!r} p95 {np.percentile(lat_ms, 95)!r} max "
             f"{lat_ms.max()!r}")

    ctx = cell.context(shapes={}, wall_s_per_unit=float(np.mean(latencies)),
                       latencies_ms=lat_ms)
    if cell.trace and cell.device.type == "cuda":
        count = itertools.count(1000)

        def traced():
            with record_function("bench.request"):
                setup.request(WARMUP_STREAM, next(count))

        ctx.trace = tracing.profile_units(traced, p["trace_requests"])
    peak = cell.memory_peak()
    setup.free_program()

    k = min(p["checked_requests"], n)
    slowest = int(np.argmax(latencies))
    others = [i for i in range(n) if i != slowest]
    picked = [slowest] + sorted(int(i) for i in inputs.rng(cell.seed, CHECK_STREAM)
                                .choice(others, k - 1, replace=False))
    t_ref = time.perf_counter()
    readings = compare.predict_readings([answers[i] for i in picked],
                                        setup.reference(picked, Arith()))
    cell.log(f"reference: {k} requests in {time.perf_counter() - t_ref!r} s")
    return {"e2e": {"setup_s": setup_s,
                    "predict_ms_p95": float(np.percentile(lat_ms, 95))},
            "attempted": n, "failed": failed, "readings": readings,
            "memory_peak_bytes": peak, "context": ctx}
