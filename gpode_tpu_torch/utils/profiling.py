"""Tracing and NaN-debugging hooks. Counterpart of
`gpode_tpu/utils/profiling.py`.

`trace` records a `torch.profiler` trace (CPU operators, and the device's
kernels and copies when a CUDA card is present) and writes it as a gzipped
Chrome trace under `log_dir`; `gpode_tpu_torch/scripts/analyze_trace.py`
reads it, as do Perfetto and chrome://tracing. Throughput (steps/s, rhs
evals/s) is reported by the Trainer's log lines and by `scripts/bench.py`.

`span(name)` marks a part of the program in such a trace: the program's
spans (`SPANS`) sit at the boundaries of the captured train step, the eager
step's phases, the adaptive solve and the prediction request. With a
profiler active a span is a `record_function` range, which the profiler
writes on the host track on the same clock as the device's kernels and
copies, so an idle gap on the device can be put down to the innermost span
open on the host. With no profiler active a span is one shared no-op
context: `record_function` costs microseconds a call even then, which the
hot path does not pay. Spans are kept in the profiler's memory and written
with the rest of its trace.

A traced span pays the profiler's own cost (a graph launch under CUPTI
takes ten times its untraced time), so the host's time in a few spans is
also kept untraced: `clocked(name)` is `span(name)` under a profiler, and
with none it adds the call and its seconds on the host's clock to
`UNTRACED[name]` (two `perf_counter` reads).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# every span the program records, by the path that records it
SPANS = (
    # the captured train step (train/graph_step.py)
    "gpode.step",                 # one call of the step
    "gpode.step.copy_in",         # the inputs copied into the static buffers
    "gpode.step.replay",          # one graph's replay: the host's launch
    "gpode.step.accept_read",     # the host read of the attempt's error RMS
    "gpode.step.eager",           # an eager step: the warm-up, a reject
    # the eager step's phases (train/trainer.py, models/)
    "gpode.draw",                 # the posterior draw (models/gp.py)
    "gpode.states",               # the shooting states' sample
    "gpode.segment_solve",        # the segments' solve (models/shooting.py)
    "gpode.elbo",                 # the ELBO's terms after the solve
    "gpode.backward",
    "gpode.adam",
    # the prediction request and the adaptive solve
    "gpode.predict",              # one scorer call (train/evaluation.py)
    "gpode.solve",                # one `ops/ode.odeint` call
    "gpode.solve.attempt",        # one attempt of the adaptive dopri5 loop
    "gpode.solve.error_read",     # the attempt's host read of its error norm
    "gpode.solve.replay",         # a captured attempt's replay (models/flow.py)
)
# the spans whose untraced calls are counted and timed: {name: [calls, s]}
UNTRACED = {name: [0, 0.0] for name in (
    "gpode.step", "gpode.step.replay", "gpode.solve.attempt",
    "gpode.solve.error_read", "gpode.solve.replay")}
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` (one of `SPANS`) in an active profiler's
    trace, or the shared no-op context when no profiler is active."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


class _Clock:
    __slots__ = ("total", "t0")

    def __init__(self, total: list):
        self.total = total

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.total[0] += 1
        self.total[1] += time.perf_counter() - self.t0


def clocked(name: str):
    """`span(name)` under a profiler; with none, a context that adds its
    call and host seconds to `UNTRACED[name]`."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _Clock(UNTRACED[name])


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a trace of the body; on exit write
    `<log_dir>/<host>.<pid>.<ms>.trace.json.gz` (the file name is set on
    the profiler as `trace_path`).

        with profiling.trace("results/trace"):
            step(...)

    CUDA activity is recorded when `torch.cuda.is_available()`; the body
    should end in `torch.cuda.synchronize()` so its kernels land inside."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    name = (f"{socket.gethostname()}.{os.getpid()}."
            f"{int(time.time() * 1e3)}.trace.json.gz")
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, name)
    prof.export_chrome_trace(prof.trace_path)


def enable_nan_debugging(enabled: bool = True):
    """Autograd anomaly mode: a backward that produces NaN raises, naming
    the forward operator that made it (the counterpart of JAX's
    `jax_debug_nans`)."""
    torch.autograd.set_detect_anomaly(enabled)
