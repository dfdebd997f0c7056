"""Tracing and NaN-debugging hooks. Counterpart of
`gpode_tpu/utils/profiling.py`.

`trace` records a `torch.profiler` trace (CPU operators, and the device's
kernels and copies when a CUDA card is present) and writes it as a gzipped
Chrome trace under `log_dir`; `gpode_tpu_torch/scripts/analyze_trace.py`
reads it, as do Perfetto and chrome://tracing. Throughput (steps/s, rhs
evals/s) is reported by the Trainer's log lines and by `scripts/bench.py`.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
from torch.profiler import ProfilerActivity, profile


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
