"""What a `--trace 1` run reads besides the clock: the host's synchronising
CUDA calls (sync debug mode), and a `torch.profiler` trace of a few units
of the cell's traffic (steps or requests), reduced to device events, the
device's busy time, the operations that took it and the idle gaps with
what the host was doing in them.

The trace is exported as a Chrome trace into a temporary directory under
`TMPDIR`, read and deleted. Device events are the kernels, copies and sets
on the CUDA streams; annotations on the device tracks repeat their kernels'
time and are left out. Kernels are grouped by source: the port's own (its
`csrc/` entry points), cuBLAS / cuSOLVER, collectives, copies and sets, and
PyTorch's other kernels.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import tempfile
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

PORT_KERNELS = (
    (re.compile(r"\bdp_attempt_(fwd|bwd)_kernel"), "fused_dopri5.cu"),
    (re.compile(r"\brk4_(fwd|bwd)_kernel"), "fused_rk4.cu"),
    (re.compile(r"\bwide_(fwd|bwd|reduce)_kernel"), "fused_rhs_wide.cu"),
    (re.compile(r"\brhs_(fwd|bwd)_kernel"), "fused_rhs.cu"),
    (re.compile(r"\brbf_gram_kernel"), "rbf_gram.cu"),
    (re.compile(r"\bsum_slabs_kernel"), "rhs_tile.cuh"),
)
_BLAS = re.compile(r"gemm|gemv|cublas|cutlass|xmma|trsm|trsv|potrf|potrs|"
                   r"cusolver|syrk|getrf|geqrf|magma", re.I)
_COLLECTIVE = re.compile(r"nccl", re.I)
_COPY = re.compile(r"^(Memcpy|Memset)|memcpy|memset", re.I)


def group_of(name: str, cat: str = "") -> str:
    for pat, source in PORT_KERNELS:
        if pat.search(name):
            return f"port kernels: {source}"
    if "memcpy" in cat or "memset" in cat or _COPY.search(name):
        return "memcpy/memset"
    if _COLLECTIVE.search(name):
        return "collectives"
    if _BLAS.search(name):
        return "cuBLAS/cuSOLVER"
    return "other kernels"


def syncs_per_unit(run_unit, n: int) -> float:
    """Synchronising CUDA calls per unit over n units
    (`torch.cuda.set_sync_debug_mode("warn")` warns once per call)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_unit()          # the mode's own first sync is not the unit's
            torch.cuda.synchronize()
            caught.clear()
            for _ in range(n):
                run_unit()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    msgs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]
    kinds = collections.Counter(msgs)
    print(f"syncs over {n} units: {dict(kinds)}", file=sys.stderr, flush=True)
    return len(msgs) / n


class Trace:
    """A profiled window of `units` units: device events (name, cat, start
    us, duration us) inside it, its host events, and its bounds."""

    def __init__(self, events: list, units: int):
        window = [e for e in events if e.get("name") == WINDOW_SPAN
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        self.t0 = float(window[0]["ts"])
        self.t1 = self.t0 + float(window[0]["dur"])
        self.units = units
        inside = [e for e in events if e.get("ph") == "X"
                  and self.t0 <= float(e.get("ts", -1)) <= self.t1]
        self.device = [(str(e["name"]), str(e.get("cat", "")), float(e["ts"]),
                        float(e.get("dur", 0.0)))
                       for e in inside if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS
                     and float(e["ts"]) <= self.t1
                     and float(e["ts"]) + float(e.get("dur", 0.0)) >= self.t0]

    @property
    def window_s(self) -> float:
        return 1e-6 * (self.t1 - self.t0)

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, clipped to the
        window, as sorted (start, end) in us."""
        spans = sorted((max(ts, self.t0), min(ts + dur, self.t1))
                       for _, _, ts, dur in self.device)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return 1e-6 * sum(b - a for a, b in self.busy_intervals())

    def device_time_s(self, pattern: re.Pattern) -> tuple[float, int]:
        """(seconds, launches) of the device events whose name matches."""
        hits = [dur for name, _, _, dur in self.device if pattern.search(name)]
        return 1e-6 * sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> list:
        total = collections.Counter()
        for name, cat, _, dur in self.device:
            total[f"{group_of(name, cat)} | {name[:120]}"] += 1e-6 * dur
        return [[n, s] for n, s in total.most_common(k)]

    def groups(self) -> dict:
        total = collections.Counter()
        for name, cat, _, dur in self.device:
            total[group_of(name, cat)] += 1e-6 * dur
        return dict(total)

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time inside the window, summed by what the host
        was doing at each gap's middle: the outermost benchmark span, the
        innermost operator and the innermost CUDA runtime call active on
        the thread that entered last."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        if not gaps:
            return []
        threads = collections.defaultdict(list)
        for e in self.host:
            threads[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(
                e.get("dur", 0.0)), str(e["name"]), str(e["cat"])))
        for evs in threads.values():
            evs.sort(key=lambda v: (v[0], -v[1]))
        cursor = {tid: 0 for tid in threads}
        stacks = {tid: [] for tid in threads}
        total = collections.Counter()
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            best = None
            for tid, evs in threads.items():
                stack, i = stacks[tid], cursor[tid]
                while i < len(evs) and evs[i][0] <= mid:
                    stack.append(evs[i])
                    i += 1
                cursor[tid] = i
                stack[:] = [ev for ev in stack if ev[1] >= mid]
                if stack and (best is None or stack[-1][0] > best[-1][0]):
                    best = list(stack)
            total[_label(best)] += 1e-6 * (b - a)
        return [[n, s] for n, s in total.most_common(k)]


def _label(chain) -> str:
    if not chain:
        return "host outside any operator"
    span = next((ev[2] for ev in chain if ev[3] == "user_annotation"
                 and ev[2].startswith("bench.") and ev[2] != WINDOW_SPAN), "-")
    op = next((ev[2] for ev in reversed(chain) if ev[3] == "cpu_op"), "-")
    call = next((ev[2] for ev in reversed(chain)
                 if ev[3] in ("cuda_runtime", "cuda_driver")), "-")
    return f"{span} > {op} > {call}"


def profile_units(run_unit, n: int) -> Trace:
    """Profile n units (CPU and CUDA activity) inside the span
    `bench.window`, each unit inside its own span; read the trace back."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(n):
                run_unit()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    trace = Trace(events, n)
    trace.read_s = time.perf_counter() - t0
    return trace
