"""Summarize a torch.profiler Chrome trace: per-op device time, grouped.

    python -m gpode_tpu_torch.scripts.analyze_trace <trace dir or file>
        [--top 40] [--track-filter stream] [--steps N]

Counterpart of `scripts/analyze_trace.py`. Reads the newest
`*.trace.json.gz` (or `.json`) under the directory (what
`utils/profiling.trace` and `capture_trace` write), sums the durations of
the complete events on the tracks whose "<process name>/<thread name>"
matches `--track-filter` (default: the CUDA streams), and prints the total,
a grouped rollup and the top ops:

  * the port's kernels, by their source under `gpode_tpu_torch/csrc/`;
  * cuBLAS / cuSOLVER (GEMMs, triangular solves, Cholesky);
  * collectives (NCCL);
  * memcpy / memset;
  * other elementwise and reduction kernels (PyTorch's own).

Profiler annotations on the device tracks (`gpu_user_annotation`) repeat
their kernels' time and are skipped. On a trace of the CPU alone, pass a
filter that matches its threads (`--track-filter thread`): the sums are
then operator times, nested operators counted in each parent too.

Last comes the roll-up of the program's spans (`utils/profiling.SPANS`,
the host's `gpode.*` ranges on every thread, whatever the filter): each
name's count, total ms and self ms (its duration less its child spans').
`--steps` divides every figure by the traced step count.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

# the port's kernels (gpode_tpu_torch/csrc/), by their __global__ names
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
_SLACK_US = 0.01
GROUPS = ("port kernels", "cuBLAS/cuSOLVER", "collectives", "memcpy/memset",
          "other kernels")


def find_trace(root: str) -> str:
    """`root` itself when it is a file, else its newest trace file."""
    if os.path.isfile(root):
        return root
    hits = sorted(glob.glob(os.path.join(root, "**", "*.trace.json*"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {root}")
    return hits[-1]


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def track_events(data: dict, track_filter: str) -> tuple[list, list]:
    """(the complete events on matching tracks, the matching track
    names)."""
    events = data["traceEvents"] if isinstance(data, dict) else data
    pid_name, tid_name = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            pid_name[e.get("pid")] = str(e["args"].get("name", ""))
        elif e.get("name") == "thread_name":
            tid_name[(e.get("pid"), e.get("tid"))] = str(
                e["args"].get("name", ""))
    pat = re.compile(track_filter)

    def track(e):
        return (f"{pid_name.get(e.get('pid'), e.get('pid'))}/"
                f"{tid_name.get((e.get('pid'), e.get('tid')), e.get('tid'))}")

    picked = [e for e in events if e.get("ph") == "X"
              and "annotation" not in str(e.get("cat", ""))
              and pat.search(track(e))]
    return picked, sorted({track(e) for e in picked})


def group_of(name: str, cat: str = "") -> str:
    """The rollup group of a device event (a port kernel's group is
    "port kernels: <source>")."""
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


def summarize(events: list) -> dict:
    """{"total_us", "per_op": {name: (us, count)}, "groups": {group: us}}
    over the events' durations (microseconds, as the trace stores them)."""
    per_op = collections.defaultdict(lambda: [0.0, 0])
    groups = collections.Counter()
    total = 0.0
    for e in events:
        dur = float(e.get("dur", 0.0))
        name = str(e.get("name", "?"))
        per_op[name][0] += dur
        per_op[name][1] += 1
        groups[group_of(name, str(e.get("cat", "")))] += dur
        total += dur
    return {"total_us": total,
            "per_op": {k: tuple(v) for k, v in per_op.items()},
            "groups": dict(groups)}


def span_rollup(data: dict) -> dict:
    """{name: (count, total us, self us)} of the program's spans: the
    host's `gpode.*` ranges, each one's self time its duration less that
    of the spans directly inside it on its thread."""
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = sorted(((e.get("tid"), float(e["ts"]), float(e.get("dur", 0.0)),
                     str(e["name"])) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("gpode.")),
                   key=lambda s: (str(s[0]), s[1], -s[2]))
    out = collections.defaultdict(lambda: [0, 0.0, 0.0])
    stack: list = []
    for tid, ts, dur, name in spans:
        # spans on a thread nest: one that starts before the open span ends
        # is inside it (10 ns of slack for the trace's rounding)
        while stack and (stack[-1][0] != tid
                         or stack[-1][1] + stack[-1][2] <= ts + _SLACK_US):
            stack.pop()
        if stack:
            out[stack[-1][3]][2] -= dur
        out[name][0] += 1
        out[name][1] += dur
        out[name][2] += dur
        stack.append((tid, ts, dur, name))
    return {k: tuple(v) for k, v in out.items()}


def report(path: str, track_filter: str = "stream", top: int = 40,
           steps: int = 1) -> dict:
    """Print the summary of the trace at `path` (a file or a directory);
    returns `summarize`'s dict plus "path", "tracks" and "spans"
    (`span_rollup`'s). Raises when no track matches."""
    path = find_trace(path)
    data = load_trace(path)
    events, tracks = track_events(data, track_filter)
    if not tracks:
        raise ValueError(f"no track of {path} matches {track_filter!r}")
    out = summarize(events)
    total = out["total_us"]
    per = f" per step over {steps}" if steps > 1 else " (all captured steps)"
    print(f"trace: {path}")
    print(f"tracks: {tracks}")
    print(f"total op time{per}: {total / 1e3 / steps:.4f} ms\n")
    print("== groups ==")
    for g, dur in sorted(out["groups"].items(), key=lambda kv: -kv[1]):
        print(f"{dur / 1e3 / steps:9.4f} ms  "
              f"{100 * dur / max(total, 1e-9):5.1f}%  {g}")
    print(f"\n== top {top} ops ==")
    ranked = sorted(out["per_op"].items(), key=lambda kv: -kv[1][0])
    for name, (dur, n) in ranked[:top]:
        print(f"{dur / 1e3 / steps:9.4f} ms  n={n / steps:7.1f}  "
              f"{100 * dur / max(total, 1e-9):5.1f}%  {name[:110]}")
    spans = span_rollup(data)
    print("\n== program spans (total ms, self ms) ==")
    for name, (n, dur, own) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        print(f"{dur / 1e3 / steps:9.4f} ms  {own / 1e3 / steps:9.4f} ms  "
              f"n={n / steps:7.1f}  {name}")
    return dict(out, path=path, tracks=tracks, spans=spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--track-filter", type=str, default="stream",
                    help="regex a track's '<process>/<thread>' name must "
                         "match (default: the CUDA streams)")
    ap.add_argument("--steps", type=int, default=1,
                    help="divide every figure by this many traced steps")
    cli = ap.parse_args(argv)
    try:
        report(cli.trace_dir, cli.track_filter, cli.top, cli.steps)
    except (FileNotFoundError, ValueError) as exc:
        print(f"analyze_trace: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
