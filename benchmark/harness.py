"""One run of one cell: find the cell's files by name, run its traffic kind,
read its metrics and print the result.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric sits in a file of its own, found by the name that
`BENCHMARK.json` gives:

  benchmark/workloads/<cell>.json   config, traffic, parameters, limits
  benchmark/configs/<config>.json   the configuration as it is run
  benchmark/reference/<ref>.py      its plain reference (the config names it)
  benchmark/models/<model>.py       the model's inputs and its program entry
                                    points (the config names it)
  benchmark/datasets/<kind>.py      the config's data set (its `data.kind`)
  benchmark/traffic/<traffic>.py    the traffic kind's loop: `run(cell)`
  benchmark/metrics/<metric>.py     a per-layer metric's reader: `read(ctx)`
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from benchmark import compare

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gpode_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that `cell` reports."""
    def reports(entry, e2e_names=None):
        if "workloads" in entry:
            return cell in entry["workloads"]
        return e2e_names is None or entry["moves"] in e2e_names

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in spec["per_layer"] if reports(m, names)]


def forbidden_loaded() -> list:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN_MODULES))


class Context:
    """What the per-layer readers read: the cell's configuration and shapes,
    the untraced window's seconds (and solver evaluations) per unit and,
    where its units are requests, each one's latency in ms, and in a
    `--trace 1` run on a card the syncs per unit and the trace."""

    def __init__(self, cell, shapes, wall_s_per_unit, nfe_per_unit=None,
                 latencies_ms=None):
        self.config = cell.config
        self.shapes = shapes
        self.on_device = cell.device.type == "cuda"
        self.wall_s_per_unit = wall_s_per_unit
        self.nfe_per_unit = nfe_per_unit
        self.latencies_ms = latencies_ms
        self.syncs_per_unit = None
        self.trace = None


class Cell:
    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_start: float):
        spec = load_spec()
        entry = next((w for w in spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.entry = spec, entry
        self.name = name
        self.workload = load_json(HERE, "workloads", f"{name}.json")
        self.config = load_json(HERE, "configs", f"{entry['config']}.json")
        if (self.workload["config"], self.workload["traffic"]) != (
                entry["config"], entry["traffic"]):
            raise SystemExit(f"{name}: its workload file and BENCHMARK.json "
                             f"name different configs or traffic")
        self.reference = importlib.import_module(
            f"benchmark.reference.{self.config['reference']}")
        self.model = importlib.import_module(
            f"benchmark.models.{self.config['model']}")
        self.traffic = importlib.import_module(
            f"benchmark.traffic.{entry['traffic']}")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start

    def log(self, msg: str):
        at = time.perf_counter() - self.t_start
        print(f"[{self.name} {at:.3f} s] {msg}", file=sys.stderr, flush=True)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def context(self, **kw) -> Context:
        return Context(self, **kw)

    def memory_peak(self):
        if self.device.type != "cuda":
            return None
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))

    def read_per_layer(self, entries: list, ctx: Context) -> dict:
        out = {}
        for i, m in enumerate(entries):
            reader = load_file_module(os.path.join(HERE, "metrics",
                                                   f"{m['name']}.py"),
                                      f"benchmark_metric_{i}")
            value = reader.read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc}"


def run(cell: Cell) -> dict:
    """Run the cell once and build its result line."""
    e2e, per_layer = cell_metrics(cell.spec, cell.name)
    res = cell.traffic.run(cell)
    ctx = res["context"]
    if cell.device.type == "cuda":
        cell.log(f"card: {power_line()}")
    if cell.trace:
        metrics = cell.read_per_layer(per_layer, ctx)
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in e2e}
    limits = cell.workload["limits"]
    readings = res["readings"]
    cell.log(f"readings {json.dumps(readings)}")
    correct = res["failed"] == 0 and compare.verdict(readings, limits)
    cell.log(f"attempted {res['attempted']}, failed {res['failed']}")
    if cell.device.type == "cuda":
        device = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(cell.device),
                  "count": int(cell.entry["chips"]),
                  "memory_peak_bytes": res["memory_peak_bytes"]}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": None}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if cell.trace and ctx.trace is not None:
        tr = ctx.trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        cell.log(f"trace: {tr.units} units, {len(tr.device)} device events, "
                 f"busy {tr.busy_s!r} s of {tr.window_s!r} s; groups "
                 f"{json.dumps(tr.groups())}; read in {tr.read_s!r} s")
    line["checks"] = {k: {"value": readings[k], "limit": lim}
                      for k, lim in limits.items()}
    line["checks"]["failed"] = {"value": res["failed"], "limit": 0}
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return line


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal of the harness on the CPU with the "
                         "kernels' plain versions (no device metric is read)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    chips = next((int(w["chips"]) for w in load_spec()["workloads"]
                  if w["name"] == args.workload), 1)
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace),
                device, t_start)
    line = run(cell)
    found = forbidden_loaded()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0
