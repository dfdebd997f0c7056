"""Shared helpers of the benchmark's CPU tests: the checkout root on
`sys.path`, a runner of `benchmark/run.py` in a subprocess, and the
entries by which a cell made of the harness's files alone joins
`BENCHMARK.json`. No test here needs a card: the harness's CPU rehearsal
(`--device cpu`) runs the kernels' plain versions."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def run_cell(workload, seed, trace=0, seconds=1, code=None, timeout=600):
    """`benchmark/run.py` on the CPU in a subprocess (or `code`, a Python
    snippet given the same arguments on its command line): (exit code,
    stdout lines, stderr)."""
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    if code is None:
        cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), *args]
    else:
        cmd = [sys.executable, "-c", code, *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout.strip().splitlines(), proc.stderr


def last_json(lines):
    return json.loads(lines[-1])


# `vdp-vanilla.train`: its configuration, workload, model, data set and
# reference are files under `benchmark/`; these entries would list it
UNLISTED = {
    "configs": [{"name": "vdp-vanilla", "source": "https://arxiv.org/abs/2106.10905",
                 "file": "benchmark/configs/vdp-vanilla.json", "reduced": [],
                 "why": "vanilla GPODE on Van der Pol"}],
    "workloads": [{"name": "vdp-vanilla.train", "config": "vdp-vanilla",
                   "traffic": "train", "chips": 1,
                   "why": "vanilla VDP steps: the host-controlled solve"}],
    "end_to_end": [{"name": "train_steps_per_s.host_loop", "unit": "steps/s",
                    "better": "higher", "bound": 0.25, "source": "host_clock",
                    "workloads": ["vdp-vanilla.train"]}],
}


def with_unlisted(spec: dict) -> dict:
    """`spec` with the entries of UNLISTED added."""
    return {k: v + UNLISTED.get(k, []) if isinstance(v, list) else v
            for k, v in spec.items()}
