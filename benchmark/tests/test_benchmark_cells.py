"""Each cell end to end on the CPU at a tiny window, with the kernels'
plain versions: the last line of standard output carries exactly the
result's keys, is labelled as a CPU run and fills no device metric; and no
module the run loads is JAX's or the JAX package's (top-level names
compared whole: the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, last_json, run_cell, with_unlisted

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "gpode_tpu"}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]

# the harness in-process, then the top-level names of every loaded module
DUMP_MODULES = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
rc = harness.main(sys.argv[1:])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
""".format(root=ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(cell):
    rc, out, err = run_cell(cell, 987654321987)
    assert rc == 0, err[-4000:]
    line = last_json(out)
    assert list(line) == KEYS
    assert line["correct"] is True, err[-4000:]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": None}
    e2e = {m["name"] for m in SPEC["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert err.rstrip().splitlines()[-1].startswith("check failed")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_loads_no_jax(cell):
    rc, out, err = run_cell(cell, 2 ** 31 + 5, trace=1, code=DUMP_MODULES)
    assert rc == 0, err[-4000:]
    modules = set(json.loads(out[-1]))
    assert "gpode_tpu_torch" in modules
    assert not modules & FORBIDDEN
    line = json.loads(out[-2])
    assert list(line) == KEYS
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert line["metrics"] == {}        # every per-layer metric is the card's


def _in_process(cell, monkeypatch, capsys, spec=None):
    from benchmark import harness
    if spec is not None:
        monkeypatch.setattr(harness, "load_spec", lambda: spec)
    rc = harness.main(["--workload", cell, "--seed", "31415926535", "--seconds",
                       "1", "--trace", "0", "--device", "cpu"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_unlisted_cell_runs_from_its_files(monkeypatch, capsys):
    """A cell made of files alone (configuration, workload, model, data
    set, reference) runs once `BENCHMARK.json` lists it."""
    from benchmark import harness
    line = _in_process("vdp-vanilla.train", monkeypatch, capsys,
                       with_unlisted(harness.load_spec()))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_steps_per_s.host_loop"}


def test_captured_rehearsal_is_correct(monkeypatch, capsys):
    """The train cell through the captured step's CPU rehearsal (inputs
    copied into static buffers, as the card's replays take them) comes out
    correct, so the planted replay faults are what fails it."""
    from gpode_tpu_torch.train import graph_step
    monkeypatch.setattr(graph_step, "make_step",
                        lambda loss_fn, params, opt, margs:
                        graph_step.make_captured_train_step(loss_fn, params, opt))
    line = _in_process("mocap09-shooting.train", monkeypatch, capsys)
    assert line["correct"] is True, line["checks"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); import json;"
            "import benchmark.reference.common, benchmark.reference.shooting,"
            " benchmark.reference.vanilla;"
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))"
            ).format(root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    modules = set(json.loads(out))
    assert not modules & (FORBIDDEN | {"gpode_tpu_torch"})
    for name in os.listdir(os.path.join(ROOT, "benchmark", "reference")):
        if name.endswith(".py"):
            text = open(os.path.join(ROOT, "benchmark", "reference", name)).read()
            assert "gpode_tpu" not in text, name
