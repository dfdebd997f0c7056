"""`device_state_entropies_pct` on the program's counter set by hand: 100 x
"state_device" over all the shooting states' entropy calls
(`cuda_kernels.STATE_ENTROPIES`); nothing off the card, on a program
without the counter (the parent of the kernels) or before any call. Its
`BENCHMARK.json` entry: the layer of `device_kernels_per_step`, moving
`train_steps_per_s`, in both train cells."""

import os
from types import SimpleNamespace

import pytest

import conftest

from benchmark.harness import cell_metrics, load_file_module, load_spec
from gpode_tpu_torch.ops import cuda_kernels

NAME = "device_state_entropies_pct"
READER = load_file_module(os.path.join(conftest.ROOT, "benchmark", "metrics",
                                       f"{NAME}.py"), NAME)
TRAIN_CELLS = ["mocap09-shooting.train", "mocap09-scale.train"]


def _ctx(on_device=True):
    return SimpleNamespace(trace=None, on_device=on_device)


@pytest.mark.parametrize("device,unrolled,pct", [
    (20 * 1100, 0, 100.0), (0, 7, 0.0), (3, 1, 75.0)])
def test_the_share_of_calls_on_the_device(monkeypatch, device, unrolled, pct):
    monkeypatch.setattr(cuda_kernels, "STATE_ENTROPIES",
                        {"state_device": device, "state_unrolled": unrolled})
    assert READER.read(_ctx()) == pytest.approx(pct)


@pytest.mark.parametrize("case", ["cpu", "parent", "no_call"])
def test_nothing_to_read(monkeypatch, case):
    counts = ({"state_device": 0, "state_unrolled": 0} if case == "no_call"
              else {"state_device": 5, "state_unrolled": 0})
    monkeypatch.setattr(cuda_kernels, "STATE_ENTROPIES", counts, raising=False)
    if case == "parent":
        monkeypatch.delattr(cuda_kernels, "STATE_ENTROPIES")
    assert READER.read(_ctx(on_device=case != "cpu")) is None


def test_the_entry_reports_in_both_train_cells_only():
    spec = load_spec()
    entry = next(m for m in spec["per_layer"] if m["name"] == NAME)
    kernels = next(m for m in spec["per_layer"]
                   if m["name"] == "device_kernels_per_step")
    assert entry["layer"] == kernels["layer"]
    assert entry["moves"] == "train_steps_per_s"
    assert entry["workloads"] == TRAIN_CELLS
    for cell in (w["name"] for w in spec["workloads"]):
        names = {m["name"] for m in cell_metrics(spec, cell)[1]}
        assert (NAME in names) == (cell in TRAIN_CELLS)
