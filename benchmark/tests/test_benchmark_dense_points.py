"""`device_dense_points_pct` on counters set by hand: the share of the
dense output's points formed on the device, none off the card, where the
program keeps no counter (a commit before the device commit) or formed no
point."""

import os
from types import SimpleNamespace

import pytest

import conftest

from benchmark.harness import load_file_module
from gpode_tpu_torch.ops import ode

READER = load_file_module(os.path.join(conftest.ROOT, "benchmark", "metrics",
                                       "device_dense_points_pct.py"),
                          "device_dense_points_pct")


def _read(on_device=True):
    return READER.read(SimpleNamespace(trace=None, on_device=on_device))


@pytest.mark.parametrize("device,host,pct",
                         [(10710, 0, 100.0), (0, 10710, 0.0), (300, 100, 75.0)])
def test_the_share_of_points_formed_on_the_device(monkeypatch, device, host,
                                                  pct):
    monkeypatch.setattr(ode, "DENSE_POINTS", {"host": host, "device": device})
    assert _read() == pytest.approx(pct)


@pytest.mark.parametrize("case", ["cpu", "no_counter", "no_point"])
def test_nothing_to_read(monkeypatch, case):
    points = {"host": 0, "device": 0} if case == "no_point" else {
        "host": 5, "device": 119}
    monkeypatch.setattr(ode, "DENSE_POINTS", points)
    if case == "no_counter":
        monkeypatch.delattr(ode, "DENSE_POINTS")
    assert _read(on_device=case != "cpu") is None
