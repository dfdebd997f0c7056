"""`replayed_attempts_pct` on untraced clocks set by hand: the share of the
attempts that replayed a graph, none off the card or where the program
keeps no replay clock (a commit before the captured attempt) or attempted
nothing."""

import os
from types import SimpleNamespace

import pytest

import conftest

from benchmark.harness import load_file_module
from gpode_tpu_torch.utils import profiling

READER = load_file_module(os.path.join(conftest.ROOT, "benchmark", "metrics",
                                       "replayed_attempts_pct.py"),
                          "replayed_attempts_pct")


def _read(monkeypatch, clock, on_device=True):
    monkeypatch.setattr(profiling, "UNTRACED", clock)
    return READER.read(SimpleNamespace(trace=None, on_device=on_device))


@pytest.mark.parametrize("attempts,replays,pct",
                         [(91, 91, 100.0), (91, 0, 0.0), (104, 26, 25.0)])
def test_the_share_of_attempts_that_replayed(monkeypatch, attempts, replays,
                                             pct):
    clock = {"gpode.solve.attempt": [attempts, 0.5],
             "gpode.solve.error_read": [attempts, 0.1],
             "gpode.solve.replay": [replays, 0.001 * replays]}
    assert _read(monkeypatch, clock) == pytest.approx(pct)


@pytest.mark.parametrize("case", ["cpu", "no_replay_clock", "no_attempt",
                                  "no_clock"])
def test_nothing_to_read(monkeypatch, case):
    clock = {"gpode.solve.attempt": [91, 0.5],
             "gpode.solve.replay": [91, 0.01]}
    if case == "no_replay_clock":
        del clock["gpode.solve.replay"]
    elif case == "no_attempt":
        clock["gpode.solve.attempt"] = [0, 0.0]
    if case == "no_clock":
        monkeypatch.delattr(profiling, "UNTRACED")
        assert READER.read(SimpleNamespace(trace=None, on_device=True)) is None
        return
    assert _read(monkeypatch, clock, on_device=case != "cpu") is None
