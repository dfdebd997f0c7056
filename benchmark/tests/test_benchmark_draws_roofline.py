"""`draws_attempt_roofline_pct` on synthetic traces made by hand: the
batched-draw attempt kernel's least time (`opcounts_eval`) over the device
time of the kernel and its reduction, at the shape the program records;
nothing where the trace holds no such kernel (a commit before it), where
no shape or more than one was recorded, or without a trace. The count's
operations and bytes at the validation request's 32 draws x 2 rows."""

import os
from types import SimpleNamespace

import pytest

import conftest

from benchmark import opcounts
from benchmark.harness import load_file_module
from benchmark.opcounts_eval import dp_attempt_draws
from benchmark.tracing import Trace
from gpode_tpu_torch.ops import cuda_kernels

READER = load_file_module(os.path.join(conftest.ROOT, "benchmark", "metrics",
                                       "draws_attempt_roofline_pct.py"),
                          "draws_attempt_roofline_pct")
SHAPE = (32, 2, 5, 5, 100, 256)
ATTEMPT = "void draws_attempt_kernel<5, 8, 1024>(float const*, float*)"
RATIO = "draws_ratio_kernel(float const*, float*, int, int, float)"


def _ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7}


def _ctx(kernels):
    events = [_ev("bench.window", 0.0, 1000.0, "user_annotation")]
    events += [_ev(name, ts, dur, "kernel") for name, ts, dur in kernels]
    return SimpleNamespace(trace=Trace(events, 1), on_device=True)


def _attempts(k):
    """k attempts: a 20-us attempt kernel and a 2-us reduction each, and
    an unrelated kernel between them."""
    out = []
    for i in range(k):
        out += [(ATTEMPT, 30.0 * i, 20.0), (RATIO, 30.0 * i + 21, 2.0),
                ("void other_kernel<4>(float*)", 30.0 * i + 24, 5.0)]
    return out


def test_the_count_at_the_validation_request():
    ops, nbytes = dp_attempt_draws(*SHAPE)
    assert ops == 6 * opcounts.rhs_ops(64, 5, 5, 100, 256)
    per_draw = 5 * 256 * 5 + 2 * 256 * 5 + 5 * 100
    assert nbytes == 4 * (32 * per_draw + 500 + 25 + 5 + 64 * 10 + 64 * 10 + 2)
    seconds, by = opcounts.bound_s(ops, nbytes)
    assert by == "bytes" and 3.5e-7 < seconds < 4.0e-7


@pytest.mark.parametrize("k", [1, 3])
def test_the_share_of_the_kernels_device_time(monkeypatch, k):
    monkeypatch.setattr(cuda_kernels, "DRAWS_ATTEMPT_SHAPES", {SHAPE})
    least = opcounts.bound_s(*dp_attempt_draws(*SHAPE))[0]
    want = 100.0 * k * least / (k * 22e-6)
    assert READER.read(_ctx(_attempts(k))) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_trace", "no_kernel", "no_shape",
                                  "two_shapes", "parent"])
def test_nothing_to_read(monkeypatch, case):
    shapes = {"no_shape": set(), "two_shapes": {SHAPE, (128,) + SHAPE[1:]}}
    monkeypatch.setattr(cuda_kernels, "DRAWS_ATTEMPT_SHAPES",
                        shapes.get(case, {SHAPE}))
    if case == "parent":  # a program that keeps no record of the shapes
        monkeypatch.delattr(cuda_kernels, "DRAWS_ATTEMPT_SHAPES")
    if case == "no_trace":
        ctx = SimpleNamespace(trace=None, on_device=True)
    elif case == "no_kernel":
        ctx = _ctx([("void other_kernel<4>(float*)", 0.0, 5.0)])
    else:
        ctx = _ctx(_attempts(2))
    assert READER.read(ctx) is None
