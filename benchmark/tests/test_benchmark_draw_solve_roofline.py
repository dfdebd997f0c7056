"""`draw_solve_roofline_pct` on synthetic traces made by hand: the
`draw_solve` kernels' least time (`opcounts_draw`: a forward and a backward
a step, at the shape the program records) over the device time of every
`draw_solve` kernel, the one-block layout's two and the packed layout's
four (its backward's three launches counted as one backward); nothing
where the trace holds no such kernel, where no shape or more than one was
recorded (a program before the record), or without a trace. The counts'
operations and bytes pinned at the official step's draw (B=5, M=100, R=1)
and the `scale` step's (B=5, M=256, R=1)."""

import os
from types import SimpleNamespace

import pytest

import conftest

from benchmark import opcounts
from benchmark.harness import load_file_module
from benchmark.opcounts_draw import draw_solve_bwd, draw_solve_fwd
from benchmark.tracing import Trace
from gpode_tpu_torch.ops import cuda_kernels

READER = load_file_module(os.path.join(conftest.ROOT, "benchmark", "metrics",
                                       "draw_solve_roofline_pct.py"),
                          "draw_solve_roofline_pct")
OFFICIAL, SCALE = (5, 100, 1), (5, 256, 1)
ARGS = "(float const*, float const*, float const*, float, float*, float*, float*, int, int)"
SQUARE = [("draw_solve_fwd_kernel" + ARGS, 40.0),
          ("draw_solve_bwd_kernel(float const*, float const*, float const*, "
           "float const*, float*, float*, float*, int, int)", 45.0)]
PACKED = [("draw_solve_fwd_packed_kernel" + ARGS, 160.0),
          ("draw_solve_bwd_cols_kernel(float const*, float const*, float const*, "
           "float const*, float*, float*, float*, int, int)", 64.0),
          ("draw_solve_bwd_rows_kernel(float const*, float*, int)", 36.0),
          ("draw_solve_bwd_sym_kernel(float const*, float*, int)", 4.0)]


def _ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7}


def _ctx(kernels):
    events = [_ev("bench.window", 0.0, 10000.0, "user_annotation")]
    events += [_ev(name, ts, dur, "kernel") for name, ts, dur in kernels]
    return SimpleNamespace(trace=Trace(events, 1), on_device=True)


def _steps(k, launches):
    """k steps: the draw's launches and an unrelated kernel each."""
    out, ts = [], 0.0
    for _ in range(k):
        for name, dur in launches + [("void other_kernel<4>(float*)", 5.0)]:
            out.append((name, ts, dur))
            ts += dur + 1.0
    return out


def test_the_counts_at_the_two_draws():
    assert draw_solve_fwd(*OFFICIAL) == (5 * (100 ** 3 / 3.0 + 2 * 100 ** 2),
                                         4 * 5 * (2 * 100 ** 2 + 4 * 100))
    assert draw_solve_bwd(*OFFICIAL) == (5 * (6 * 100 ** 2 + 2 * 100 ** 3
                                              + 100 ** 2),
                                         4 * 5 * (2 * 100 ** 2 + 6 * 100))
    fwd, bwd = draw_solve_fwd(*SCALE), draw_solve_bwd(*SCALE)
    assert fwd == (5 * (256 ** 3 / 3.0 + 2 * 256 ** 2),
                   4 * 5 * (2 * 256 ** 2 + 4 * 256))
    assert bwd == (5 * (7 * 256 ** 2 + 2 * 256 ** 3),
                   4 * 5 * (2 * 256 ** 2 + 6 * 256))
    (f_s, f_by), (b_s, b_by) = opcounts.bound_s(*fwd), opcounts.bound_s(*bwd)
    assert f_by == "bytes" and 7.8e-7 < f_s < 8.0e-7
    assert b_by == "operations" and 2.5e-6 < b_s < 2.6e-6


@pytest.mark.parametrize("shape,launches", [(OFFICIAL, SQUARE),
                                            (SCALE, PACKED)],
                         ids=["square", "packed"])
@pytest.mark.parametrize("k", [1, 3])
def test_the_share_of_the_kernels_device_time(monkeypatch, shape, launches, k):
    monkeypatch.setattr(cuda_kernels, "DRAW_SOLVE_SHAPES", {shape})
    least = (opcounts.bound_s(*draw_solve_fwd(*shape))[0]
             + opcounts.bound_s(*draw_solve_bwd(*shape))[0])
    busy = 1e-6 * sum(dur for _, dur in launches)
    want = 100.0 * k * least / (k * busy)
    assert READER.read(_ctx(_steps(k, launches))) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_trace", "no_kernel", "no_shape",
                                  "two_shapes", "parent"])
def test_nothing_to_read(monkeypatch, case):
    shapes = {"no_shape": set(), "two_shapes": {OFFICIAL, SCALE}}
    monkeypatch.setattr(cuda_kernels, "DRAW_SOLVE_SHAPES",
                        shapes.get(case, {SCALE}))
    if case == "parent":  # a program that keeps no record of the shapes
        monkeypatch.delattr(cuda_kernels, "DRAW_SOLVE_SHAPES")
    if case == "no_trace":
        ctx = SimpleNamespace(trace=None, on_device=True)
    elif case == "no_kernel":
        ctx = _ctx([("void other_kernel<4>(float*)", 0.0, 5.0)])
    else:
        ctx = _ctx(_steps(2, PACKED))
    assert READER.read(ctx) is None
