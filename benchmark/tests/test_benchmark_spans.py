"""The readers of the program's spans (`benchmark/spans.py`) on synthetic
traces made by hand: a window of known device events and host spans, so
that each metric reads its exact value; the readers of the program's
untraced clock on a clock set by hand; and each reads nothing where the
program records no span or keeps no clock, as a commit before them does."""

from types import SimpleNamespace

import pytest

import conftest  # noqa: F401  (the checkout root on sys.path)

from benchmark import spans
from benchmark.tracing import Trace
from gpode_tpu_torch.utils import profiling


def _ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _kernel(ts, dur):
    return _ev("void some_kernel<4>(float*)", ts, dur, cat="kernel", tid=7)


def _ctx(events, units):
    return SimpleNamespace(trace=Trace(
        [_ev("bench.window", 0.0, 1000.0)] + events, units), on_device=True)


def _clock_ctx(monkeypatch, clock, on_device=True):
    """A context on a card whose program's untraced clock reads `clock`."""
    monkeypatch.setattr(profiling, "UNTRACED", clock)
    return SimpleNamespace(trace=None, on_device=on_device)


def _train_trace():
    """Two steps in a 1000-us window, with kernels, three replays, accept
    reads of 40 and 60 us and one eager step, on a reject; a device
    annotation and a `bench.` span that are no step's."""
    return [_kernel(0.0, 100.0), _kernel(150.0, 150.0), _kernel(320.0, 180.0),
            _kernel(600.0, 300.0), _kernel(950.0, 50.0),
            _ev("gpode.step", 80.0, 400.0), _ev("gpode.step", 500.0, 450.0),
            _ev("gpode.step.replay", 90.0, 110.0),
            _ev("gpode.step.replay", 290.0, 20.0),
            _ev("gpode.step.replay", 520.0, 20.0),
            _ev("gpode.step.accept_read", 210.0, 40.0),
            _ev("gpode.step.accept_read", 545.0, 60.0),
            _ev("gpode.step.eager", 610.0, 300.0),
            _ev("gpode.step.replay", 100.0, 50.0, cat="gpu_user_annotation"),
            _ev("bench.step", 500.0, 450.0)]


def _request_trace():
    """One request: three attempts of 100, 80 and 60 us, with error reads
    of 30, 20 and 10 us inside them; a read on another thread inside the
    second attempt's interval, and one outside every attempt, belong to no
    attempt."""
    return [_kernel(0.0, 10.0),
            _ev("gpode.predict", 50.0, 600.0),
            _ev("gpode.solve", 60.0, 400.0),
            _ev("gpode.solve.attempt", 100.0, 100.0),
            _ev("gpode.solve.error_read", 160.0, 30.0),
            _ev("gpode.solve.attempt", 200.0, 80.0),
            _ev("gpode.solve.error_read", 250.0, 20.0),
            _ev("gpode.solve.error_read", 210.0, 5.0, tid=2),
            _ev("gpode.solve.attempt", 300.0, 60.0),
            _ev("gpode.solve.error_read", 340.0, 10.0),
            _ev("gpode.solve.error_read", 400.0, 7.0)]


CLOCK = {"gpode.step": [4, 0.02], "gpode.step.replay": [8, 0.0006],
         "gpode.solve.attempt": [10, 0.05],
         "gpode.solve.error_read": [10, 0.01]}


def test_graph_launch_is_the_untraced_replay_time_per_step(monkeypatch):
    # 0.6 ms of launches over 4 steps
    ctx = _clock_ctx(monkeypatch, CLOCK)
    assert spans.graph_launch_ms_per_step(ctx) == pytest.approx(0.15)


def test_accept_wait_sums_the_reads():
    assert spans.accept_wait_ms_per_step(_ctx(_train_trace(), 2)) == (
        pytest.approx(0.05))


def test_rejected_steps_count_the_eager_steps():
    assert spans.rejected_steps_pct(_ctx(_train_trace(), 2)) == 50.0


def test_attempts_per_request():
    assert spans.solve_attempts_per_request(_ctx(_request_trace(), 1)) == 3.0
    assert spans.solve_attempts_per_request(_ctx(_request_trace(), 3)) == 1.0


def test_error_reads_per_request_sum_every_read():
    # 30 + 20 + 5 + 10 + 7 us
    assert spans.error_read_ms_per_request(_ctx(_request_trace(), 1)) == (
        pytest.approx(0.072))


def test_attempt_dispatch_is_the_untraced_attempt_less_its_read(monkeypatch):
    # (50 - 10) ms over 10 attempts
    ctx = _clock_ctx(monkeypatch, CLOCK)
    assert spans.attempt_dispatch_ms(ctx) == pytest.approx(4.0)


CLOCK_READERS = [spans.graph_launch_ms_per_step, spans.attempt_dispatch_ms]


@pytest.mark.parametrize("read", CLOCK_READERS, ids=lambda r: r.__name__)
@pytest.mark.parametrize("clock", ["missing", "uncalled", "cpu"])
def test_nothing_without_the_programs_untraced_calls(monkeypatch, read,
                                                     clock):
    """No clock (a program that keeps none), a clock of no call (a step
    that launched no graph, a cell that solved nothing), and a run off the
    card read as nothing."""
    if clock == "missing":
        monkeypatch.delattr(profiling, "UNTRACED")
        ctx = SimpleNamespace(trace=None, on_device=True)
    elif clock == "uncalled":
        ctx = _clock_ctx(monkeypatch, {k: [0, 0.0] for k in CLOCK})
    else:
        ctx = _clock_ctx(monkeypatch, CLOCK, on_device=False)
    assert read(ctx) is None


READERS = [spans.accept_wait_ms_per_step, spans.rejected_steps_pct,
           spans.solve_attempts_per_request, spans.error_read_ms_per_request]


@pytest.mark.parametrize("read", READERS, ids=lambda r: r.__name__)
def test_nothing_without_the_programs_spans(read):
    """A trace of `bench.` spans and kernels alone (a program that records
    no span), and no trace at all (a CPU run), read as nothing."""
    bare = [e for e in _train_trace() + _request_trace()
            if not e["name"].startswith("gpode.")]
    assert read(_ctx(bare, 2)) is None
    assert read(SimpleNamespace(trace=None, on_device=True)) is None


def test_each_cell_reads_only_its_own_part():
    """The step's readers find no step in a request's trace, and the
    request's none in a step's."""
    train, request = _ctx(_train_trace(), 2), _ctx(_request_trace(), 1)
    assert spans.accept_wait_ms_per_step(request) is None
    assert spans.rejected_steps_pct(request) is None
    assert spans.solve_attempts_per_request(train) is None
    assert spans.error_read_ms_per_request(train) is None
