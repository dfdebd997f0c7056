"""The port's spans (`utils/profiling.span`, `SPANS`) on the CPU: with no
profiler active a span is the shared no-op and `record_function` is never
called; under `torch.profiler` the captured step's CPU rehearsal, the eager
step's phases, the adaptive dopri5 solve and a prediction request record
the spans their boundaries promise, as many as the step's counters and the
solver's `ODEStats` count, nested as documented. The clocked spans
(`profiling.clocked`) count and time their untraced calls in
`profiling.UNTRACED`, and leave it alone under a profiler.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpode_tpu_torch.models import flow as tflow
from gpode_tpu_torch.models import gpode
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.shooting import SOLVE_RANGE, sample_step_noise
from gpode_tpu_torch.ops import capture, ode
from gpode_tpu_torch.parallel import collective_audit
from gpode_tpu_torch.train import trainer as tt
from gpode_tpu_torch.train.builders import shooting_loss_fn
from gpode_tpu_torch.train.evaluation import make_projected_scorer
from gpode_tpu_torch.utils import profiling

from test_torch_graph_step import N_STEPS, REJECT_AT, SMALL_ARGS, _problem, _train

torch.set_num_threads(1)


def _spans(prof) -> list:
    """[(name, start, end, thread)] of the program's spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                   for e in prof.events() if e.name.startswith("gpode.")),
                  key=lambda s: (s[1], -s[2]))


def _count(spans, name) -> int:
    return sum(s[0] == name for s in spans)


def _inside(child, parent) -> bool:
    return (child[3] == parent[3] and parent[1] <= child[1]
            and child[2] <= parent[2])


def _children(spans, parent, name) -> list:
    return [s for s in spans if s[0] == name and _inside(s, parent)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _scorer_problem():
    """A small shooting model viewed as a GPODE, a dopri5 scorer in the
    latent space from the data's first states, and 3 draws' noise."""
    args = SMALL_ARGS["official"]
    params, ys, ts = _problem(args)
    view = gpode.GPODEParams(params.gp, params.states.x0, params.likelihood)
    scorer = make_projected_scorer(
        SolverConfig(solver="dopri5", max_steps=512), None, ys.numpy(),
        ts.numpy(), ys[:, 0].numpy(), device="cpu")
    noise = gpode.sample_draw_noise(params.gp, args.num_features, 3,
                                    torch.Generator().manual_seed(4))
    return scorer, view, noise


def _solve_stats(monkeypatch) -> list:
    """The `ODEStats` of every solve the flow runs from now on."""
    seen = []

    def recorded(*args, **kw):
        xs, stats = ode.odeint(*args, **kw)
        seen.append(stats)
        return xs, stats

    monkeypatch.setattr(tflow, "odeint", recorded)
    return seen


def test_spans_are_named_once_under_the_program_prefix():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(n.startswith("gpode.") for n in profiling.SPANS)
    assert SOLVE_RANGE in profiling.SPANS


def test_no_profiler_means_the_shared_no_op(monkeypatch):
    """With no profiler every span is one shared no-op context, and the
    program never calls `record_function`: a captured step's rehearsal with
    rejects (eager warm-up, accept reads, the reject's adaptive fallback)
    and a prediction request run with it made to raise."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert all(profiling.span(n) is profiling._NO_SPAN
               for n in profiling.SPANS)
    _, _, _, step = _train(SMALL_ARGS["official"], True, REJECT_AT)
    assert step.rejects == len(REJECT_AT)
    scorer, view, noise = _scorer_problem()
    assert all(np.isfinite(float(v)) for v in scorer(view, noise))


def test_a_span_under_a_profiler_is_recorded():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("gpode.step"):
            with profiling.span("gpode.step.copy_in"):
                torch.ones(2).sum()
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["gpode.step", "gpode.step.copy_in"]
    assert _inside(spans[1], spans[0])


@pytest.mark.parametrize("stretch", [(), REJECT_AT], ids=["accepted", "rejects"])
def test_captured_rehearsal_records_its_reads_and_eager_steps(stretch):
    """The official step's CPU rehearsal: one `accept_read` per step after
    the warm-up, one `eager` per warm-up step and per reject, one `copy_in`
    per step after the warm-up, each inside its `gpode.step`; no graph is
    replayed on the CPU."""
    (_, _, _, step), spans = _profiled(
        lambda: _train(SMALL_ARGS["official"], True, stretch))
    steps = [s for s in spans if s[0] == "gpode.step"]
    assert len(steps) == N_STEPS
    assert _count(spans, "gpode.step.accept_read") == step.host_reads
    assert step.host_reads == N_STEPS - capture.WARMUP
    assert _count(spans, "gpode.step.eager") == capture.WARMUP + step.rejects
    assert step.rejects == len(stretch)
    assert _count(spans, "gpode.step.copy_in") == N_STEPS - capture.WARMUP
    assert _count(spans, "gpode.step.replay") == 0
    for name in ("gpode.step.accept_read", "gpode.step.eager",
                 "gpode.step.copy_in"):
        assert sum(len(_children(spans, s, name)) for s in steps) == (
            _count(spans, name))
    # a reject's eager step runs the adaptive fallback: its attempts
    fallback = [a for e in spans if e[0] == "gpode.step.eager"
                for a in _children(spans, e, "gpode.solve.attempt")]
    assert bool(fallback) == bool(stretch)


def test_fast_rehearsal_has_no_accept_read():
    (_, _, _, step), spans = _profiled(
        lambda: _train(SMALL_ARGS["fast"], True))
    assert step.host_reads == 0
    assert _count(spans, "gpode.step.accept_read") == 0
    assert _count(spans, "gpode.step.eager") == capture.WARMUP
    assert _count(spans, "gpode.step") == N_STEPS


def test_eager_step_phases_in_order():
    """One eager official step: the states, the draw, the segments' solve
    and the ELBO inside the loss, then the backward and Adam, each once."""
    args = SMALL_ARGS["official"]
    params, ys, ts = _problem(args)
    step = tt.make_train_step(shooting_loss_fn(args, kernels=True), params,
                              tt.default_optimizer(params, 5e-3))
    noise = sample_step_noise(params, args.num_features, args.num_samples,
                              torch.Generator().manual_seed(1))
    _, spans = _profiled(lambda: step(noise, ys, ts))
    phases = ["gpode.states", "gpode.draw", SOLVE_RANGE, "gpode.elbo",
              "gpode.backward", "gpode.adam"]
    assert [s[0] for s in spans] == phases
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_request_spans_nest_and_count_the_attempts(monkeypatch):
    """A scorer call: `gpode.predict` holds the draw and the solve; the
    solve holds every attempt, each attempt exactly one error read; the
    attempts are the solve's `num_attempted`."""
    scorer, view, noise = _scorer_problem()
    seen = _solve_stats(monkeypatch)
    _, spans = _profiled(lambda: scorer(view, noise))
    (predict,) = [s for s in spans if s[0] == "gpode.predict"]
    for name in ("gpode.draw", "gpode.solve"):
        assert len(_children(spans, predict, name)) == 1, name
    (solve,) = _children(spans, predict, "gpode.solve")
    attempts = _children(spans, solve, "gpode.solve.attempt")
    assert len(attempts) == _count(spans, "gpode.solve.attempt") > 1
    for a in attempts:
        assert len(_children(spans, a, "gpode.solve.error_read")) == 1
    assert _count(spans, "gpode.solve.error_read") == len(attempts)
    assert [s.num_attempted for s in seen] == [len(attempts)]


@pytest.mark.parametrize("first_step", [None, ode.FIRST_STEP_SPAN, 0.05],
                         ids=["heuristic", "whole_span", "set"])
def test_attempt_spans_equal_num_attempted(first_step):
    """odeint's dopri5 on a stiff-ish decay: every attempt, accepted or
    rejected, is one `gpode.solve.attempt` with one error read."""
    x0 = torch.linspace(0.5, 2.0, 6).reshape(3, 2)
    ts = torch.tensor([0.0, 0.3, 1.0])
    (xs, stats), spans = _profiled(lambda: ode.odeint(
        lambda t, x: -40.0 * x + torch.sin(x), x0, ts, solver="dopri5",
        rtol=1e-5, atol=1e-6, first_step=first_step))
    assert torch.isfinite(xs).all()
    assert _count(spans, "gpode.solve") == 1
    assert _count(spans, "gpode.solve.attempt") == stats.num_attempted
    assert _count(spans, "gpode.solve.error_read") == stats.num_attempted
    if first_step == ode.FIRST_STEP_SPAN:
        assert stats.num_accepted < stats.num_attempted   # rejects counted


def test_every_recorded_name_is_a_listed_span(monkeypatch):
    """A rehearsed step with a reject, an eager step and a request record
    only names of `SPANS`, none of the benchmark's `bench.` prefix."""
    scorer, view, noise = _scorer_problem()
    args = SMALL_ARGS["official"]
    params, ys, ts = _problem(args)
    eager = tt.make_train_step(shooting_loss_fn(args, kernels=True), params,
                               tt.default_optimizer(params, 5e-3))
    step_noise = sample_step_noise(params, args.num_features,
                                   args.num_samples,
                                   torch.Generator().manual_seed(1))

    def run():
        _train(args, True, REJECT_AT[:1])
        eager(step_noise, ys, ts)
        scorer(view, noise)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = {e.name for e in prof.events()}
    recorded = {n for n in names if n.startswith("gpode.")}
    assert recorded <= set(profiling.SPANS)
    assert not any(n.startswith("bench.") for n in names)
    assert {"gpode.step", "gpode.step.accept_read", "gpode.step.eager",
            "gpode.draw", "gpode.states", SOLVE_RANGE, "gpode.elbo",
            "gpode.backward", "gpode.adam", "gpode.solve.attempt",
            "gpode.predict"} <= recorded


def test_collective_audit_finds_the_segment_solve():
    """The segments' solve is a span on every path now, so the audit sees
    it on a single-process eager step (no collectives to find)."""
    args = SMALL_ARGS["fast"]
    params, ys, ts = _problem(args)
    step = tt.make_train_step(shooting_loss_fn(args, kernels=True), params,
                              tt.default_optimizer(params, 5e-3))
    gen = torch.Generator().manual_seed(2)
    report = collective_audit.audit(
        lambda: step(sample_step_noise(params, args.num_features,
                                       args.num_samples, gen), ys, ts),
        steps=2)
    assert report["solves"] == 2 and report["collectives"] == []
    collective_audit.assert_solves_collective_free(report, 0)


def _untraced() -> dict:
    return {k: tuple(v) for k, v in profiling.UNTRACED.items()}


def _added(before: dict) -> dict:
    """{name: (calls, seconds)} added to `UNTRACED` since `before`."""
    return {k: (v[0] - before[k][0], v[1] - before[k][1])
            for k, v in profiling.UNTRACED.items()}


def test_clocked_spans_are_named_spans():
    assert set(profiling.UNTRACED) <= set(profiling.SPANS)


def test_untraced_solve_counts_and_times_its_attempts(monkeypatch):
    """With no profiler a request adds each attempt and each error read to
    `UNTRACED`, as many as `num_attempted`, with the reads' seconds inside
    the attempts'; `record_function` is never called."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    scorer, view, noise = _scorer_problem()
    seen = _solve_stats(monkeypatch)
    monkeypatch.setattr(profiling, "record_function", refuse)
    before = _untraced()
    scorer(view, noise)
    added = _added(before)
    (stats,) = seen
    attempts, reads = added["gpode.solve.attempt"], added["gpode.solve.error_read"]
    assert attempts[0] == reads[0] == stats.num_attempted > 1
    assert 0.0 < reads[1] < attempts[1]
    assert added["gpode.step"] == added["gpode.step.replay"] == (0, 0.0)


def test_traced_calls_leave_the_untraced_clock_alone():
    """Under a profiler the clocked spans are recorded as spans and add
    nothing to `UNTRACED`."""
    scorer, view, noise = _scorer_problem()
    before = _untraced()
    _, spans = _profiled(lambda: (scorer(view, noise),
                                  _train(SMALL_ARGS["official"], True)))
    assert _untraced() == before
    assert _count(spans, "gpode.solve.attempt") > 1
    assert _count(spans, "gpode.step") == N_STEPS


@pytest.mark.parametrize("stretch", [(), REJECT_AT], ids=["accepted", "rejects"])
def test_untraced_rehearsal_counts_its_steps(stretch):
    """The rehearsal's calls are counted in `gpode.step`; it launches no
    graph, so `gpode.step.replay` stays as it was."""
    before = _untraced()
    _train(SMALL_ARGS["official"], True, stretch)
    added = _added(before)
    assert added["gpode.step"][0] == N_STEPS and added["gpode.step"][1] > 0
    assert added["gpode.step.replay"] == (0, 0.0)
