"""Readings of the program's own spans, shared by several per-layer metric
files: in a `--trace 1` run's trace, and on the host's clock over the
run's untraced calls.

The program marks its parts with `record_function` ranges under an active
profiler (`gpode_tpu_torch/utils/profiling.SPANS`, every name under the
prefix `gpode.`): they are host events of the category `user_annotation`,
on the same clock as the device's kernels, copies and sets. The names are
written out here, not imported, so that a program that records none of
them reads as nothing: each reading is None where the trace holds no span
of the part it reads (the captured step's `gpode.step`, a request's
`gpode.predict`), and the metric is left out of the result line.

A traced span pays the profiler's own cost: a graph launch or an attempt's
dispatch takes several times as long under it. So the host times of those
are read from `profiling.UNTRACED`, the calls and host seconds the program
sums over the clocked spans that ran with no profiler active: the window,
the warm-up and the compared steps or requests. Where the program keeps no
such clock (a commit before it) or made no such call, or off the card,
the reading is None.
"""

from __future__ import annotations

STEP = "gpode.step"
REPLAY = "gpode.step.replay"
ACCEPT_READ = "gpode.step.accept_read"
EAGER = "gpode.step.eager"
PREDICT = "gpode.predict"
ATTEMPT = "gpode.solve.attempt"
ERROR_READ = "gpode.solve.error_read"


def host_spans(trace, name: str) -> list:
    """[(thread, start us, end us)] of the spans `name` that start inside
    the traced window, by thread and start."""
    return sorted((e.get("tid"), float(e["ts"]),
                   float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in trace.host
                  if e.get("cat") == "user_annotation" and e["name"] == name
                  and trace.t0 <= float(e["ts"]) <= trace.t1)


def _ms_per_unit(trace, us: float) -> float:
    return 1e-3 * us / trace.units


def _total_us(spans) -> float:
    return sum(end - start for _, start, end in spans)


def _holding(ctx, name: str):
    """The trace, where it holds a span `name` (the captured step's, a
    request's), else None."""
    if ctx.trace is None or not host_spans(ctx.trace, name):
        return None
    return ctx.trace


def accept_wait_ms_per_step(ctx):
    """The host's time per traced step in the accept read: blocked until
    graph A's device work has ended."""
    trace = _holding(ctx, STEP)
    if trace is None:
        return None
    return _ms_per_unit(trace, _total_us(host_spans(trace, ACCEPT_READ)))


def rejected_steps_pct(ctx):
    """100 x eager steps over traced steps: past the warm-up, a step that
    runs eagerly threw its graph A away on a reject."""
    trace = _holding(ctx, STEP)
    if trace is None:
        return None
    return 100.0 * len(host_spans(trace, EAGER)) / trace.units


def solve_attempts_per_request(ctx):
    """Adaptive dopri5 attempts per traced request."""
    trace = _holding(ctx, PREDICT)
    if trace is None:
        return None
    return len(host_spans(trace, ATTEMPT)) / trace.units


def error_read_ms_per_request(ctx):
    """The host's time per traced request in the attempts' error reads:
    waiting on the device."""
    trace = _holding(ctx, PREDICT)
    if trace is None:
        return None
    return _ms_per_unit(trace, _total_us(host_spans(trace, ERROR_READ)))


def untraced(ctx, name: str):
    """(calls, host seconds) of the program's untraced calls of the span
    `name`, or None: off the card, where the program keeps no such clock,
    or where it made no such call."""
    if not ctx.on_device:
        return None
    from gpode_tpu_torch.utils import profiling
    clock = getattr(profiling, "UNTRACED", {}).get(name)
    if not clock or clock[0] == 0:
        return None
    return clock


def graph_launch_ms_per_step(ctx):
    """The host's time per untraced captured step in its graphs' launches
    (`graph.replay()`): after the accept read the device has nothing queued
    until graph B's launch puts it there."""
    steps, launches = untraced(ctx, STEP), untraced(ctx, REPLAY)
    if steps is None or launches is None:
        return None
    return 1e3 * launches[1] / steps[0]


def attempt_dispatch_ms(ctx):
    """The mean host time, in ms, of an untraced adaptive dopri5 attempt
    less its error read: the host's cost to issue the attempt's work."""
    attempts, reads = untraced(ctx, ATTEMPT), untraced(ctx, ERROR_READ)
    if attempts is None or reads is None:
        return None
    return 1e3 * (attempts[1] - reads[1]) / attempts[0]
