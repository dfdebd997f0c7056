"""The share of traced train steps that ran eagerly after a reject
(`gpode.step.eager` spans; profiler)."""

from benchmark.spans import rejected_steps_pct as read  # noqa: F401
