"""Adaptive dopri5 attempts per prediction request (`gpode.solve.attempt`
spans; profiler)."""

from benchmark.spans import solve_attempts_per_request as read  # noqa: F401
