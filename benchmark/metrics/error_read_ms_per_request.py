"""The host's time per prediction request waiting on the device in the
attempts' error reads (`gpode.solve.error_read` spans; profiler)."""

from benchmark.spans import error_read_ms_per_request as read  # noqa: F401
