"""The host's time per train step in the captured step's accept read
(`gpode.step.accept_read` spans; profiler)."""

from benchmark.spans import accept_wait_ms_per_step as read  # noqa: F401
