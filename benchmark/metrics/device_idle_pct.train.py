"""The device's idle share of the profiled train steps' wall time."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
