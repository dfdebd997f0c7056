"""Kernels, copies and sets the device runs per train step (profiler)."""

from benchmark.readers import device_events_per_unit as read  # noqa: F401
