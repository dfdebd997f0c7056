"""Kernels, copies and sets the device runs per prediction request
(profiler)."""

from benchmark.readers import device_events_per_unit as read  # noqa: F401
