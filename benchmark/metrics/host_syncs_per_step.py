"""Synchronising CUDA calls the host makes per train step."""

from benchmark.readers import host_syncs_per_unit as read  # noqa: F401
