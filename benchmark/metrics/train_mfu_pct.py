"""The whole train step's model operations per wall second, as a share of
one H100's float32 peak."""

from benchmark.readers import step_mfu_pct as read  # noqa: F401
