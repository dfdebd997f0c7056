"""Observation-time-grid helpers. Counterpart of `gpode_tpu/utils/time_grids.py`."""

from __future__ import annotations


def substeps_from_dense_scale(ts_dense_scale: int) -> int:
    """Fixed-step sub-steps per observation interval implied by the
    reference's `ts_dense_scale` densification (`scale - 1` steps per
    interval; scale <= 1 means the raw grid)."""
    return max(1, ts_dense_scale - 1)
