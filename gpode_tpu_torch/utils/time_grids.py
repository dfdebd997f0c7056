"""Observation-time-grid helpers. Counterpart of `gpode_tpu/utils/time_grids.py`."""

from __future__ import annotations

import torch


def insert_zero_t0(ts: torch.Tensor, dt=None) -> torch.Tensor:
    """Prepend a t=0 point, shifting all observation times by one interval:
    ts -> [0, ts + dt] with dt = ts[1] - ts[0] by default — the initial
    state lives one interval before the first observation. `dt` overrides
    the shift (evaluation on a grid whose first interval differs from the
    training grid's passes the training grid's first interval)."""
    if dt is None:
        dt = ts[1] - ts[0]
    return torch.cat([ts.new_zeros(1), ts + dt])


def substeps_from_dense_scale(ts_dense_scale: int) -> int:
    """Fixed-step sub-steps per observation interval implied by the
    reference's `ts_dense_scale` densification (`scale - 1` steps per
    interval; scale <= 1 means the raw grid)."""
    return max(1, ts_dense_scale - 1)
