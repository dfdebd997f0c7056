"""Shared dataset containers. Counterpart of `gpode_tpu/data/common.py`."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Split:
    """One data split: observations (N, T, D) and times (T,), float32 on host."""

    ys: np.ndarray
    ts: np.ndarray

    def __post_init__(self):
        self.ys = np.asarray(self.ys, dtype=np.float32)
        self.ts = np.asarray(self.ts, dtype=np.float32)

    def __len__(self) -> int:
        return self.ys.shape[0]
