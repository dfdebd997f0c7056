"""Optimization-trace scalar meter.

Counterpart of `gpode_tpu/utils/meters.py` (a copy: the port imports nothing
of the JAX package). One accumulator covers every trace the training loop
records: a smoothing rule — arithmetic mean or exponential moving average —
plus an always-on (iteration, value) history for trace dumps.
"""

from __future__ import annotations


class Meter:
    """Scalar stream summary with per-iteration history.

    mode="mean": `avg` is the running arithmetic mean of all updates (weighted
    by `weight`), `sum` the weighted total.
    mode="ema":  `avg` is an exponential moving average with the given
    momentum, seeded by the first update (momentum 0.98 for the train
    traces).
    """

    def __init__(self, mode: str = "mean", momentum: float = 0.98):
        if mode not in ("mean", "ema"):
            raise ValueError(f"unknown meter mode {mode!r}")
        self.mode = mode
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val: float | None = None  # most recent update
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.vals: list[float] = []
        self.iters: list[int] = []

    def update(self, val: float, iteration: int = 0, weight: int = 1):
        first = self.val is None
        self.val = val
        self.sum += val * weight
        self.count += weight
        if self.mode == "mean":
            self.avg = self.sum / self.count
        else:
            self.avg = val if first else (
                self.momentum * self.avg + (1.0 - self.momentum) * val)
        self.vals.append(val)
        self.iters.append(iteration)

    def __bool__(self) -> bool:
        return bool(self.vals)
