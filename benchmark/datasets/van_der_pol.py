"""The Van der Pol oscillator, solved by a fixed-step float64 RK4 at 100
sub-steps per observation interval, plus Gaussian observation noise drawn
from the seed."""

from __future__ import annotations

import math

import numpy as np

from benchmark.inputs import rng


def _field(y, mu):
    x, v = y[..., 0], y[..., 1]
    return np.stack([v, -x + mu * v * (1.0 - x ** 2)], -1)


def load(spec: dict, seed: int) -> dict:
    """Noisy observations of the oscillator from `spec["x0"]`, at
    `spec["points"]` uniform times over [0, `spec["horizon"]`]."""
    ts = np.linspace(0.0, spec["horizon"], spec["points"])
    x = np.asarray(spec["x0"], dtype=np.float64)
    sub = 100
    out = [x]
    for k in range(len(ts) - 1):
        h = (ts[k + 1] - ts[k]) / sub
        for _ in range(sub):
            k1 = _field(x, spec["mu"])
            k2 = _field(x + 0.5 * h * k1, spec["mu"])
            k3 = _field(x + 0.5 * h * k2, spec["mu"])
            k4 = _field(x + h * k3, spec["mu"])
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(x)
    xs = np.stack(out, 1)                                        # (N, T, D)
    ys = xs + math.sqrt(spec["noise_variance"]) * rng(seed, 1).standard_normal(
        xs.shape)
    return {"train_latent": ys.astype(np.float32),
            "train_ts": ts.astype(np.float32)}
