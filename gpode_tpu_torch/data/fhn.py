"""FitzHugh-Nagumo dataset. Counterpart of `gpode_tpu/data/fhn.py`: the same
dynamics, noise seed (121) and split layout, and the loader of the shipped
interpolation splits (`data/fhn/fhn_interpolation[_small].npz`, with their
observation masks). Simulation runs on the host under the JAX package's
branch rule: the native host library (`utils/native.py`) where it loads,
scipy's LSODA where it does not.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy.integrate import odeint as scipy_odeint

from gpode_tpu_torch.data.common import Split
from gpode_tpu_torch.utils import native


def fhn_rhs(y, t=None):
    """FitzHugh-Nagumo vector field."""
    return [3.0 * (y[0] - y[0] ** 3 / 3.0 + y[1]),
            (1.0 / 3.0) * (0.2 - 3.0 * y[0] - 0.2 * y[1])]


class FHN:
    """Simulated FHN train/test splits; the test horizon defaults to twice
    the train horizon."""

    def __init__(self, s_train: int = 30, t_train: float = 6.0,
                 s_test: Optional[int] = None, t_test: Optional[float] = None,
                 noise_var: float = 0.1,
                 x0: np.ndarray = np.array([[-1.0, -1.0]])):
        noise_rng = np.random.RandomState(121)
        s_test = 2 * s_train if s_test is None else s_test
        t_test = 2.0 * t_train if t_test is None else t_test

        self.xlim = (-2.5, 2.5)
        self.ylim = (-2.0, 2.0)
        self.x0 = np.asarray(x0, dtype=np.float64)
        self.noise_var = noise_var

        ts_train = np.linspace(0.0, 1.0, s_train) * t_train
        ts_test = np.linspace(0.0, 1.0, s_test) * t_test
        xs_train = np.stack([self._simulate(xi, ts_train) for xi in self.x0])
        xs_test = np.stack([self._simulate(xi, ts_test) for xi in self.x0])
        xs_train = xs_train + noise_rng.normal(size=xs_train.shape) * noise_var ** 0.5

        self.trn = Split(ys=xs_train, ts=ts_train)
        self.tst = Split(ys=xs_test, ts=ts_test)

    @staticmethod
    def _simulate(x0, ts):
        if native.available():
            return native.integrate("fhn", x0, ts)
        return scipy_odeint(fhn_rhs, x0, ts)

    def f(self, y, t=None):
        return np.asarray(fhn_rhs(y, t))


def load_fhn_interpolation(path: str, small: bool = False) -> dict:
    """The shipped FHN interpolation split with its observation masks: a
    dict of the arrays of `fhn_interpolation[_small].npz` in `path`."""
    fname = "fhn_interpolation_small.npz" if small else "fhn_interpolation.npz"
    with np.load(os.path.join(path, fname)) as data:
        return {k: data[k] for k in data.files}
