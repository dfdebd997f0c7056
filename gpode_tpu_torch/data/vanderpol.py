"""Van der Pol oscillator simulators (uniform and non-uniform observation
times). Counterpart of `gpode_tpu/data/vanderpol.py`: identical dynamics, RNG
seeds (noise 121, init 123, times 122) and split layout. Simulation runs on
the host under the JAX package's branch rule: the native host library's
adaptive DP5(4) (`utils/native.py`) where it loads, scipy's LSODA where it
does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.integrate import odeint as scipy_odeint

from gpode_tpu_torch.data.common import Split
from gpode_tpu_torch.utils import native


def vdp_rhs(y, t, mu=0.5):
    """Van der Pol vector field."""
    return [y[1], -y[0] + mu * y[1] * (1.0 - y[0] ** 2)]


def _simulate(x0: np.ndarray, ts: np.ndarray, mu: float) -> np.ndarray:
    if native.available():
        return np.stack([native.integrate("vdp", xi, ts, params=(mu,))
                         for xi in x0])
    return np.stack([scipy_odeint(vdp_rhs, xi, ts, args=(mu,)) for xi in x0])


class VanderPol:
    """Uniform-grid VDP dataset with train/test/new-x0 splits."""

    def __init__(self, s_train: int = 30, t_train: float = 6.0,
                 s_test: Optional[int] = None, t_test: Optional[float] = None,
                 noise_var: float = 0.1,
                 x0: np.ndarray = np.array([[-1.5, 2.5]]), mu: float = 0.5):
        noise_rng = np.random.RandomState(121)
        init_rng = np.random.RandomState(123)
        s_test = s_train if s_test is None else s_test
        t_test = t_train if t_test is None else t_test

        self.xlim = (-3.5, 3.5)
        self.ylim = (-3.5, 3.5)
        self.mu = mu
        self.x0 = np.asarray(x0, dtype=np.float64)
        self.noise_var = noise_var
        self.new_x0 = self.x0 + init_rng.normal(size=(100, 2)) * 0.2

        ts_train = np.linspace(0.0, 1.0, s_train) * t_train
        ts_test = np.linspace(0.0, 1.0, s_test) * t_test
        xs_train = _simulate(self.x0, ts_train, mu)
        xs_test = _simulate(self.x0, ts_test, mu)
        xs_new = _simulate(self.new_x0, ts_train, mu)

        xs_train = xs_train + noise_rng.normal(size=xs_train.shape) * noise_var ** 0.5

        self.trn = Split(ys=xs_train, ts=ts_train)
        self.tst = Split(ys=xs_test, ts=ts_test)
        self.tst_new_x0 = Split(ys=xs_new, ts=ts_train)

    def f(self, y, t=None):
        return np.asarray(vdp_rhs(y, t, self.mu))


class VanderPolNonUniform:
    """VDP observed at sorted random times; exercises the solvers'
    non-uniform-grid path."""

    def __init__(self, s_train: int = 25, t_train: float = 7.0,
                 s_test: Optional[int] = None, t_test: Optional[float] = None,
                 noise_var: float = 0.1,
                 x0: np.ndarray = np.array([[-1.5, 2.5]]), mu: float = 0.5):
        noise_rng = np.random.RandomState(121)
        ts_rng = np.random.RandomState(122)
        s_test = s_train if s_test is None else s_test
        t_test = t_train if t_test is None else t_test

        self.xlim = (-3.5, 3.5)
        self.ylim = (-3.5, 3.5)
        self.mu = mu
        self.x0 = np.asarray(x0, dtype=np.float64)
        self.noise_var = noise_var

        ts_train = np.sort(ts_rng.random_sample(s_train)) * t_train
        ts_train[0] = 0.0
        ts_test = np.sort(ts_rng.random_sample(s_test)) * (t_test - t_train) + t_train

        xs_train = _simulate(self.x0, ts_train, mu)
        xs_test = _simulate(self.x0, np.insert(ts_test, 0, 0.0), mu)[:, 1:]
        xs_train = xs_train + noise_rng.normal(size=xs_train.shape) * noise_var ** 0.5

        self.trn = Split(ys=xs_train, ts=ts_train)
        self.tst = Split(ys=xs_test, ts=ts_test)

    def f(self, y, t=None):
        return np.asarray(vdp_rhs(y, t, self.mu))
