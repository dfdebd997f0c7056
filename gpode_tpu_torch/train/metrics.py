"""Predictive summary metrics: mixture log-likelihood and MSE.

Counterpart of `gpode_tpu/train/metrics.py`: given S posterior-predictive
sample trajectories,

    MLL = mean over points of  logsumexp_s N(y; pred_s, noise_var) - log S
    MSE = mean over points of  (y - mean_s pred_s)^2

`compute_summary` is the host version (numpy/scipy, float64 where numpy
promotes); `mixture_summary_device` the same math in float32 on the device,
so an evaluation hands the host two scalars instead of the predictions.
`compute_mse` (deterministic predictions) and `compute_calibration` (the
predictive mixture's interval coverage) are host numpy/scipy, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import logsumexp
from scipy.stats import norm


def compute_summary(actual: np.ndarray, predicted: np.ndarray,
                    noise_var: np.ndarray, ys_scale=1.0):
    """actual (N,T,D), predicted (S,N,T,D), noise_var (D,) -> (mll, mse)."""
    actual = np.asarray(actual) * ys_scale
    predicted = np.asarray(predicted) * ys_scale
    noise_var = np.asarray(noise_var) * np.asarray(ys_scale) ** 2 + 1e-8

    lik_samples = norm.logpdf(actual, loc=predicted, scale=noise_var ** 0.5)
    mll = logsumexp(lik_samples, 0, b=1.0 / float(predicted.shape[0])).mean()
    mse = np.power(actual - predicted.mean(0), 2).mean()
    return float(mll), float(mse)


def mixture_summary_device(actual: torch.Tensor, predicted: torch.Tensor,
                           noise_var: torch.Tensor):
    """`compute_summary` on the device: (actual (N,T,D), predicted
    (S,N,T,D), noise_var (D,)) -> (mll, mse) 0-d tensors, float32."""
    nv = noise_var + 1e-8
    log_norm = -0.5 * torch.log(2.0 * math.pi * nv)
    lik = log_norm - 0.5 * torch.square(actual[None] - predicted) / nv
    mll = torch.mean(torch.logsumexp(lik, dim=0) - math.log(predicted.shape[0]))
    mse = torch.mean(torch.square(actual - predicted.mean(0)))
    return mll, mse


def compute_mse(actual: np.ndarray, predicted: np.ndarray, ys_scale=1.0) -> float:
    """Deterministic-prediction MSE (the NeuralODE baseline's metric)."""
    actual = np.asarray(actual) * ys_scale
    predicted = np.asarray(predicted) * ys_scale
    return float(np.power(actual - predicted, 2).mean())


def compute_calibration(actual: np.ndarray, predicted: np.ndarray,
                        noise_var: np.ndarray,
                        levels=(0.5, 0.9, 0.95)) -> dict:
    """Empirical central-interval coverage of the predictive mixture.

    The predictive distribution at each point is the S-component Gaussian
    mixture sum_s N(y; pred_s, noise_var)/S, the one the MLL scores. Its PIT
    value is u = mean_s Phi((y - pred_s)/sigma); a point lies inside the
    central q-interval iff |u - 1/2| <= q/2, so the coverage at level q is
    mean(|u - 1/2| <= q/2) (about q when calibrated).

    Returns {"coverage": {q: frac}, "pit_mae": mean |u - 1/2| (0.25 when
    calibrated, -> 0 over-dispersed, -> 0.5 over-confident)}.
    """
    actual = np.asarray(actual)
    predicted = np.asarray(predicted)
    sigma = np.sqrt(np.asarray(noise_var) + 1e-12)
    pit = norm.cdf((actual[None] - predicted) / sigma).mean(0)  # (N,T,D)
    dev = np.abs(pit - 0.5)
    return {
        "coverage": {float(q): float((dev <= q / 2).mean()) for q in levels},
        "pit_mae": float(dev.mean()),
    }
