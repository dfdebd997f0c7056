"""The frozen operation counts and peaks: the dopri5 attempt kernels'
bounds at N=3000, Din=D=5, M=100, S=256 are the kernel table's 0.00859 ms
(forward, 7 field evaluations) and 0.0262 ms (backward, 6 VJPs)."""

import pytest

from benchmark import opcounts


def test_attempt_bounds():
    fwd_s, fwd_by = opcounts.bound_s(*opcounts.dp_attempt_fwd(3000, 5, 5, 100, 256))
    bwd_s, bwd_by = opcounts.bound_s(*opcounts.dp_attempt_bwd(3000, 5, 5, 100, 256))
    assert 1e3 * fwd_s == pytest.approx(0.00859, abs=5e-6)
    assert 1e3 * bwd_s == pytest.approx(0.0262, abs=5e-5)
    assert fwd_by == bwd_by == "operations"


def test_peaks_and_counts():
    assert opcounts.PEAK_F32_FLOPS == 67e12
    assert opcounts.PEAK_HBM_BYTES == 3.35e12
    assert opcounts.rhs_ops(1, 1, 1, 1, 1) == 5 + 6 + 2
    assert opcounts.vjp_ops(1, 1, 1, 1, 1) == 19 + 23 + 3
    assert opcounts.gram_ops(1, 1, 1, 1) == 7


def test_shooting_step_ops():
    cfg = {"model": "shooting",
           "model_args": {"num_inducing": 100, "num_features": 256,
                          "num_samples": 5}}
    shapes = {"ys": (6, 100, 5), "ys_full": (6, 100, 50)}
    ops = opcounts.shooting_step_ops(cfg, shapes, 7)
    solve = 7 * opcounts.rhs_ops(3000, 5, 5, 100, 256) + 6 * opcounts.vjp_ops(
        3000, 5, 5, 100, 256)
    assert solve < ops < 1.02 * solve
