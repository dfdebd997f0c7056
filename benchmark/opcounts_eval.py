"""The evaluation path's work, counted from shapes as `opcounts` counts the
train step's: one launch of the batched-draw dopri5 attempt kernel
(`dopri5_attempt_draws`) evaluates the field 6 times at every row of every
draw (k1 arrives: FSAL), reads each draw's operands once, the shared ones
once, and the states and their k1, and writes the new states, their k7,
the error ratio and reads the step."""

from __future__ import annotations

from benchmark.opcounts import rhs_ops

DP_ATTEMPT_EVALS = 6


def dp_attempt_draws(draws, n, din, d, m, s):
    """(operations, bytes) of one attempt launch over `draws` draws of n
    rows each."""
    rows = draws * n
    per_draw = din * s * d + 2 * s * d + d * m     # omega, phase, w, nu
    shared = m * din + d * din + d                 # Z, lengthscales, variance
    states = rows * (din + d) + 2 * rows * d       # x, k1 in; x_new, k7 out
    return (DP_ATTEMPT_EVALS * rhs_ops(rows, din, d, m, s),
            4 * (draws * per_draw + shared + states + 2))
