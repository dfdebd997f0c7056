"""The comparisons that decide `correct`, and the readings they give.

Training (the first steps through the window's own step object, the
later of them replays of a captured step):
  * `loss`: the largest relative gap between the program's loss and the
    reference's over the compared steps;
  * `grad`: the first step's gradient as Adam took it (from Adam's first
    moment after one step, m / (1 - b1)), by the worst leaf: the gap
    between the program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf;
  * `grad_last`: the last compared step's gradient (a replay's), from the
    first moments before and after it, (m_t - b1 m_(t-1)) / (1 - b1): the
    same gap per leaf, over the leaves that `change` counts by this
    step's reference gradient, and of these the median leaf's;
    `grad_last_worst` is read but not held to a limit: the step's
    gradient is taken where the steps before it have put the parameters,
    which the rule below moves apart on both sides;
  * `change`: the parameters' change over the compared steps, the same
    gap per leaf, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off alone
    under Adam), and of these the median leaf's gap; `change_worst`, the
    worst leaf's, is read but not held to a limit: Adam moves an element
    by about the learning rate whatever the size of its gradient, so an
    element whose later gradient is near 0 flips its step on round-off,
    and in a small leaf that alone moves the leaf's norm.
Prediction requests: the largest relative gap of the mixture
log-likelihood (`ll`) and of the MSE (`mse`) over the checked requests.
"""

from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, keep=None) -> list:
    """Per leaf: |norm(program) - norm(reference)| / max(norm of the
    reference leaf, median reference leaf norm)."""
    p, r = _norms(program), _norms(reference)
    med = statistics.median(r.values())
    return [abs(p[k] - r[k]) / max(r[k], med) for k in r
            if keep is None or k in keep]


def counted_leaves(ref_grads: dict) -> set:
    """Leaves whose reference gradient norm is at least NEGLIGIBLE_GRAD of
    the median leaf's."""
    r = _norms(ref_grads)
    med = statistics.median(r.values())
    return {k for k, v in r.items() if v >= NEGLIGIBLE_GRAD * med}


def train_readings(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "grads": {leaf: tensor}, "grads_last":
    {leaf: tensor}, "change": {leaf: tensor}} -> the readings."""
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(prog["losses"], ref["losses"]))
    change = leaf_gaps(prog["change"], ref["change"], counted_leaves(ref["grads"]))
    last = leaf_gaps(prog["grads_last"], ref["grads_last"],
                     counted_leaves(ref["grads_last"]))
    return {"loss": loss,
            "grad": max(leaf_gaps(prog["grads"], ref["grads"])),
            "grad_last": statistics.median(last),
            "grad_last_worst": max(last),
            "change": statistics.median(change),
            "change_worst": max(change)}


def predict_readings(prog: list, ref: list) -> dict:
    """prog / ref: [(ll, mse), ...] of the same requests."""
    def gap(a, b):
        return abs(a - b) / abs(b) if math.isfinite(a) else math.inf

    return {"ll": max(gap(p[0], r[0]) for p, r in zip(prog, ref)),
            "mse": max(gap(p[1], r[1]) for p, r in zip(prog, ref))}


def verdict(readings: dict, limits: dict) -> bool:
    """Every reading within its limit (a missing or non-finite reading
    fails)."""
    return all(k in readings and math.isfinite(readings[k])
               and readings[k] <= lim for k, lim in limits.items())
