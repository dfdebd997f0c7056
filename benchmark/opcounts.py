"""The yardstick's arithmetic: published peaks of one NVIDIA H100 and the
operations and bytes of the model's work, counted from shapes.

Operations count one per flop or transcendental. The rhs and VJP counts
are those of the plain chain rule of the decoupled-sampling field (per
output dim: S features of 2 Din + 3 flops and a cosine, M inducing points
of 3 Din + 3 flops and an exponential; the VJP's 6 Din + 13 and 14 Din + 9
with a sine and a cosine, and an exponential). A whole-span dopri5 attempt
is 7 field evaluations forward and 6 VJPs backward (the 7th stage only
feeds the error estimate). Bytes count each input read once and each
output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (the program
# runs float32 with TF32 off), and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
DP_FWD_EVALS, DP_BWD_VJPS = 7, 6


def rhs_ops(n, din, d, m, s):
    return n * d * (s * (2 * din + 3) + m * (3 * din + 3)) + n * d * (s + m)


def vjp_ops(n, din, d, m, s):
    return n * d * (s * (6 * din + 13) + m * (14 * din + 9)) + n * d * (2 * s + m)


def gram_ops(n, din, d, m):
    return n * d * m * (3 * din + 3) + n * d * m


def param_floats(din, d, m, s):
    """The field's operands: Z, lengthscales, variances, frequencies,
    phases, weights and nu."""
    return m * din + d * din + d + din * s * d + 2 * s * d + d * m


def bound_s(ops, nbytes):
    """The least time the card could take: (seconds, "operations" or
    "bytes")."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dp_attempt_fwd(n, din, d, m, s):
    """(operations, bytes) of one attempt forward launch over n rows."""
    pf = param_floats(din, d, m, s)
    return (DP_FWD_EVALS * rhs_ops(n, din, d, m, s),
            4 * (n * din + pf + 2 * n * d + 6 * n * din))


def dp_attempt_bwd(n, din, d, m, s):
    """(operations, bytes) of one attempt backward launch over n rows."""
    pf = param_floats(din, d, m, s)
    return (DP_BWD_VJPS * vjp_ops(n, din, d, m, s),
            4 * (6 * n * din + n * d + pf + n * din + pf))


def cholesky_ops(m):
    return m ** 3 / 3.0


def shooting_step_ops(config: dict, shapes: dict, nfe: float) -> float:
    """Model operations of one shooting train step: `nfe` field
    evaluations over the segment rows forward, one VJP for each but the
    seventh of every attempt, the field draw (K(Z, Z), its Cholesky, the
    prior at Z and two triangular solves) forward and backward, the state
    samples and factors, the projection and likelihood, and Adam's update
    of every parameter. Recomputation is not counted."""
    margs = config["model_args"]
    n_seq, t, d = shapes["ys"]
    full = shapes["ys_full"][-1]
    m, s = margs["num_inducing"], margs["num_features"]
    rows = margs["num_samples"] * n_seq * t
    attempts = nfe / DP_FWD_EVALS
    solve = (nfe * rhs_ops(rows, d, d, m, s)
             + attempts * DP_BWD_VJPS * vjp_ops(rows, d, d, m, s))
    draw = (gram_ops(m, d, d, m) + d * cholesky_ops(m) + rhs_ops(m, d, d, 0, s)
            + 2 * d * m * m)
    states = rows * (2 * d * d + 2 * d) + n_seq * t * (d ** 3 + 2 * cholesky_ops(d))
    likelihood = rows * (2 * d * full + 2 * d + 6 * full)
    params = (2 * m * d + d * m * (m + 1) // 2 + d * d + d
              + n_seq * t * (d + d * (d + 1) // 2) + full + d * full + 2 * d + 1)
    adam = 12 * params
    return solve + 3 * (draw + states + likelihood) + adam
