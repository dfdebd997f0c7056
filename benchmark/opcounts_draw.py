"""The posterior draw's work in the `draw_solve` kernels, counted from
shapes as `opcounts` counts the train step's: B factors of M x M, each
with R right-hand columns (one per draw). The forward factors K + jitter I
(M^3 / 3) and makes two vector solves a column (M^2 each); it reads K, u
and v once and writes L, a and nu. The backward makes two vector solves a
column, the rank-2R P (4 R M^2), the two M-column solves of the
Cholesky's VJP (M^3 each) and the symmetrisation (M^2); it reads L, a, v
and g_nu once and writes g_K, g_u and g_v. A work matrix that a kernel
stages in global memory is not counted: it is no operand of the draw."""

from __future__ import annotations

from benchmark.opcounts import cholesky_ops


def draw_solve_fwd(b, m, r):
    """(operations, bytes) of one forward launch."""
    return (b * (cholesky_ops(m) + 2 * r * m * m),
            4 * b * (2 * m * m + 4 * r * m))


def draw_solve_bwd(b, m, r):
    """(operations, bytes) of one backward (its launches together)."""
    return (b * (2 * r * m * m + 4 * r * m * m + 2 * m ** 3 + m * m),
            4 * b * (2 * m * m + 6 * r * m))
