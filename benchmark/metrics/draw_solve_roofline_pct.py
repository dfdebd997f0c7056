"""The posterior draw's `draw_solve` kernels' roofline share: the least
time of their launches on the card (per forward and per backward the
larger of its operations over the float32 peak and its bytes over the HBM
peak, `opcounts_draw`) over the device time of every `draw_solve` kernel
in the trace, matched by name: the forward (square or packed), the
one-block backward, or the packed backward's columns, rows and
symmetrisation kernels (a backward counted once, by its first kernel). The
shape is the one the program records (`cuda_kernels.DRAW_SOLVE_SHAPES`).
None where the trace holds no such kernel, or the program records no shape
(a commit before the record) or more than one."""

from __future__ import annotations

import re

from benchmark import opcounts
from benchmark.opcounts_draw import draw_solve_bwd, draw_solve_fwd

KERNELS = re.compile(r"\bdraw_solve_(fwd|bwd)\w*_kernel")
FORWARD = re.compile(r"\bdraw_solve_fwd(_packed)?_kernel")
BACKWARD = re.compile(r"\bdraw_solve_bwd(_cols)?_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.device_time_s(KERNELS)
    _, n_fwd = ctx.trace.device_time_s(FORWARD)
    _, n_bwd = ctx.trace.device_time_s(BACKWARD)
    if seconds <= 0.0 or n_fwd + n_bwd == 0:
        return None
    from gpode_tpu_torch.ops import cuda_kernels
    shapes = getattr(cuda_kernels, "DRAW_SOLVE_SHAPES", None)
    if not shapes or len(shapes) != 1:
        return None
    (shape,) = shapes
    least = (n_fwd * opcounts.bound_s(*draw_solve_fwd(*shape))[0]
             + n_bwd * opcounts.bound_s(*draw_solve_bwd(*shape))[0])
    return 100.0 * least / seconds
