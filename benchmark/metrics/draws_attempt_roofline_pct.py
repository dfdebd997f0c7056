"""The batched-draw dopri5 attempt kernel's roofline share: its launches'
least time on the card (per launch the larger of its operations over the
float32 peak and its bytes over the HBM peak, `opcounts_eval`) over the
device time of the kernel and of its fixed-order reduction in the trace,
matched by name. The launch's shape is the one the program records
(`cuda_kernels.DRAWS_ATTEMPT_SHAPES`). None where the trace holds no such
kernel (a commit before it) or the program launched more than one shape."""

from __future__ import annotations

import re

from benchmark import opcounts
from benchmark.opcounts_eval import dp_attempt_draws

KERNELS = re.compile(r"\bdraws_(attempt|ratio)_kernel")
ATTEMPT = re.compile(r"\bdraws_attempt_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.device_time_s(KERNELS)
    _, launches = ctx.trace.device_time_s(ATTEMPT)
    if seconds <= 0.0 or launches == 0:
        return None
    from gpode_tpu_torch.ops import cuda_kernels
    shapes = getattr(cuda_kernels, "DRAWS_ATTEMPT_SHAPES", None)
    if not shapes or len(shapes) != 1:
        return None
    (shape,) = shapes
    least = launches * opcounts.bound_s(*dp_attempt_draws(*shape))[0]
    return 100.0 * least / seconds
