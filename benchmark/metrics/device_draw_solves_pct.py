"""The share of the posterior draws whose factor of K(Z, Z) and triangular
solves ran in the `draw_solve` kernels: 100 x "device" over all draws on the
program's counter (`gpode_tpu_torch/ops/cuda_kernels.py` `DRAW_SOLVES`:
"device", the kernels; "library", the library's factorisation and solves, a
draw handed a factor counted there). None off the card, where the program
keeps no such counter (a program before the kernels) or drew nothing."""

from __future__ import annotations


def read(ctx):
    if not ctx.on_device:
        return None
    from gpode_tpu_torch.ops import cuda_kernels
    draws = getattr(cuda_kernels, "DRAW_SOLVES", None)
    if not draws:
        return None
    total = draws["device"] + draws["library"]
    if total == 0:
        return None
    return 100.0 * draws["device"] / total
