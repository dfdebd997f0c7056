"""The share of the shooting states' entropy calls that ran in the
`state_entropy` kernels: 100 x "state_device" over all calls on the
program's counter (`gpode_tpu_torch/ops/cuda_kernels.py` `STATE_ENTROPIES`:
"state_device", the kernels; "state_unrolled", the unrolled Cholesky chain;
a captured graph's replays counted as its capture). None off the card, where
the program keeps no such counter (a program before the kernels) or took no
entropy."""

from __future__ import annotations


def read(ctx):
    if not ctx.on_device:
        return None
    from gpode_tpu_torch.ops import cuda_kernels
    calls = getattr(cuda_kernels, "STATE_ENTROPIES", None)
    if not calls:
        return None
    total = calls["state_device"] + calls["state_unrolled"]
    if total == 0:
        return None
    return 100.0 * calls["state_device"] / total
