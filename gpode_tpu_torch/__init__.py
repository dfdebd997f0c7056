"""gpode_tpu_torch — the PyTorch/CUDA port of gpode_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout (`ops/`, `models/`, `train/`,
`data/`, `utils/`, `plots/`, `parallel/`) so each module's counterpart is
easy to find; `MIGRATION.md` maps the JAX package's idioms to the port's.
The hot ODE right-hand side and the whole-span dopri5 attempt run as
hand-written CUDA kernels (`csrc/`, bound in `ops/cuda_kernels.py`);
everything else is plain PyTorch.

Everything runs in full float32: the GP math (Gram matrices, Cholesky,
triangular solves) breaks at TF32 precision, exactly as the JAX package pins
`Precision.HIGHEST` for the same reason.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is requested (explicitly or by default) and no card
    is present — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gpode_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev
