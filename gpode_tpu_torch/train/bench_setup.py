"""The canonical bench problem: MoCap subject 09 shooting GPODE at the
official recipe and its named presets. Counterpart of
`gpode_tpu/train/bench_setup.py`, built with the port alone."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.data.mocap import MocapDataset, latent_to_data_projector
from gpode_tpu_torch.models.init import (initialize_inducing,
                                         initialize_kernel_parameters)
from gpode_tpu_torch.train.builders import ModelArgs, build_shooting

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def bench_model_args(scale: bool = False, fast: bool = False) -> ModelArgs:
    """The official bench recipe: 100 inducing points, 256 RFF features,
    dimwise RBF, dopri5 with a whole-span first step and an 8-attempt
    budget, 5 MC draws. `scale`: 256 inducing points and 32 MC draws
    (19200 segment rows a step) with `remat`. `fast`: the official model
    with rk4 and one step per interval (`ts_dense_scale=2`), the JAX
    package's recommended production config."""
    if scale:
        return ModelArgs(num_inducing=256, num_features=256, dimwise=True,
                         solver="dopri5", ts_dense_scale=2, max_steps=8,
                         first_step=-1.0, num_samples=32, remat=True)
    if fast:
        return ModelArgs(num_inducing=100, num_features=256, dimwise=True,
                         solver="rk4", ts_dense_scale=2, max_steps=8,
                         num_samples=5)
    return ModelArgs(num_inducing=100, num_features=256, dimwise=True,
                     solver="dopri5", ts_dense_scale=2, max_steps=8,
                     first_step=-1.0, num_samples=5)


PRESETS = ("official", "fast", "scale", "m256", "m256_fast")


def preset_model_args(name: str) -> ModelArgs:
    """Named bench presets: `official`, `fast`, `scale`, and the
    256-inducing-point versions of the first two, `m256` and `m256_fast`."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; the port has {PRESETS}")
    if name == "scale":
        return bench_model_args(scale=True)
    args = bench_model_args(fast=name.endswith("fast"))
    if name.startswith("m256"):
        args = dataclasses.replace(args, num_inducing=256)
    return args


def load_bench_data(data_dir: str | None = None):
    """(latent dataset, data-space dataset) for MoCap 09, seqlen 100,
    5 normalized PCA latents."""
    if data_dir is None:
        data_dir = os.path.join(_REPO_ROOT, "data/mocap")
    data_pca = MocapDataset(data_path=data_dir, subject="09",
                            pca_components=5, data_normalize=False,
                            pca_normalize=True, seqlen=100)
    data_full = MocapDataset(data_path=data_dir, subject="09",
                             pca_components=-1, data_normalize=False,
                             pca_normalize=False, seqlen=100)
    return data_pca, data_full


def build_bench_problem(args: ModelArgs | None = None, initialize: bool = True,
                        data_dir: str | None = None, seed: int = 0,
                        device=None):
    """Build the bench model and data: returns (args, params, ys, ts).

    `args` is any preset's `ModelArgs` (`preset_model_args`); None means
    the official recipe. The likelihood is scored in the 50-D data space
    through the projector. Parameters are drawn from a `torch.Generator` seeded with `seed` (they
    cannot equal the JAX package's, whose draws come from its own PRNG);
    `initialize` runs the kernel and inducing initialization.
    `device` defaults to CUDA and raises without a card.
    """
    device = resolve_device(device)
    data_pca, data_full = load_bench_data(data_dir)
    if args is None:
        args = bench_model_args()
    gen = torch.Generator().manual_seed(seed)
    params = build_shooting(gen, args, data_pca.trn.ys,
                            projector=latent_to_data_projector(data_pca),
                            full_dim=data_full.trn.ys.shape[-1], device=device)
    if initialize:
        initialize_kernel_parameters(params.gp)
        initialize_inducing(params.gp, data_pca.trn.ys,
                            float(data_pca.trn.ts.max()), 1e0,
                            rng=np.random.RandomState(seed))
    ys = torch.as_tensor(data_full.trn.ys, device=device)
    ts = torch.as_tensor(data_pca.trn.ts, device=device)
    return args, params, ys, ts
