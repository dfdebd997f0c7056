"""Model `vanilla`: the vanilla GP-ODE (`models/gpode.py` of the program),
one q(x0) sample and one field draw per step, the whole trajectory by the
host-controlled adaptive solve; it serves no prediction requests here."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs, program
from gpode_tpu_torch.models import gpode
from gpode_tpu_torch.train import builders


def init_values(config: dict, data: dict, seed: int) -> dict:
    init = config["init"]
    d = data["train_latent"].shape[-1]
    x0_mean, x0_tril = inputs.x0_values(data, init["state_scale"])
    vals = inputs.gp_values(config, data, seed)
    vals.update({
        "x0.mean": x0_mean,
        "x0.tril_packed": x0_tril,
        "likelihood.raw_variance": np.full(
            d, inputs.invsoftplus(init["noise_variance"]), np.float32),
    })
    return vals


def train_batch(data: dict, device) -> tuple:
    """The step's targets are the observed states themselves."""
    ys = data["train_latent"]
    return (program.as_tensor(ys, device),
            program.as_tensor(data["train_ts"], device), {"ys": ys.shape})


def train_noise(config: dict, shapes: dict, gen: torch.Generator,
                device) -> dict:
    margs = config["model_args"]
    n, _, d = shapes["ys"]
    noise = inputs.draw_noise(gen, device, (), d, margs["num_features"], d,
                              margs["num_inducing"])
    noise["x0"] = torch.randn(n, d, generator=gen, device=device)
    return noise


def build_params(config: dict, data: dict, values: dict, device):
    params = builders.build_gpode(torch.Generator().manual_seed(0),
                                  program.model_args(config),
                                  data["train_latent"], device=device)
    return program.set_values(params, values)


def train_step(config: dict, params, ys, ts) -> program.TrainStep:
    margs = program.model_args(config)
    return program.TrainStep(config, params, builders.gpode_loss_fn(margs),
                             gpode.GPODEStepNoise, None, ys, ts)
