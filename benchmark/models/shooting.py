"""Model `shooting`: the multiple-shooting GP-ODE (`models/shooting.py` of
the program), its likelihood in the data space through the projector, its
validation requests through `train/evaluation.make_projected_scorer`."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import inputs, program
from gpode_tpu_torch.data.mocap import ProjectorArrays
from gpode_tpu_torch.models import gpode, shooting
from gpode_tpu_torch.train import builders
from gpode_tpu_torch.train.evaluation import make_projected_scorer


def init_values(config: dict, data: dict, seed: int) -> dict:
    """The GP's values, the state means at the observations, q(x0) one
    interval back, and the rest at the configuration's initial scales."""
    init, margs = config["init"], config["model_args"]
    ys = data["train_latent"]
    n, t, d = ys.shape
    f32 = np.float32
    x0_mean, x0_tril = inputs.x0_values(data, init["state_scale"])
    proj = data["projector"]
    vals = inputs.gp_values(config, data, seed)
    vals.update({
        "states.mean": ys[:, :-1].astype(f32),
        "states.tril_packed": np.tile(inputs.pack_eye(d, init["state_scale"]),
                                      (n, t - 1, 1)),
        "states.x0.mean": x0_mean,
        "states.x0.tril_packed": x0_tril,
        "likelihood.base.raw_variance": np.full(
            data["train_full"].shape[-1],
            inputs.invsoftplus(init["noise_variance"]), f32),
        "likelihood.projector.components": proj["components"].copy(),
        "likelihood.projector.norm_mean": proj["norm_mean"].copy(),
        "likelihood.projector.norm_std": proj["norm_std"].copy(),
        "constraint.raw_scale": np.full(
            1, inputs.invsoftplus(margs["constraint_initial_scale"]), f32),
    })
    return vals


def train_batch(data: dict, device) -> tuple:
    """The step's targets are the data-space sequences."""
    ys = data["train_full"]
    shapes = {"ys": data["train_latent"].shape, "ys_full": ys.shape}
    return (program.as_tensor(ys, device),
            program.as_tensor(data["train_ts"], device), shapes)


def train_noise(config: dict, shapes: dict, gen: torch.Generator,
                device) -> dict:
    """One field draw, and every state sample of every draw."""
    margs = config["model_args"]
    n, t, d = shapes["ys"]
    noise = inputs.draw_noise(gen, device, (), d, margs["num_features"], d,
                              margs["num_inducing"])
    kw = dict(generator=gen, device=device)
    s = margs["num_samples"]
    noise["x0"] = torch.randn(s, n, d, **kw)
    noise["states"] = torch.randn(s, n, t - 1, d, **kw)
    return noise


def _projector(data: dict) -> ProjectorArrays:
    proj = data["projector"]
    return ProjectorArrays(proj["components"], proj["norm_mean"],
                           proj["norm_std"])


def build_params(config: dict, data: dict, values: dict, device):
    params = builders.build_shooting(
        torch.Generator().manual_seed(0), program.model_args(config),
        data["train_latent"], projector=_projector(data),
        full_dim=data["train_full"].shape[-1], device=device)
    return program.set_values(params, values)


def train_step(config: dict, params, ys, ts) -> program.TrainStep:
    margs = program.model_args(config)
    return program.TrainStep(config, params, builders.shooting_loss_fn(margs),
                             shooting.StepNoise,
                             builders.default_frozen_predicate(margs), ys, ts)


def predict_scorer(config: dict, data: dict, split: str, device):
    """`score(params, noise) -> (ll, mse)` of the program's validation
    scorer over `split`, predictions from the observed first states."""
    margs = program.model_args(config)
    ev = config["eval"]
    cfg = dataclasses.replace(margs.solver_config(), max_steps=ev["max_steps"],
                              first_step=ev["first_step"])
    scorer = make_projected_scorer(
        cfg, _projector(data), data[f"{split}_full"], data[f"{split}_ts"],
        data[f"{split}_latent"][:, 0], device=device)

    def score(params, noise: dict):
        view = gpode.GPODEParams(params.gp, params.states.x0, params.likelihood)
        return scorer(view, gpode.PredictNoise(**noise))

    return score
