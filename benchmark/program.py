"""The system under test, reached through its entry points, as every model
module (`benchmark/models/`) uses it: the model's arguments, its
parameters set to the benchmark's initial values, and its train step as
the entry points take it (`train/graph_step.make_step` over the model's
loss and `default_optimizer`).

The program is imported here and in the model modules, nowhere else in
the harness.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpode_tpu_torch.train import builders, graph_step
from gpode_tpu_torch.train.trainer import default_optimizer


def model_args(config: dict) -> builders.ModelArgs:
    fields = {f.name for f in dataclasses.fields(builders.ModelArgs)}
    return builders.ModelArgs(**{k: v for k, v in config["model_args"].items()
                                 if k in fields})


def set_values(params, values: dict):
    """Every leaf of the program's freshly built `params` set to the
    benchmark's `values` (the same leaf names on both sides)."""
    named = dict(params.named_parameters())
    if set(named) != set(values):
        raise ValueError(f"the program's leaves differ from the benchmark's: "
                         f"{sorted(set(named) ^ set(values))}")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(torch.as_tensor(values[name]))
    return params


class TrainStep:
    """The program's train step over `params`: `__call__(noise)` runs one
    step on the benchmark's noise tensors (a dict, passed to the program as
    its `noise_type`) and returns the program's terms."""

    def __init__(self, config: dict, params, loss_fn, noise_type, frozen,
                 ys, ts):
        margs = model_args(config)
        self.ys, self.ts, self.noise_type = ys, ts, noise_type
        self.optimizer = default_optimizer(params, config["optimizer"]["lr"],
                                           frozen_predicate=frozen)
        self.step = graph_step.make_step(loss_fn, params, self.optimizer, margs)

    def __call__(self, noise: dict):
        return self.step(self.noise_type(**noise), self.ys, self.ts)

    def first_moment(self) -> dict:
        """Adam's first moments by leaf name, copied."""
        return {k: m.detach().clone()
                for k, m in zip(self.optimizer.names, self.optimizer.mu)}

    def stats(self) -> dict:
        """The captured step's counters, where the step is captured."""
        s = self.step
        if isinstance(s, graph_step.CapturedStep):
            return {"calls": s.calls, "replays": s.replays,
                    "rejects": s.rejects, "host_reads": s.host_reads}
        return {}


def as_tensor(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)
