"""Adam and the train step. Counterpart of `default_optimizer`,
`build_frozen_mask` and `make_train_step` in `gpode_tpu/train/trainer.py`
(the `Trainer` loop, checkpoints and meters are not ported yet)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn


class Adam:
    """optax's `adam` (b1=0.9, b2=0.999, eps=1e-8, eps_root=0), optionally
    behind `clip_by_global_norm`, over the parameters of `params`.

    Parameters whose dotted name satisfies `frozen_predicate` get a zero
    gradient — their moments still decay and their value never moves, as
    with the JAX package's frozen mask. The update is written out so it
    rounds like optax: m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps), times -lr.
    """

    def __init__(self, params: nn.Module, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_clip: float = 0.0,
                 frozen_predicate: Optional[Callable[[str], bool]] = None):
        self.names, self.params = zip(*params.named_parameters())
        self.frozen = [bool(frozen_predicate and frozen_predicate(n))
                       for n in self.names]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.grad_clip = grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [torch.zeros_like(p) if (f or p.grad is None) else p.grad
                 for p, f in zip(self.params, self.frozen)]
        if self.grad_clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            grads = [torch.where(g_norm < self.grad_clip, g,
                                 g / g_norm * self.grad_clip) for g in grads]
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** self.count)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * torch.square(g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.lr * update)


def default_optimizer(params: nn.Module, lr: float, grad_clip: float = 0.0,
                      frozen_predicate=None) -> Adam:
    """The framework's Adam: optional global-norm clip, then Adam."""
    return Adam(params, lr, grad_clip=grad_clip,
                frozen_predicate=frozen_predicate)


def make_train_step(loss_fn: Callable, params: nn.Module, optimizer: Adam):
    """step(noise, *batch) -> terms: one loss, backward and Adam update of
    `params` in place. `loss_fn(params, noise, *batch)` returns
    (loss, terms)."""

    def step(noise, *batch):
        optimizer.zero_grad()
        loss, terms = loss_fn(params, noise, *batch)
        loss.backward()
        optimizer.step()
        return terms

    return step
