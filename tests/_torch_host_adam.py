"""The port's Adam as it was before its count moved to the device: the lr and
both bias corrections Python floats computed on the host at every update.
The tests hold the device-count `trainer.Adam` bit-equal to it (on the CPU
in `test_torch_graph_step.py`, on the card in `test_torch_gpu.py`). Imports
no JAX: the card's machine has none."""

import numpy as np
import torch


class HostFloatAdam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8,
                 grad_clip=0.0, frozen_predicate=None):
        self.names, self.params = zip(*params.named_parameters())
        self.frozen = [bool(frozen_predicate and frozen_predicate(n))
                       for n in self.names]
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = [torch.zeros_like(p) if (f or p.grad is None) else p.grad
                 for p, f in zip(self.params, self.frozen)]
        if self.grad_clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            grads = [torch.where(g_norm < self.grad_clip, g,
                                 g / g_norm * self.grad_clip) for g in grads]
        lr = float(np.float32(self.lr(self.count)))
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** self.count)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * torch.square(g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-lr * update)

    def state(self):
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)), "count": self.count}

    @torch.no_grad()
    def load_state(self, state):
        for moment, bufs in (("mu", self.mu), ("nu", self.nu)):
            for name, buf in zip(self.names, bufs):
                buf.copy_(torch.as_tensor(state[moment][name]))
        self.count = int(state["count"])


class ToyParams(torch.nn.Module):
    """Parameters of several shapes; `constraint.raw_scale` is the one the
    default frozen predicate freezes."""

    def __init__(self, device="cpu"):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Parameter(torch.randn(3, 4, generator=gen).to(device))
        self.b = torch.nn.Parameter(torch.randn(5, generator=gen).to(device))
        self.c = torch.nn.Parameter(torch.randn(2, 2, 2, generator=gen).to(device))
        self.constraint = torch.nn.Module()
        self.constraint.raw_scale = torch.nn.Parameter(
            torch.randn(1, generator=gen).to(device))


def run_adam_pair(make_new, make_host, n_updates, reload_at=None,
                  device="cpu", grad_scale=1.0):
    """`n_updates` updates of a device-count Adam and a host-float one over
    two equal `ToyParams`, on the same gradients (numpy normals, seed 0,
    times `grad_scale`); at `reload_at` both are rebuilt from their
    `state()` (the moments and the count, as a resume does). Returns the two
    (params, optimizer) pairs."""
    rng = np.random.default_rng(0)
    new_p, host_p = ToyParams(device), ToyParams(device)
    new, host = make_new(new_p), make_host(host_p)
    for i in range(n_updates):
        if i == reload_at:
            new_state, host_state = new.state(), host.state()
            new, host = make_new(new_p), make_host(host_p)
            new.load_state(new_state)
            host.load_state(host_state)
        for pn, ph in zip(new_p.parameters(), host_p.parameters()):
            g = torch.tensor(grad_scale * rng.normal(size=tuple(pn.shape)),
                             dtype=torch.float32, device=device)
            pn.grad, ph.grad = g.clone(), g.clone()
        new.step()
        host.step()
    return (new_p, new), (host_p, host)
