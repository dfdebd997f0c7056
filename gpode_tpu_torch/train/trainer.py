"""Adam, the train step and the training loop with meters, logging and
periodic checkpoints. Counterpart of `gpode_tpu/train/trainer.py`.

One step is: draw the step's noise from the train generator, the loss, its
backward, one Adam update of the parameters in place. Parameter freezing is
by name: a frozen parameter gets a zero gradient (its moments still decay),
as under the JAX package's frozen mask.

The loop reads nothing back from the device per step beyond what the step
itself reads (the official step's accept decision). The five loss terms of
each step are queued detached; every 64 steps (or at a log, checkpoint or
callback boundary) a window is stacked into one (L, W) tensor and copied to
pinned host memory without blocking, and collected one window later.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import time
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from gpode_tpu_torch.utils.checkpoint import save_checkpoint
from gpode_tpu_torch.utils.meters import Meter
from gpode_tpu_torch.utils.profiling import span

# the solver statistics of a step's terms: host ints, not device scalars
_STATS = ("nfe", "natt", "ncov")
_WINDOW = 64


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training knobs (defaults: the JAX package's).

    `ncov_expected`: the observation times each solve must cover (terms.ncov;
    0 disables). A drained step that covered fewer means the adaptive
    solver's budget ran out: the Trainer logs a warning (with geometric
    backoff) instead of staying silent.

    `flatten_opt` is accepted for the JAX command lines and does nothing
    here: it picks the JAX package's Adam buffer layout, which has no torch
    meaning (the port's Adam is elementwise over each parameter either way).
    """

    num_iter: int = 5000
    lr: float = 5e-3
    lr_schedule: str = "constant"  # constant | cosine (decays to lr/100)
    grad_clip: float = 0.0         # global-norm gradient clip (0 = off)
    log_freq: int = 10
    checkpoint_every: int = 0  # 0 = no periodic checkpoints
    warmup_iters: int = 0      # meters start after this many iters
    ncov_expected: int = 0
    flatten_opt: bool = True


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.01):
    """optax's `cosine_decay_schedule(lr, decay_steps, alpha)`: the lr at
    Adam count c (0 at the first update) is
    lr * ((1 - alpha) * (1 + cos(pi * min(c, N) / N)) / 2 + alpha), in
    float32."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    f32 = np.float32

    def schedule(count: int) -> float:
        # in float32, as optax computes it
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c
                                               / f32(decay_steps)))
        return float(f32(lr) * ((f32(1.0) - f32(alpha)) * cosine + f32(alpha)))

    schedule.horizon = decay_steps
    return schedule


def constant_schedule(lr: float):
    """The lr `lr` at every count (horizon 0)."""

    def schedule(count: int) -> float:
        del count
        return lr

    schedule.horizon = 0
    return schedule


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The lr as a function of Adam's count for `cfg.lr_schedule`; the
    cosine horizon is `cfg.num_iter`. A schedule carries `horizon`: the
    count from which its lr stays constant."""
    if cfg.lr_schedule == "constant":
        return constant_schedule(cfg.lr)
    if cfg.lr_schedule == "cosine":
        return cosine_decay(cfg.lr, cfg.num_iter, alpha=0.01)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


@functools.lru_cache(maxsize=None)
def _bias_corrections(b1: float, b2: float) -> np.ndarray:
    """(C, 2) float32: 1 - b1^(c+1) and 1 - b2^(c+1) at count c, each the
    float32 expression of optax's update (a scalar power per count: numpy's
    array power rounds otherwise), until both reach 1 and stay there."""
    one, rows, c = np.float32(1.0), [], 0
    while not rows or (rows[-1][0] < one or rows[-1][1] < one):
        c += 1
        rows.append((one - np.float32(b1) ** c, one - np.float32(b2) ** c))
        if c > 10_000_000:
            raise ValueError(f"Adam's bias corrections of b1={b1}, b2={b2} "
                             f"do not reach 1 in float32")
    table = np.asarray(rows, np.float32)
    table.setflags(write=False)   # one cached array for every optimizer
    return table


class Adam:
    """optax's `adam` (b1=0.9, b2=0.999, eps=1e-8, eps_root=0), optionally
    behind `clip_by_global_norm`, over the parameters of `params`.

    `lr` is a float or a schedule of the update count (0 at the first
    update) with a `horizon` attribute, the count from which its lr stays
    constant (`constant_schedule`, `cosine_decay`). Parameters whose dotted
    name satisfies `frozen_predicate` get a zero gradient before the clip —
    their moments still decay and their value never moves, as with the JAX
    package's frozen mask. The update is written out so it rounds like
    optax: m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps), times -lr.

    The update reads no host value that changes from step to step, so a
    CUDA graph can hold it (`train/graph_step.py`): the count is a device
    tensor, and the lr and both bias corrections are float32 tables made
    on the host with the schedule's own expressions and indexed on the
    device by the count (clamped at the table's end, past which none of
    them changes). `count` reads the device count on the host.
    """

    def __init__(self, params: nn.Module,
                 lr: Union[float, Callable[[int], float]], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_clip: float = 0.0,
                 frozen_predicate: Optional[Callable[[str], bool]] = None):
        self.names, self.params = zip(*params.named_parameters())
        self.frozen = [bool(frozen_predicate and frozen_predicate(n))
                       for n in self.names]
        self.lr = lr if callable(lr) else constant_schedule(lr)
        if not isinstance(getattr(self.lr, "horizon", None), int):
            raise ValueError("Adam's lr schedule needs an int `horizon` "
                             "(the count from which its lr is constant)")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        device = self.params[0].device
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._table = self._make_table(device)

    def _make_table(self, device) -> torch.Tensor:
        """(C, 3) float32 on `device`: -lr, then both bias corrections, at
        count c. On a card they are stored as float32 reciprocals: PyTorch
        divides a CUDA tensor by a host scalar as a multiply by that
        reciprocal (a CPU tensor by a true division), so each device keeps
        the rounding of the update that read host floats."""
        bc = _bias_corrections(self.b1, self.b2)
        rows = max(len(bc), self.lr.horizon + 1)
        bc = np.concatenate([bc, np.repeat(bc[-1:], rows - len(bc), 0)])
        lrs = [np.float32(self.lr(c))
               for c in range(min(rows, self.lr.horizon + 1))]
        neg_lr = -np.asarray(lrs + lrs[-1:] * (rows - len(lrs)), np.float32)
        if device.type == "cuda":
            bc = np.float32(1.0) / bc
        table = np.concatenate([neg_lr[:, None], bc], axis=1)
        return torch.as_tensor(table, device=device)

    @property
    def count(self) -> int:
        """The update count (a host read of the device count)."""
        return int(self._count)

    @count.setter
    def count(self, value: int):
        self._count.fill_(int(value))

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
        row = self._table.index_select(
            0, torch.clamp(self._count, max=len(self._table) - 1).reshape(1))
        neg_lr, bc1, bc2 = row[0].unbind()
        self._count += 1
        cuda = self._table.is_cuda   # bc1, bc2 hold reciprocals there
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * torch.square(g) + self.b2 * nu)
            m_hat = mu * bc1 if cuda else mu / bc1
            v_hat = nu * bc2 if cuda else nu / bc2
            p.add_(neg_lr * (m_hat / (torch.sqrt(v_hat) + self.eps)))

    def state(self) -> dict:
        """{"mu": {name: tensor}, "nu": {name: tensor}, "count": int}."""
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)), "count": self.count}

    @torch.no_grad()
    def load_state(self, state: dict):
        """Restore moments (tensors or arrays, by name) and the count; the
        names must be this optimizer's."""
        for moment, bufs in (("mu", self.mu), ("nu", self.nu)):
            if set(state[moment]) != set(self.names):
                raise ValueError(
                    f"resumed Adam state does not match the parameters: "
                    f"{sorted(set(state[moment]) ^ set(self.names))}")
            for name, buf in zip(self.names, bufs):
                buf.copy_(torch.as_tensor(state[moment][name]))
        self.count = int(state["count"])


def default_optimizer(params: nn.Module, lr, grad_clip: float = 0.0,
                      frozen_predicate=None) -> Adam:
    """The framework's Adam: optional global-norm clip, then Adam; `lr` a
    float or a schedule of the update count."""
    return Adam(params, lr, grad_clip=grad_clip,
                frozen_predicate=frozen_predicate)


def make_train_step(loss_fn: Callable, params: nn.Module, optimizer: Adam):
    """step(noise, *batch) -> terms: one loss, backward and Adam update of
    `params` in place. `loss_fn(params, noise, *batch)` returns
    (loss, terms); an iteration-dependent loss takes its iteration counter
    as the first of `batch`. The backward and the update are the spans
    `gpode.backward` and `gpode.adam`."""

    def step(noise, *batch):
        optimizer.zero_grad()
        loss, terms = loss_fn(params, noise, *batch)
        with span("gpode.backward"):
            loss.backward()
        with span("gpode.adam"):
            optimizer.step()
        return terms

    return step


class Trainer:
    """The training loop with optimization-trace meters.

    `loss_fn(params, noise, [itr,] *batch) -> (loss, terms)`;
    `noise_fn(params, generator)` draws one step's noise. Meter names cover
    both model variants; unused ones stay empty. A KeyboardInterrupt stops
    the loop, drains the meters and returns; one that lands inside the
    in-place Adam update leaves that update partly applied (the periodic
    checkpoint is the consistent state to resume from).
    """

    def __init__(self, loss_fn: Callable, cfg: TrainConfig,
                 noise_fn: Callable,
                 frozen_predicate: Optional[Callable[[str], bool]] = None,
                 logger=None, checkpoint_path: Optional[str] = None,
                 callback: Optional[Callable] = None,
                 callback_every: int = 0, pass_iteration: bool = False,
                 step_factory: Optional[Callable] = None,
                 model_args=None, kernels: Optional[bool] = None):
        """`callback(itr, params)` runs every `callback_every` iterations
        after a drain (so the meters are current); its wall time is kept
        out of the step-time meter. `pass_iteration`: hand the loss a
        float32 device tensor holding the iteration (constraint
        annealing).

        `step_factory(params, optimizer) -> step(noise, *batch) -> terms`
        replaces the default step (`make_train_step` of `loss_fn`): the
        hook the multi-device drivers use for a mesh step
        (`parallel/train.py`, `parallel/shard_map_step.py`), with the loop,
        meters, checkpoints and callbacks unchanged. It is the JAX hook's
        counterpart: the port's steps update `params` in place, and the
        frozen predicate lives in the optimizer.

        `model_args` (the model's `ModelArgs`) and `kernels` (its solver's
        kernel rule) let the default step be the captured one
        (`train/graph_step.make_step`: CUDA graphs wherever
        `capture_refusal` is None, else the eager step with the reason
        logged once); without them the default step is the eager
        `make_train_step`."""
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.step_factory = step_factory
        self.model_args = model_args
        self.kernels = kernels
        self.noise_fn = noise_fn
        self.frozen_predicate = frozen_predicate
        self.pass_iteration = pass_iteration
        self.logger = logger
        self.checkpoint_path = checkpoint_path
        self.callback = callback
        self.callback_every = callback_every

        self.loss_meter = Meter("ema", 0.98)
        self.observ_nll_meter = Meter("ema", 0.98)
        self.state_kl_meter = Meter("ema", 0.98)
        self.init_kl_meter = Meter("ema", 0.98)
        self.inducing_kl_meter = Meter("ema", 0.98)
        self.time_meter = Meter("mean")
        self.last_nfe = 0
        self.last_natt = None   # adaptive-solver step attempts (last step)
        self.last_ncov = None   # observation times covered (last step)
        self._ncov_warned_at = 0
        self._terms_fields: Optional[tuple] = None
        # (iters, per-step seconds, host block, its event, the solver stats)
        self._inflight: list = []

    def _log(self, msg: str):
        if self.logger is not None:
            self.logger.info(msg)

    def _flush_window(self, pending, begin, warmup_iters):
        """Stack the pending steps' terms into one (L, W) block and start its
        copy to pinned host memory.

        Keeps at most ONE block in flight: the older one is collected first
        (inside this window's elapsed time, so the time meter measures
        throughput with a pipeline depth of one window)."""
        if not pending:
            return begin
        while self._inflight:
            self._collect_one(warmup_iters)
        iters = [itr for itr, _, _ in pending]
        block = torch.stack([torch.stack(field)
                             for field in zip(*(t for _, t, _ in pending))])
        if block.is_cuda:
            host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
            host.copy_(block, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = block, None
        stats = [s for _, _, s in pending]
        elapsed = time.time() - begin
        self._inflight.append((iters, elapsed / len(iters), host, event, stats))
        pending.clear()
        return time.time()

    def _collect_one(self, warmup_iters):
        """Move the oldest in-flight block into the host meters."""
        iters, per_step, host, event, stats = self._inflight.pop(0)
        if event is not None:
            event.synchronize()
        block = host.numpy()
        row = {name: block[i] for i, name in enumerate(self._terms_fields)}
        for j, itr in enumerate(iters):
            if itr <= warmup_iters:
                continue
            self.loss_meter.update(float(row["loss"][j]), itr)
            self.observ_nll_meter.update(float(row["observ_nll"][j]), itr)
            self.init_kl_meter.update(float(row["x0_kl"][j]), itr)
            self.inducing_kl_meter.update(float(row["inducing_kl"][j]), itr)
            if "state_kl" in row:
                self.state_kl_meter.update(float(row["state_kl"][j]), itr)
            self.time_meter.update(per_step, itr)
        self.last_nfe, natt, ncov = stats[-1]
        self.last_natt, self.last_ncov = natt, ncov
        expected = self.cfg.ncov_expected
        if expected:
            worst = min(s[2] for s in stats)
            # geometric backoff: a persistently starved run warns at iters
            # ~1, ~10x, ~100x, ... instead of once per drain window
            if worst < expected and iters[-1] >= 10 * self._ncov_warned_at:
                self._ncov_warned_at = max(iters[-1], 1)
                self._log(
                    f"WARNING: solver budget exhausted near iter {iters[-1]}: "
                    f"covered {worst}/{expected} observation times (uncovered "
                    f"outputs freeze at the final integrator state and carry "
                    f"no dynamics gradient) — raise max_steps or loosen "
                    f"rtol/atol")

    def _drain(self, pending, begin, warmup_iters):
        """Flush the window and wait for every block: used at log, callback
        and checkpoint boundaries and at the end, where the meters must be
        current."""
        begin = self._flush_window(pending, begin, warmup_iters)
        while self._inflight:
            self._collect_one(warmup_iters)
        return begin

    def _log_line(self, itr):
        parts = [
            f"Iter {itr:06d}",
            f"Time {self.time_meter.sum:0.4f}({self.time_meter.avg:.4f})",
            f"Loss {self.loss_meter.val:.3f}({self.loss_meter.avg:.3f})",
            f"OBS NLL {self.observ_nll_meter.val:.2f}({self.observ_nll_meter.avg:.2f})",
        ]
        if "state_kl" in self._terms_fields:
            parts.append(f"XS KL {self.state_kl_meter.val:.2f}"
                         f"({self.state_kl_meter.avg:.2f})")
        parts.append(f"X0 KL {self.init_kl_meter.val:.2f}"
                     f"({self.init_kl_meter.avg:.2f})")
        parts.append(f"IND KL {self.inducing_kl_meter.val:.2f}"
                     f"({self.inducing_kl_meter.avg:.2f})")
        parts.append(f"NFE {self.last_nfe}")
        if self.last_ncov is not None:
            att = "" if self.last_natt is None else f"ATT {self.last_natt} "
            cov_target = (f"/{self.cfg.ncov_expected}"
                          if self.cfg.ncov_expected else "")
            parts.append(f"{att}COV {self.last_ncov}{cov_target}")
        if self.time_meter.avg > 0:
            sps = 1.0 / self.time_meter.avg
            parts.append(f"Steps/s {sps:.1f}")
            if self.last_nfe:
                parts.append(f"RHS/s {sps * self.last_nfe:.0f}")
        self._log(" | ".join(parts))

    def train(self, params: nn.Module, generator: torch.Generator, *batch,
              start_iter: int = 1, opt_state: Optional[dict] = None):
        """Run iterations start_iter..num_iter (inclusive); returns
        (params, opt_state, generator). `params` is updated in place;
        `opt_state` (`Adam.state()`) continues a run's Adam moments and
        count."""
        cfg = self.cfg
        optimizer = default_optimizer(params, lr_schedule(cfg),
                                      grad_clip=cfg.grad_clip,
                                      frozen_predicate=self.frozen_predicate)
        if opt_state is not None:
            optimizer.load_state(opt_state)
        # graph_step imports this module
        from gpode_tpu_torch.train import graph_step
        if self.step_factory is not None:
            step = self.step_factory(params, optimizer)
            if self.model_args is not None:
                graph_step.log_refusal(graph_step.MESH_REFUSAL,
                                       optimizer.params[0].device, self.logger)
        elif self.model_args is not None:
            step = graph_step.make_step(self.loss_fn, params, optimizer,
                                        self.model_args, kernels=self.kernels,
                                        logger=self.logger)
        else:
            step = make_train_step(self.loss_fn, params, optimizer)
        itr_dev = None
        if self.pass_iteration:
            device = next(params.parameters()).device
            itr_dev = torch.tensor(float(start_iter), dtype=torch.float32,
                                   device=device)
        pending = []  # (iteration, detached terms, solver stats)
        begin = time.time()
        for itr in range(start_iter, cfg.num_iter + 1):
            try:
                noise = self.noise_fn(params, generator)
                if itr_dev is None:
                    terms = step(noise, *batch)
                else:
                    terms = step(noise, itr_dev, *batch)
                    itr_dev += 1.0
                if self._terms_fields is None:
                    self._terms_fields = tuple(
                        f for f in terms._fields if f not in _STATS)
                pending.append((itr, [getattr(terms, f).detach().float()
                                      for f in self._terms_fields],
                                tuple(int(getattr(terms, f)) for f in _STATS)))

                log_now = cfg.log_freq > 0 and itr % cfg.log_freq == 0
                if len(pending) >= _WINDOW and not log_now:
                    begin = self._flush_window(pending, begin,
                                               cfg.warmup_iters)
                if log_now:
                    begin = self._drain(pending, begin, cfg.warmup_iters)
                    if itr > cfg.warmup_iters:
                        self._log_line(itr)

                if (cfg.checkpoint_every and self.checkpoint_path
                        and itr % cfg.checkpoint_every == 0):
                    begin = self._drain(pending, begin, cfg.warmup_iters)
                    save_checkpoint(self.checkpoint_path,
                                    {"params": params,
                                     "opt_state": optimizer.state(),
                                     "generator": generator, "step": itr})
                    begin = time.time()

                if (self.callback is not None and self.callback_every
                        and itr % self.callback_every == 0):
                    self._drain(pending, begin, cfg.warmup_iters)
                    self.callback(itr, params)
                    begin = time.time()
            except KeyboardInterrupt:
                self._log("Stopping optimization")
                break
        self._drain(pending, begin, cfg.warmup_iters)
        return params, optimizer.state(), generator


def save_trace(trainer: Trainer, path: str, extra=None):
    """Dump the optimization trace (per-iteration meter histories) to JSON;
    `extra` maps more trace names to Meters (e.g. validation metrics)."""
    named = [("loss", trainer.loss_meter),
             ("observ_nll", trainer.observ_nll_meter),
             ("state_kl", trainer.state_kl_meter),
             ("x0_kl", trainer.init_kl_meter),
             ("inducing_kl", trainer.inducing_kl_meter),
             ("step_time", trainer.time_meter)]
    if extra:
        named.extend(extra.items())
    payload = {name: {"iters": meter.iters, "vals": meter.vals}
               for name, meter in named if meter.vals}
    with open(path, "w") as f:
        json.dump(payload, f)
