"""The shooting train step as captured CUDA graphs: the counterpart of the
JAX package's compiled step (`gpode_tpu/train/trainer.py` `make_step_bodies`
and `make_train_step`'s `jax.jit`), which runs a whole step as one device
program with the whole-span attempt's accept a device-side `lax.cond`.

`make_captured_train_step(loss_fn, params, optimizer)` returns a step with
`trainer.make_train_step`'s signature and terms, `step(noise, *batch) ->
terms`:

  * the first `capture.WARMUP` calls are eager steps on the capture stream
    (`ops/capture.py`: one per card, shared with the prediction solve's
    captured attempt; real steps: the trajectory is the eager one);
  * the next call captures the step's body — zero_grad, the loss, its
    backward and the Adam update — from static copies of its inputs, and
    every call from then on copies its noise and batch into them and
    replays. The noise is drawn eagerly by the caller, as for the eager
    step, so the random streams and `--resume` are unchanged; parameters
    and Adam's moments and count are updated in place, so they are static
    already (the counterpart of `donate_argnums`); the gradients are set to
    None before the capture, so the graphs' pool holds them;
  * a step through the rk4 segment kernels (`fast`) is ONE graph with no
    host read. A step through the dopri5 attempt kernels (`official`,
    `scale`) is two graphs in one memory pool, split where the attempt's
    accept read is (`models/flow.AcceptSeam`): graph A holds the draw, the
    states, the attempt forward and its error RMS; after replaying it the
    step reads the RMS on the host (the one read the eager step makes); an
    accept replays graph B (the rest of the forward, the backward, Adam), a
    reject runs the whole step eagerly from the same inputs (A changed no
    parameter, so that is the eager step's reject fallback), and the next
    step replays again;
  * the returned terms are copies (one device copy of their stacked
    scalars), so the next replay does not overwrite what a caller queued;
    their solver statistics are the accepted branch's, or the eager step's
    on a reject;
  * `cuda_kernels.LAUNCHES` counts wrapper calls, and a replay makes none:
    the step records each graph's launches at capture (and takes them back
    out, since a capture runs nothing) and adds them on every replay
    (`ops/capture.py`);
  * under a profiler a call is the span `gpode.step`, holding
    `gpode.step.copy_in`, a `gpode.step.replay` per graph launched, the
    `gpode.step.accept_read` between A and B, and `gpode.step.eager`
    around each eager step (the warm-up, a reject). A replay has no host
    phases: the eager step's (`gpode.draw` ... `gpode.adam`) show only in
    eager steps and the capture. With no profiler the calls and the
    replays are counted and timed on the host's clock
    (`profiling.UNTRACED`).

On a CPU device there are no graphs: after the warm-up every step runs the
same body eagerly with the accept seam in place, the seam reading the RMS on
the host and abandoning the step on a reject, which then runs eagerly — the
capture's control flow, for the CPU tests.

`capture_refusal` says which configurations are not captured and why; the
entry points (the `Trainer`, `scripts/bench.py`,
`scripts/bench_time_to_nll.py`) take the step from `make_step`, which logs
a refusal once per reason and then returns the eager step. A capture or a
replay that fails on a path `capture_refusal` accepts fails the run: there
is no other fallback.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
from typing import Callable, Optional

import torch
from torch import nn

from gpode_tpu_torch.models.flow import (AcceptSeam, accept_seam,
                                         segment_kernel_taken)
from gpode_tpu_torch.models.shooting import ShootingParams
from gpode_tpu_torch.ops import capture
from gpode_tpu_torch.ops.ode import FIRST_STEP_SPAN
from gpode_tpu_torch.train.trainer import Adam, make_train_step
from gpode_tpu_torch.utils.profiling import clocked, span

_MULTISTEP = ("explicit_adams", "fixed_adams", "implicit_adams", "adams",
              "bdf")

MESH_REFUSAL = "--mesh: the sharded steps are not captured"

_logger = logging.getLogger(__name__)
_REFUSALS_LOGGED: set = set()


def capture_refusal(model_args, device, params: nn.Module,
                    kernels: Optional[bool] = None,
                    mesh=None) -> Optional[str]:
    """Why the train step of `model_args` (a `ModelArgs`) on `device` is not
    captured, or None when it is. `params` (the model's parameters) decide
    the model variant and whether the segment kernel takes the step's rows;
    `kernels` is the solver's kernel rule (`SolverConfig.kernels`); `mesh`
    a rank mesh. A captured step may read the host at most at the attempt's
    accept, so every path whose solve is a host-controlled loop is refused:
    where the JAX package traces a `lax.while_loop` or a scan, the port's
    solvers read the time grid or their error norms on the host."""
    if torch.device(device).type != "cuda":
        return "the CPU: CUDA graphs need a card"
    if mesh is not None:
        return MESH_REFUSAL
    if not isinstance(params, ShootingParams):
        return ("vanilla GPODE: its solve over the whole grid is a "
                "host-controlled loop (the JAX package's lax.while_loop)")
    if model_args.use_adjoint:
        return "use_adjoint: the adjoint's solves are host-controlled loops"
    if model_args.solver in _MULTISTEP:
        return (f"the multistep and BDF solvers ({model_args.solver}): "
                f"host-controlled loops over the grid")
    if model_args.solver == "dopri5":
        if model_args.first_step is None:
            return ("Hairer's first step: the adaptive dopri5 solve is a "
                    "host-controlled loop")
        if model_args.first_step != FIRST_STEP_SPAN:
            return ("a set dopri5 first step: the adaptive solve is a "
                    "host-controlled loop")
    elif model_args.solver != "rk4":
        return (f"{model_args.solver}: the fixed-step loop reads the time "
                f"grid on the host (only rk4 has a segment kernel)")
    n, t1, _ = params.states.mean.shape
    k = model_args.segment_minibatch
    rows = model_args.num_samples * n * (k if 0 < k <= t1 else t1 + 1)
    if segment_kernel_taken(model_args.solver_config(kernels), params.gp,
                            rows, model_args.num_features) is None:
        return (f"the segment kernel is not taken at {rows} rows: the plain "
                f"solve reads the time grid on the host")
    return None


def make_step(loss_fn: Callable, params: nn.Module, optimizer: Adam,
              model_args, *, kernels: Optional[bool] = None,
              logger: Optional[logging.Logger] = None) -> Callable:
    """The train step an entry point runs: `make_captured_train_step`
    where `capture_refusal` is None, else the eager `make_train_step`
    after logging the reason (once per reason in a process; to `logger`
    when given, at INFO on the CPU and WARNING elsewhere)."""
    device = next(params.parameters()).device
    reason = capture_refusal(model_args, device, params, kernels)
    if reason is None:
        return make_captured_train_step(loss_fn, params, optimizer)
    log_refusal(reason, device, logger)
    return make_train_step(loss_fn, params, optimizer)


def log_refusal(reason: str, device, logger: Optional[logging.Logger] = None):
    """Log why a train step runs eagerly, once per reason in a process (the
    sharded steps, which their own factories build, log MESH_REFUSAL)."""
    if reason in _REFUSALS_LOGGED:
        return
    _REFUSALS_LOGGED.add(reason)
    level = logging.INFO if torch.device(device).type == "cpu" else logging.WARNING
    (logger or _logger).log(level, "the train step is not captured (%s): "
                            "running it eagerly", reason)


class _Rejected(Exception):
    """A CPU rehearsal's accept read found a reject."""


class CapturedStep:
    """`step(noise, *batch) -> terms` of `make_captured_train_step`.

    After the capture, `graphs` holds one graph (no accept read) or two
    (split at the accept read), and `graph_launches` each graph's kernel
    launches. `replays` counts the steps that replayed to the end, `rejects`
    those that ran eagerly after a reject, `host_reads` the accept reads."""

    def __init__(self, loss_fn: Callable, params: nn.Module, optimizer: Adam):
        self.loss_fn = loss_fn
        self.params = params
        self.optimizer = optimizer
        self.eager = make_train_step(loss_fn, params, optimizer)
        self.device = next(params.parameters()).device
        self.cuda = self.device.type == "cuda"
        self.calls = self.replays = self.rejects = self.host_reads = 0
        self.graphs: list = []
        self.graph_launches: list = []
        self._rms = torch.zeros((), device=self.device)
        self._noise = self._batch = None
        self._block = self._terms = None
        self._fields: tuple = ()

    # -- static inputs -----------------------------------------------------

    def _copy_in(self, noise, batch):
        """Copy the step's inputs into the static buffers (made at the
        first call as clones)."""
        if not dataclasses.is_dataclass(noise):
            raise TypeError(f"a captured step takes a dataclass of noise "
                            f"tensors, got {type(noise).__name__}")
        if self._noise is None:
            self._noise = dataclasses.replace(noise, **{
                f.name: getattr(noise, f.name).clone()
                for f in dataclasses.fields(noise)
                if isinstance(getattr(noise, f.name), torch.Tensor)})
            self._batch = [b.clone() if isinstance(b, torch.Tensor) else b
                           for b in batch]
            return
        for f in dataclasses.fields(noise):
            _copy_static(getattr(self._noise, f.name), getattr(noise, f.name),
                         f"noise.{f.name}")
        if len(batch) != len(self._batch):
            raise ValueError(f"the step was captured with {len(self._batch)} "
                             f"batch arguments, got {len(batch)}")
        for i, (static, b) in enumerate(zip(self._batch, batch)):
            _copy_static(static, b, f"batch[{i}]")

    # -- the step's body ---------------------------------------------------

    def _body(self):
        """zero_grad, the loss on the static inputs, backward, Adam; the
        tensor terms stacked into one static block, and the terms with
        those fields emptied (so no reference keeps the body's autograd
        graph, whose gradient accumulators would carry the capture's stream
        into a later eager step)."""
        self.optimizer.zero_grad()
        loss, terms = self.loss_fn(self.params, self._noise, *self._batch)
        with span("gpode.backward"):
            loss.backward()
        with span("gpode.adam"):
            self.optimizer.step()
        self._fields = tuple(f for f in terms._fields
                             if isinstance(getattr(terms, f), torch.Tensor))
        block = torch.stack([getattr(terms, f).detach() for f in self._fields])
        return block, terms._replace(**dict.fromkeys(self._fields))

    def _terms_copy(self):
        block = self._block.clone()
        return self._terms._replace(**{f: block[i]
                                       for i, f in enumerate(self._fields)})

    # -- capture and replay ------------------------------------------------

    def _capture(self):
        pool = torch.cuda.graph_pool_handle()
        graphs = [torch.cuda.CUDAGraph()]
        launches = []
        take = capture.launch_counter()

        def end():
            graphs[-1].capture_end()
            launches.append(take())

        def split():
            end()
            graphs.append(torch.cuda.CUDAGraph())
            graphs[-1].capture_begin(pool=pool)

        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        with capture.on_capture_stream(self.device):
            graphs[0].capture_begin(pool=pool)
            try:
                with accept_seam(AcceptSeam(self._rms, split)):
                    self._block, self._terms = self._body()
            except BaseException:
                _end_capture_quietly(graphs[-1])
                raise
            end()
        self.graphs, self.graph_launches = graphs, launches

    def _replay(self, noise, batch):
        last = len(self.graphs) - 1
        for i, graph in enumerate(self.graphs):
            with clocked("gpode.step.replay"):
                graph.replay()
            capture.replay_launches(self.graph_launches[i])
            if i < last and not self._accepted():
                return self._eager(noise, batch)
        self.replays += 1
        return self._terms_copy()

    def _accepted(self) -> bool:
        """The accept read (a host read of the RMS, as the eager step's)."""
        self.host_reads += 1
        with span("gpode.step.accept_read"):
            accepted = float(self._rms) <= 1.0
        if not accepted:
            self.rejects += 1
        return accepted

    def _eager(self, noise, batch):
        with span("gpode.step.eager"):
            return self.eager(noise, *batch)

    def _rehearse(self, noise, batch):
        """The CPU's stand-in for capture + replay: the body with the seam
        in place, abandoned on a reject for the eager step."""
        def split():
            if not self._accepted():
                raise _Rejected()

        try:
            with accept_seam(AcceptSeam(self._rms, split)):
                self._block, self._terms = self._body()
        except _Rejected:
            return self._eager(noise, batch)
        self.replays += 1
        return self._terms_copy()

    def __call__(self, noise, *batch):
        with clocked("gpode.step"):
            return self._step(noise, batch)

    def _step(self, noise, batch):
        self.calls += 1
        if self.calls <= capture.WARMUP:
            if not self.cuda:
                return self._eager(noise, batch)
            with capture.on_capture_stream(self.device):
                return self._eager(noise, batch)
        with span("gpode.step.copy_in"):
            self._copy_in(noise, batch)
        if not self.cuda:
            return self._rehearse(noise, batch)
        if not self.graphs:
            self._capture()
        return self._replay(noise, batch)


def make_captured_train_step(loss_fn: Callable, params: nn.Module,
                             optimizer: Adam) -> CapturedStep:
    """`trainer.make_train_step` as captured CUDA graphs (see the module's
    docstring): the same signature, the same terms, the same parameters
    after every step."""
    return CapturedStep(loss_fn, params, optimizer)


def _copy_static(static, value, what):
    if static is None or not isinstance(static, torch.Tensor):
        if value is not static:
            raise ValueError(f"{what} differs from the captured step's")
        return
    if (not isinstance(value, torch.Tensor) or value.shape != static.shape
            or value.dtype != static.dtype):
        raise ValueError(f"{what} must be a {static.dtype} tensor of shape "
                         f"{tuple(static.shape)}, as when the step was "
                         f"captured")
    static.copy_(value)


def _end_capture_quietly(graph):
    try:
        graph.capture_end()
    except RuntimeError:
        pass
