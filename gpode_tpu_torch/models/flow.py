"""Flow: numerical integration of a sampled GP vector field.

Counterpart of `gpode_tpu/models/flow.py` (`flow_forward`,
`flow_forward_batched`, `flow_forward_sampled`, `flow_inverse`): `odeint`
applied to `eval_draw` of a fixed
:class:`~gpode_tpu_torch.models.gp.PosteriorDraw`, with the segment kernels
for one-interval shooting segments (the rk4 segment and the whole-span
dopri5 attempt), the continuous adjoint, rematerialized rhs evaluations, the
batched-draw solve of posterior prediction (its dopri5 attempt a captured
CUDA graph on the card, of one fused attempt kernel for a dimwise GP, that
commits an accepted step's dense output on the device), and a solve under a
draw built from its noise.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import logging
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.ops import capture
from gpode_tpu_torch.ops.adjoint import odeint_adjoint
from gpode_tpu_torch.ops.cuda_kernels import (dopri5_attempt_draws,
                                              draws_commit, fused_dopri5_attempt,
                                              fused_rk4_segment,
                                              kernel_order_draws,
                                              kernel_refusal)
from gpode_tpu_torch.ops.ode import (FIRST_STEP_SPAN, ODEStats,
                                     dopri5_attempt, dopri5_controller,
                                     max_rms_over_axis0, odeint)
from gpode_tpu_torch.utils.profiling import clocked
from gpode_tpu_torch.utils.time_grids import substeps_from_dense_scale

_logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver knobs. `ts_dense_scale`: fixed-step solvers take
    `ts_dense_scale - 1` sub-steps per interval; dopri5 ignores it.
    `first_step`: None -> Hairer's heuristic, FIRST_STEP_SPAN -> the whole
    span. `remat`: rematerialize every rhs evaluation of a taped solve in
    the backward instead of storing its intermediates. `use_adjoint`:
    continuous-adjoint gradients (`ops/adjoint.py`). `kernels`: None -> the
    auto rule (dimwise batches of at least 256 rows take the fused kernels
    where both directions of the kernel the solve would launch take the
    shape), False -> plain tensor path everywhere, True -> the kernels for
    any dimwise batch (the JAX `pallas` override; a shape the kernel refuses
    raises ValueError); the posterior draw's own-factor solves follow it
    too (`gp.draw_posterior`: False keeps the library's, else the
    `draw_solve` kernels where dtype and shape allow), and so does the
    shooting states' entropy (`states.shooting_entropy`: False keeps the
    unrolled chain, else the `state_entropy` kernels in float32 on a card
    at D <= 8). BDF always takes the plain rhs: its Newton Jacobian is
    differentiated a second time in the backward, and the kernels' autograd
    rules are first order."""

    solver: str = "dopri5"
    rtol: float = 1e-6
    atol: float = 1e-6
    ts_dense_scale: int = 1
    max_steps: int = 256
    first_step: Optional[float] = None
    remat: bool = False
    use_adjoint: bool = False
    kernels: Optional[bool] = None

    @property
    def substeps(self) -> int:
        return substeps_from_dense_scale(self.ts_dense_scale)


def _segment_kernel(cfg: SolverConfig) -> Optional[str]:
    """The kernel of a one-interval solve under `cfg`: the rk4 segment or
    the dopri5 attempt, or None (the solver has no segment kernel)."""
    if cfg.solver == "rk4":
        return "rk4_segment"
    if cfg.solver == "dopri5" and cfg.first_step == FIRST_STEP_SPAN:
        return "dopri5_attempt"
    return None


def _kernel_of(cfg: SolverConfig, ts: torch.Tensor) -> str:
    """The kernel a solve over `ts` launches when it takes the kernels: the
    rk4 segment or the dopri5 attempt for one-interval shooting segments,
    else `fused_rhs` at every rhs evaluation."""
    return (ts.shape[0] == 2 and _segment_kernel(cfg)) or "fused_rhs"


def _kernels_active(cfg: SolverConfig, gp_params: gp.SVGPParams,
                    n_rows: int, num_features: int, kernel: str) -> bool:
    if cfg.solver == "bdf":
        return False
    if cfg.kernels is None:
        return gp.kernel_rhs_active(gp_params, n_rows, num_features, kernel)
    return cfg.kernels and gp_params.dimwise


def segment_kernel_taken(cfg: SolverConfig, gp_params: gp.SVGPParams,
                         n_rows: int, num_features: int) -> Optional[str]:
    """The segment kernel ("rk4_segment" or "dopri5_attempt") that a
    one-interval solve of `n_rows` rows under `cfg` launches, or None when
    it takes another path (the adjoint, `fused_rhs` or the plain rhs under
    a host-controlled solver loop)."""
    kernel = _segment_kernel(cfg)
    if (cfg.use_adjoint or kernel is None
            or not _kernels_active(cfg, gp_params, n_rows, num_features,
                                   kernel)):
        return None
    return kernel


def _rematerialized(rhs):
    """`rhs` under a non-reentrant checkpoint: a taped solve keeps only each
    evaluation's inputs and recomputes the evaluation in the backward (a
    kernel rhs launches its forward again there)."""
    def wrapped(t, x):
        return checkpoint(rhs, t, x, use_reentrant=False)

    return wrapped


def _adjoint_leaves(gp_params: gp.SVGPParams, draw: gp.PosteriorDraw):
    """The adjoint's parameters, as the JAX package ravels (gp_params,
    draw): the kernel's raw leaves and Z, which the field reads, the
    inducing posterior's leaves, which it does not (zero cotangents; they
    reach the loss through the draw), and the draw's four leaves."""
    q = gp_params.u_diag_raw if gp_params.q_diag else gp_params.u_tril
    return (gp_params.kernel.raw_lengthscales, gp_params.kernel.raw_variance,
            gp_params.z, gp_params.u_mean, q, *draw)


class AcceptSeam:
    """Where the whole-span attempt's accept read goes in a captured train
    step (`train/graph_step.py`), the counterpart of the JAX package's
    device-side `lax.cond`.

    Installed with :func:`accept_seam`, it takes the read: the attempt
    branch hands it the global error RMS as a device scalar and takes the
    accepted branch. `read` writes the RMS into `rms`, a device scalar the
    owner keeps, counts the read in `reads` and calls `split()`, with which
    the owner ends the graph that holds the attempt (the owner reads `rms`
    on the host after replaying it, and on a reject runs the whole step
    eagerly). Outside it, the attempt branch reads the RMS on the host
    itself."""

    def __init__(self, rms: torch.Tensor, split: Callable[[], None]):
        self.rms = rms
        self.split = split
        self.reads = 0

    def read(self, err_rms: torch.Tensor):
        if self.reads:
            raise RuntimeError("a second whole-span accept read in one "
                               "captured step")
        self.rms.copy_(err_rms)
        self.reads += 1
        self.split()


_ACCEPT_SEAM: contextvars.ContextVar[Optional[AcceptSeam]] = (
    contextvars.ContextVar("accept_seam", default=None))


@contextlib.contextmanager
def accept_seam(seam: AcceptSeam):
    """Route the attempt branch's accept read to `seam` inside the block."""
    token = _ACCEPT_SEAM.set(seam)
    try:
        yield seam
    finally:
        _ACCEPT_SEAM.reset(token)


def flow_forward(gp_params: gp.SVGPParams, draw: gp.PosteriorDraw,
                 x0: torch.Tensor, ts: torch.Tensor,
                 cfg: SolverConfig) -> tuple[torch.Tensor, ODEStats]:
    """Integrate dx/dt = f_draw(x) from x0 (N, D) over ts (T,).
    Returns ((N, T, D), stats)."""
    n_features = draw.weights.shape[-2]

    # continuous adjoint: the generic solver with `fused_rhs` at every
    # evaluation, forward and in the augmented dynamics (its VJP launches
    # the backward kernel); never the segment kernels
    if cfg.use_adjoint:
        use_kernel = _kernels_active(cfg, gp_params, x0.shape[0], n_features,
                                     "fused_rhs")

        def rhs_p(p, t, x):
            del t  # time-invariant ODE
            return gp.eval_draw(gp.field_view(*p[:3]), gp.PosteriorDraw(*p[5:]),
                                x, use_kernel)

        xs, stats = odeint_adjoint(
            rhs_p, _adjoint_leaves(gp_params, draw), x0, ts, solver=cfg.solver,
            rtol=cfg.rtol, atol=cfg.atol, substeps=cfg.substeps,
            max_steps=cfg.max_steps, first_step=cfg.first_step)
        return torch.movedim(xs, 0, 1), stats

    kernel = _kernel_of(cfg, ts)
    use_kernel = _kernels_active(cfg, gp_params, x0.shape[0], n_features,
                                 kernel)

    def rhs(t, x):
        del t  # time-invariant ODE
        return gp.eval_draw(gp_params, draw, x, use_kernel)

    # rk4 one-interval shooting segments: one kernel runs all 4 * substeps
    # stage evaluations and combines for every row, and one kernel the
    # reverse sweep of the stage chain (which recomputes the stages, so
    # `remat` has nothing to add).
    if kernel == "rk4_segment" and use_kernel:
        dt = (ts[1] - ts[0]).detach().reshape(1)
        x1 = fused_rk4_segment(
            x0, dt, gp_params.z, gp_params.kernel.lengthscales,
            gp_params.kernel.variance, draw.omega, draw.phase,
            gp.kernel_rff_weights(draw.weights), draw.nu, cfg.substeps)
        n = cfg.substeps
        return torch.stack([x0, x1], dim=1), ODEStats(4 * n, n, n, 2)

    # dopri5 whole-span shooting segments: one attempt kernel computes f0,
    # the six stages and the scaled embedded error for every row. The accept
    # test is ONE global RMS over the batch, decided on the host (one sync
    # per call, or through an `AcceptSeam` in a captured step); a rejected
    # attempt falls back to the adaptive solver with
    # the plain rhs, seeded with the controller-shrunk dt. An accepted
    # whole-span attempt IS that solver's first accepted step.
    if kernel == "dopri5_attempt" and use_kernel:
        dt = (ts[1] - ts[0]).detach().reshape(1)
        x5, err_scaled = fused_dopri5_attempt(
            x0, dt, gp_params.z, gp_params.kernel.lengthscales,
            gp_params.kernel.variance, draw.omega, draw.phase,
            gp.kernel_rff_weights(draw.weights), draw.nu, cfg.rtol, cfg.atol)
        err_rms = torch.sqrt(torch.mean(torch.square(err_scaled)))
        seam = _ACCEPT_SEAM.get()
        if seam is not None:
            # a captured step: its owner reads the RMS between two graphs
            # and runs the whole step eagerly on a reject
            seam.read(err_rms)
            return torch.stack([x0, x5], dim=1), ODEStats(7, 1, 1, 2)
        err_ratio = float(err_rms)
        if err_ratio <= 1.0:
            return torch.stack([x0, x5], dim=1), ODEStats(7, 1, 1, 2)

        dt_shrunk = np.float32(dt.item()) * min(
            dopri5_controller(err_ratio, accepted=False), np.float32(1.0))

        def rhs_plain(t, x):
            del t
            return gp.eval_draw(gp_params, draw, x, False)

        # the fallback's rhs is always rematerialized, whatever `remat`
        # says: a reject at the `scale` preset's 19200 rows would otherwise
        # tape every stage's (N, S_rff, D) features. Checkpoints are per
        # evaluation: a checkpoint of the whole host-controlled solve would
        # replay its accept decisions in the backward and fail if a replay
        # took another path.
        xs, st = odeint(_rematerialized(rhs_plain), x0, ts, solver="dopri5",
                        rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
                        first_step=float(dt_shrunk))
        # the rejected attempt's 7 kernel evaluations still happened
        return torch.stack([x0, xs[-1]], dim=1), ODEStats(
            st.num_rhs_evals + 7, st.num_accepted, st.num_attempted + 1,
            st.num_covered)

    if cfg.remat:
        rhs = _rematerialized(rhs)
    xs, stats = odeint(rhs, x0, ts, solver=cfg.solver, rtol=cfg.rtol,
                       atol=cfg.atol, substeps=cfg.substeps,
                       max_steps=cfg.max_steps, first_step=cfg.first_step)
    return torch.movedim(xs, 0, 1), stats


class _EagerReplay:
    """A graph's stand-in on the CPU: a replay runs the attempt eagerly,
    copies its results into the static outputs and commits them."""

    def __init__(self, attempt: Callable, out: tuple, commit: Callable):
        self.attempt, self.out, self.commit = attempt, out, commit

    def replay(self):
        for static, new in zip(self.out, self.attempt()):
            static.copy_(new)
        self.commit(self.out)


class CapturedAttempt:
    """The no-grad batched dopri5 attempt of :func:`flow_forward_batched` as
    one CUDA graph: `odeint_dopri5`'s `attempt`, replayed once per attempt
    under its unchanged host controller, that commits an accepted step on
    the device.

    With `fused` (a dimwise GP at a shape `dopri5_attempt_draws` takes,
    decided before the capture) the attempt is that kernel: the graph holds
    its launch and its reduction. Else it is `ops/ode.dopri5_attempt` on the
    batched field (`gp.eval_draws`: ~300 small kernels at the validation
    request's 32 draws x 2 rows). The graph's last node is the
    `draws_commit` kernel, which on a ratio <= 1 writes the cubic Hermite
    dense output at the solve's output times in (tau, tau_end] into the
    static `dense` (times, *x.shape) and hands the step over (x <- x_new,
    k1 <- k7), as `odeint_dopri5` does on the host for an eager attempt.

    Static inputs: the state `x`, its FSAL `k1`, `scalars` = [dt, tau,
    tau_end] (float32; `dt` is its first element, a 0-d view; the
    time-invariant field reads no time), the solve's `times` output times
    `taus`, and copies of the draws' leaves (with `fused`, in the kernel's
    memory order, and the kernel's constrained lengthscales and variance),
    which `load` refreshes for each solve. Static outputs: `out`, the
    attempt's `(x_new, ratio, k7)`, and `dense`. `capture` runs
    `capture.WARMUP` eager attempts and commits on the card's capture
    stream (`ops/capture.py`), then captures one in a private pool.
    `dense_output` starts a solve: its `taus` in, x0 into the points at or
    before its start. A call copies in a state or FSAL value that is not
    already in the static buffers (a solve's start), copies in the scalars
    from pinned host memory, replays (the span `gpode.solve.replay`) and
    returns `(x, ratio, k1)`: after an accept, the step handed over. The
    graph reads Z (and without `fused` every GP parameter) where it lives,
    so an in-place update (Adam's) is seen at the next solve; the draws are
    copies.

    A replay counts the capture's launches (`capture.replay_launches`). On
    the CPU there are no graphs: a replay runs the same attempt and commit
    eagerly (`_EagerReplay`), which the CPU tests use."""

    def __init__(self, gp_params: gp.SVGPParams, draws: gp.PosteriorDraw,
                 x0: torch.Tensor, direction: float, rtol: float, atol: float,
                 use_kernel: bool, fused: bool, times: int):
        self.gp_params, self.use_kernel = gp_params, use_kernel
        self.direction, self.rtol, self.atol = direction, rtol, atol
        self.fused = fused
        if fused:
            self.draws = gp.PosteriorDraw(*kernel_order_draws(*draws))
            self.hyper = (gp_params.kernel.lengthscales.detach().clone(),
                          gp_params.kernel.variance.detach().clone())
        else:
            self.draws = gp.PosteriorDraw(*(leaf.clone() for leaf in draws))
        self.cuda = x0.is_cuda
        self.x = x0.clone(memory_format=torch.contiguous_format)
        self.k1 = torch.zeros_like(self.x)
        f32 = dict(dtype=torch.float32, device=x0.device)
        self.scalars = torch.zeros(3, **f32)
        self.dt = self.scalars[0]
        self.host_scalars = torch.zeros(3, dtype=torch.float32,
                                        pin_memory=self.cuda)
        self._host = self.host_scalars.numpy()
        self.taus = torch.zeros(times, **f32)
        self.dense = self.x.new_zeros((times, *self.x.shape))
        self._step = dopri5_attempt(self._field, rtol=rtol, atol=atol,
                                    norm=max_rms_over_axis0)
        self.graph = self.out = None
        self.launches: dict = {}

    def _field(self, t, x):
        del t  # time-invariant ODE
        return self.direction * gp.eval_draws(self.gp_params, self.draws, x,
                                              self.use_kernel)

    def _attempt(self):
        if self.fused:
            return dopri5_attempt_draws(
                self.x, self.k1, self.dt, self.direction, self.gp_params.z,
                *self.hyper, self.draws.omega, self.draws.phase,
                gp.kernel_rff_weights(self.draws.weights), self.draws.nu,
                self.rtol, self.atol)
        return self._step(None, self.x, self.k1, self.dt)

    def _commit(self, out):
        x_new, ratio, k7 = out
        draws_commit(ratio, self.scalars, self.taus, self.dense, self.x,
                     self.k1, x_new.contiguous(), k7.contiguous())

    def rehearse(self):
        """The graph's eager stand-in (`_EagerReplay`; the CPU's only
        path): each replay launches the attempt and the commit."""
        self.out = self._attempt()
        self.graph = _EagerReplay(self._attempt, self.out, self._commit)

    def capture(self):
        if not self.cuda:
            self.rehearse()
            return
        with capture.on_capture_stream(self.x.device) as stream:
            for _ in range(capture.WARMUP):
                self._commit(self._attempt())
        graph = torch.cuda.CUDAGraph()
        take = capture.launch_counter()
        with torch.cuda.graph(graph, stream=stream):
            self.out = self._attempt()
            self._commit(self.out)
        self.launches = take()
        self.graph = graph

    def load(self, draws: gp.PosteriorDraw):
        """A solve's draws into the static leaves (with `fused`, also the
        kernel's constrained hyperparameters as they are now)."""
        for static, leaf in zip(self.draws, draws):
            static.copy_(leaf)
        if self.fused:
            kernel = self.gp_params.kernel
            for static, value in zip(self.hyper, (kernel.lengthscales,
                                                  kernel.variance)):
                static.copy_(value)

    def dense_output(self, taus: np.ndarray, x0: torch.Tensor):
        """A solve's start (`odeint_dopri5`): its output times `taus`
        (float32, one per point) into the static ones and x0 into the points
        at or before the start; returns `dense`, which the replays fill."""
        self.taus.copy_(torch.from_numpy(taus))
        for j in np.flatnonzero(taus <= 0.0):
            self.dense[j].copy_(x0)
        return self.dense

    def __call__(self, tau, x, k1, dt_step, tau_end):
        if x is not self.x:
            self.x.copy_(x)
        if k1 is not self.k1:
            self.k1.copy_(k1)
        # the last call's copy is done: the host read its ratio since
        self._host[:] = (dt_step, tau, tau_end)
        self.scalars.copy_(self.host_scalars, non_blocking=True)
        with clocked("gpode.solve.replay"):
            self.graph.replay()
        capture.replay_launches(self.launches)
        return self.x, self.out[1], self.k1


# the captured attempts, by everything a graph bakes in, least recently used
# first: a process holds a few shapes (the validation's, the test
# evaluation's)
_ATTEMPTS: collections.OrderedDict = collections.OrderedDict()
_MAX_ATTEMPTS = 4
_REFUSALS_LOGGED: set = set()


def _capture_route(cfg: SolverConfig, gp_params: gp.SVGPParams,
                   draws: gp.PosteriorDraw, x0: torch.Tensor) -> Optional[str]:
    """How the batched solve runs its attempt. None: eagerly, the host
    forming the dense output (every solver but dopri5, `remat`, grad mode,
    a state off the card or inside a capture, float64 states,
    `cfg.kernels` False). Else a :class:`CapturedAttempt` that commits on
    the device: "fused", the `dopri5_attempt_draws` kernel, for a dimwise
    GP at a shape the kernel takes (`kernel_refusal`, decided from shapes
    alone); "plain" otherwise, a refusal logged once per reason, or raised
    as ValueError under `cfg.kernels` True."""
    if not (cfg.solver == "dopri5" and not cfg.remat
            and cfg.kernels is not False and not torch.is_grad_enabled()
            and x0.is_cuda and x0.dtype == torch.float32
            and not torch.cuda.is_current_stream_capturing()):
        return None
    if not gp_params.dimwise:
        return "plain"
    s, n, _ = x0.shape
    reason = kernel_refusal("dopri5_attempt_draws", n, gp_params.z.shape[1],
                            gp_params.u_mean.shape[1], gp_params.num_inducing,
                            draws.weights.shape[-2], draws=s)
    if reason is not None and cfg.kernels:
        raise ValueError(f"dopri5_attempt_draws refuses this shape: {reason}")
    if reason is not None and reason not in _REFUSALS_LOGGED:
        _REFUSALS_LOGGED.add(reason)
        _logger.warning("the batched solve's attempt kernel refuses this "
                        "shape (%s): capturing the plain attempt", reason)
    return "plain" if reason else "fused"


def _captured_attempt(gp_params: gp.SVGPParams, draws: gp.PosteriorDraw,
                      x0: torch.Tensor, ts: torch.Tensor, cfg: SolverConfig,
                      use_kernel: bool, fused: bool) -> CapturedAttempt:
    """The cached captured attempt of this solve, its draws loaded."""
    t_host = ts.detach().cpu().numpy().astype(np.float32)
    direction = float(np.sign(t_host[-1] - t_host[0]))
    leaves = (gp_params.kernel.raw_lengthscales, gp_params.kernel.raw_variance,
              gp_params.z)
    # the graph bakes in the dense output's size, len(t_host)
    key = (x0.shape, x0.device,
           tuple((leaf.shape, leaf.dtype) for leaf in draws), cfg.rtol,
           cfg.atol, use_kernel, fused, len(t_host), direction,
           gp._RFF_SCALE_FACTOR, torch.backends.cuda.matmul.allow_tf32,
           tuple((id(t), t.data_ptr()) for t in leaves))
    if key in _ATTEMPTS:
        _ATTEMPTS.move_to_end(key)
        captured = _ATTEMPTS[key]
    else:
        captured = CapturedAttempt(gp_params, draws, x0, direction, cfg.rtol,
                                   cfg.atol, use_kernel, fused, len(t_host))
        captured.capture()
        _ATTEMPTS[key] = captured
        while len(_ATTEMPTS) > _MAX_ATTEMPTS:
            _ATTEMPTS.popitem(last=False)
    captured.load(draws)
    return captured


def flow_forward_batched(gp_params: gp.SVGPParams, draws: gp.PosteriorDraw,
                         x0: torch.Tensor, ts: torch.Tensor,
                         cfg: SolverConfig) -> tuple[torch.Tensor, ODEStats]:
    """Integrate S independent draws as ONE batched solve: draws carry a
    leading draw axis S, x0 is (S, N, D). Returns ((S, N, T, D), stats).

    The rhs evaluates every draw at once (`gp.eval_draws`: one batched plain
    evaluation below the kernel gate, which is decided per draw's N rows).
    Step-size control is shared across draws with the max-of-per-draw-RMS
    error norm, so each draw's accuracy is at least what its own controller
    would enforce. `remat` rematerializes each batched evaluation; the
    continuous adjoint is a train-path option that this forward-only eval
    route does not implement (a warning says so, as in the JAX package).

    With grad mode off, float32 states on a card and `cfg.kernels` not
    False, dopri5's attempt is a :class:`CapturedAttempt`, captured once
    per shape and replayed per attempt under the same controller
    (`_capture_route`): for a dimwise GP at a shape it takes, the fused
    `dopri5_attempt_draws` kernel (the same step as the eager attempt up to
    the field's summation order), else the eager attempt's kernels in the
    same order (the same states and `ODEStats`), followed in the graph by
    the `draws_commit` kernel: the dense output and hand-over of an
    accepted step on the device, bit for bit the host's. Every other solve
    runs the eager attempt and forms its dense output on the host.
    """
    if cfg.use_adjoint:
        warnings.warn(
            "flow_forward_batched does not implement use_adjoint; gradients "
            "(if any) flow by autodiff-through-solver. Set remat=True to "
            "bound backward memory for large draw batches.", stacklevel=2)
    use_kernel = _kernels_active(cfg, gp_params, x0.shape[1],
                                 draws.weights.shape[-2], "fused_rhs")

    def rhs(t, x):
        del t  # time-invariant ODE
        return gp.eval_draws(gp_params, draws, x, use_kernel)

    if cfg.remat:
        rhs = _rematerialized(rhs)
    route = _capture_route(cfg, gp_params, draws, x0)
    attempt = (None if route is None else _captured_attempt(
        gp_params, draws, x0, ts, cfg, use_kernel, route == "fused"))
    xs, stats = odeint(rhs, x0, ts, solver=cfg.solver, rtol=cfg.rtol,
                       atol=cfg.atol, substeps=cfg.substeps,
                       max_steps=cfg.max_steps, first_step=cfg.first_step,
                       norm=max_rms_over_axis0, attempt=attempt)
    return torch.movedim(xs, 0, 2), stats


def flow_inverse(gp_params: gp.SVGPParams, draw: gp.PosteriorDraw,
                 x1: torch.Tensor, ts: torch.Tensor,
                 cfg: SolverConfig) -> tuple[torch.Tensor, ODEStats]:
    """Integrate backward over the reversed ts: the states at flip(ts),
    (N, T, D)."""
    return flow_forward(gp_params, draw, x1, torch.flip(ts, [0]), cfg)


def flow_forward_sampled(gp_params: gp.SVGPParams,
                         weight_normals: torch.Tensor,
                         freq_normals: torch.Tensor,
                         phase_uniforms: torch.Tensor,
                         inducing_normals: torch.Tensor, x0: torch.Tensor,
                         ts: torch.Tensor, cfg: SolverConfig,
                         chol_zz: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, ODEStats]:
    """Build one posterior draw from its noise (as `gp.draw_posterior`
    takes it: no leading draw axis), then integrate from x0 over ts with
    `flow_forward`. Returns ((N, T, D), stats)."""
    draw = gp.draw_posterior(gp_params, weight_normals, freq_normals,
                             phase_uniforms, inducing_normals, chol_zz,
                             kernels=cfg.kernels)
    return flow_forward(gp_params, draw, x0, ts, cfg)
