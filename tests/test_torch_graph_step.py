"""The captured train step's CPU parts against the JAX package and the eager
step, on the CPU at small sizes.

* `ops/math.cholesky_small` / `cholesky_jittered_auto` against the JAX
  package's at D = 1, 2, 5, 8 (the unrolled branch) and 9 (the library
  branch), batched: factors rtol 1e-6 (atol 1e-6 * max|L|), gradients rtol
  1e-5 (atol 1e-6 * max|g|) — the same recurrence in float32 on both sides;
* the state entropy and log densities built on them against the JAX
  package's (rtol 1e-5);
* the device-count `trainer.Adam` bit-equal over 50 updates to the
  host-float Adam it replaced (`tests/_torch_host_adam.py`);
* `graph_step.CapturedStep` on the CPU (no graphs: the capture's control
  flow, with the accept seam reading the error RMS on the host) bit-equal
  to `make_train_step` on a small official (dopri5 whole-span attempt) and
  `fast` (rk4 segment) problem, a forced reject included; the capture's
  launch bookkeeping on stand-in graphs, and its one capture stream, shared
  with the prediction solve's captured attempt;
* `capture_refusal` over the configurations it refuses and those it takes,
  and the `Trainer` with model args on the CPU equal to the one without.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.models import states as jstates
from gpode_tpu.ops import math as jom

from gpode_tpu_torch.models import flow as tflow
from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.models import states as tstates
from gpode_tpu_torch.models.shooting import sample_step_noise
from gpode_tpu_torch.ops import capture
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import math as tom
from gpode_tpu_torch.train import graph_step
from gpode_tpu_torch.train import trainer as tt
from gpode_tpu_torch.train.bench_setup import preset_model_args
from gpode_tpu_torch.train.builders import (ModelArgs, build_gpode,
                                            build_shooting,
                                            default_frozen_predicate,
                                            shooting_loss_fn,
                                            shooting_noise_fn)

from _torch_host_adam import HostFloatAdam, ToyParams, run_adam_pair

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the small Cholesky
# ---------------------------------------------------------------------------

def _spd(batch, d, seed):
    """Well-conditioned SPD matrices (batch..., d, d) in float32."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=batch + (d, d))
    return (b @ np.swapaxes(b, -1, -2) / d + 0.5 * np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 5, 8, 9])
def test_cholesky_jittered_auto_matches_jax(d):
    a = _spd((4, 3), d, seed=d)
    w = np.random.default_rng(100 + d).normal(size=a.shape).astype(np.float32)
    want = np.asarray(jom.cholesky_jittered_auto(jnp.asarray(a)))
    jgrad = np.asarray(jax.grad(lambda m: jnp.sum(
        jom.cholesky_jittered_auto(m) * w))(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    got = tom.cholesky_jittered_auto(at)
    (tgrad,) = torch.autograd.grad(torch.sum(got * torch.tensor(w)), at)
    assert got.shape == want.shape == (4, 3, d, d)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-6 * float(np.abs(jgrad).max()))
    assert np.all(np.triu(got.detach().numpy(), 1) == 0.0)


@pytest.mark.parametrize("d", [1, 3, 5, 8])
def test_cholesky_small_is_the_library_factor(d):
    a = torch.tensor(_spd((6,), d, seed=20 + d))
    got = tom.cholesky_small(a)
    torch.testing.assert_close(got, torch.linalg.cholesky(a), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(got @ got.mT, a, rtol=1e-5, atol=1e-5)


def _posterior(n, t1, d, seed):
    """A JAX shooting posterior with non-trivial factors, and the port's
    with the same arrays."""
    rng = np.random.default_rng(seed)
    packed = d * (d + 1) // 2
    diag = np.cumsum(np.arange(1, d + 1)) - 1   # the packed diagonal
    x0_mean = rng.normal(size=(n, d)).astype(np.float32)
    x0_tril = (0.3 * rng.normal(size=(n, packed))).astype(np.float32)
    mean = rng.normal(size=(n, t1, d)).astype(np.float32)
    tril = (0.3 * rng.normal(size=(n, t1, packed))).astype(np.float32)
    x0_tril[:, diag] += 1.0
    tril[:, :, diag] += 1.0
    jp = jstates.ShootingStatePosterior(
        jstates.InitialStatePosterior(x0_mean, x0_tril), mean, tril)
    tp = tstates.ShootingStatePosterior(
        tstates.InitialStatePosterior(torch.tensor(x0_mean),
                                      torch.tensor(x0_tril)),
        torch.tensor(mean), torch.tensor(tril))
    return jp, tp, rng


@pytest.mark.parametrize("d", [2, 5])
def test_state_entropy_and_log_densities_match_jax(d):
    """The (N, T-1, D, D) factors through the unrolled Cholesky: the
    shooting entropy and both log densities against the JAX package's."""
    jp, tp, rng = _posterior(3, 6, d, seed=d)
    x0 = rng.normal(size=(3, d)).astype(np.float32)
    xs = rng.normal(size=(3, 6, d)).astype(np.float32)
    with torch.no_grad():
        got = (tstates.shooting_entropy(tp),
               tstates.initial_state_log_prob(tp.x0, torch.tensor(x0)),
               tstates.shooting_log_prob(tp, torch.tensor(xs)))
    want = (jstates.shooting_entropy(jp),
            jstates.initial_state_log_prob(jp.x0, x0),
            jstates.shooting_log_prob(jp, xs))
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


# ---------------------------------------------------------------------------
# Adam with a device count
# ---------------------------------------------------------------------------

N_UPDATES = 50
ADAM_CASES = {
    "constant": dict(lr=5e-3),
    "cosine": dict(lr=tt.cosine_decay(5e-3, N_UPDATES, alpha=0.01)),
    "cosine_past_horizon": dict(lr=tt.cosine_decay(5e-3, 20, alpha=0.01)),
    "clip": dict(lr=5e-3, grad_clip=1.0),
    "frozen": dict(lr=5e-3, frozen_predicate=default_frozen_predicate(
        ModelArgs())),
}


@pytest.mark.parametrize("reload_at", [None, 20], ids=["straight", "reloaded"])
@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_device_count_adam_is_bit_equal_to_host_float_adam(case, reload_at):
    kw = ADAM_CASES[case]
    (new_p, new), (host_p, host) = run_adam_pair(
        lambda p: tt.Adam(p, **kw), lambda p: HostFloatAdam(p, **kw),
        N_UPDATES, reload_at=reload_at)
    assert new.count == host.count == N_UPDATES
    assert isinstance(new.state()["count"], int)
    for a, b in zip(list(new_p.parameters()) + new.mu + new.nu,
                    list(host_p.parameters()) + host.mu + host.nu):
        assert torch.equal(a, b)
    if case == "frozen":
        assert torch.equal(new_p.constraint.raw_scale,
                           ToyParams().constraint.raw_scale)


def test_adam_schedules_carry_their_horizon():
    assert tt.lr_schedule(tt.TrainConfig(num_iter=7)).horizon == 0
    cfg = tt.TrainConfig(num_iter=7, lr_schedule="cosine")
    assert tt.lr_schedule(cfg).horizon == 7
    with pytest.raises(ValueError, match="horizon"):
        tt.Adam(torch.nn.Linear(2, 2), lambda count: 1e-3)


def test_adam_count_is_a_device_tensor_set_and_read_on_the_host():
    adam = tt.Adam(torch.nn.Linear(2, 2), 5e-3)
    assert isinstance(adam._count, torch.Tensor) and adam.count == 0
    adam.count = 17
    assert int(adam._count) == 17 and adam.state()["count"] == 17


# ---------------------------------------------------------------------------
# the captured step's control flow on the CPU
# ---------------------------------------------------------------------------

SMALL = dict(num_inducing=8, num_features=16, dimwise=True, ts_dense_scale=2,
             max_steps=8, num_samples=2)
SMALL_ARGS = {
    "official": ModelArgs(solver="dopri5", first_step=-1.0, **SMALL),
    "fast": ModelArgs(solver="rk4", **SMALL),
}
N_STEPS = 9
REJECT_AT = (4, 6)   # the capture's first replay is the third call


def _problem(args, seed=0):
    rng = np.random.RandomState(seed)
    ys = rng.randn(3, 10, 5).astype(np.float32)
    ts = torch.tensor(np.linspace(0.0, 0.9, 10).astype(np.float32))
    params = build_shooting(torch.Generator().manual_seed(seed), args, ys,
                            device="cpu")
    return params, torch.tensor(ys), ts


def _train(args, captured, stretch=()):
    """N_STEPS steps from one start through `make_train_step` or the
    captured step (the kernels' rule forced on: the segment kernels'
    plain versions at these few rows); the grid stretched 30x at the steps
    in `stretch`. Returns (losses, attempts, params, step)."""
    params, ys, ts = _problem(args)
    opt = tt.default_optimizer(params, 5e-3, grad_clip=10.0)
    loss_fn = shooting_loss_fn(args, kernels=True)
    make = (graph_step.make_captured_train_step if captured
            else tt.make_train_step)
    step = make(loss_fn, params, opt)
    gen = torch.Generator().manual_seed(1)
    losses, natts, kept = [], [], []
    for i in range(N_STEPS):
        noise = sample_step_noise(params, args.num_features, args.num_samples,
                                  gen)
        terms = step(noise, ys, 30.0 * ts if i in stretch else ts)
        kept.append(terms.loss)
        losses.append(float(terms.loss.detach()))
        natts.append(terms.natt)
    # the returned terms are copies: later steps left them as they were
    assert [float(t.detach()) for t in kept] == losses
    return losses, natts, params, step


@pytest.mark.parametrize("stretch", [(), REJECT_AT], ids=["accepted", "rejects"])
@pytest.mark.parametrize("preset", ["official", "fast"])
def test_split_step_on_the_cpu_equals_the_eager_step(preset, stretch):
    args = SMALL_ARGS[preset]
    losses, natts, params, _ = _train(args, False, stretch)
    c_losses, c_natts, c_params, step = _train(args, True, stretch)
    assert c_losses == losses and c_natts == natts
    for a, b in zip(c_params.parameters(), params.parameters()):
        assert torch.equal(a, b)
    rejected = [i for i, n in enumerate(natts) if n > 1]
    after_warmup = N_STEPS - capture.WARMUP
    if preset == "official":
        assert rejected == list(stretch)
        assert step.host_reads == after_warmup
        assert step.rejects == len(stretch)
        assert step.replays == after_warmup - len(stretch)
    else:
        assert rejected == [] and step.host_reads == 0
        assert step.replays == after_warmup


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph` on the CPU: records the capture
    boundaries and replays nothing."""

    log: list = []

    def capture_begin(self, pool=None):
        self.log.append(("begin", pool))

    def capture_end(self):
        self.log.append(("end", None))

    def replay(self):
        self.log.append(("replay", None))


class _FakeStream:
    def __init__(self, device=None):
        del device

    def wait_stream(self, other):
        del other


def _fake_cuda(monkeypatch):
    _FakeGraph.log = []
    monkeypatch.setattr(capture, "capture_stream", functools.lru_cache(
        maxsize=None)(capture.capture_stream.__wrapped__))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


@pytest.mark.parametrize("seam", [True, False], ids=["two_graphs", "one_graph"])
def test_capture_bookkeeping_on_stand_in_graphs(monkeypatch, seam):
    """The capture splits at the accept read into two graphs of one pool,
    counts each graph's wrapper launches and takes them back out (a capture
    runs nothing), and every replay adds them again; an accept read above 1
    runs the eager step after graph A."""
    _fake_cuda(monkeypatch)
    params = torch.nn.Linear(2, 1)

    class Terms(NamedTuple):
        loss: torch.Tensor
        natt: int

    def loss_fn(p, noise, x):
        ck.LAUNCHES["fused_dopri5_attempt_fwd"] += 1
        if seam and tflow._ACCEPT_SEAM.get() is not None:
            tflow._ACCEPT_SEAM.get().read(torch.tensor(0.5))
        ck.LAUNCHES["fused_dopri5_attempt_bwd"] += 1
        loss = torch.sum(p(x) ** 2) * noise.scale
        return loss, Terms(loss, 1)

    @dataclasses.dataclass
    class Noise:
        scale: torch.Tensor

    monkeypatch.setattr(capture, "WARMUP", 1)
    step = graph_step.CapturedStep(loss_fn, params, tt.Adam(params, 1e-3))
    step.cuda = True   # the capture path
    x = torch.ones(3, 2)
    ck.reset_launch_counts()
    step(Noise(torch.tensor(1.0)), x)                    # warm-up, eager
    assert ck.LAUNCHES["fused_dopri5_attempt_fwd"] == 1
    step(Noise(torch.tensor(2.0)), x)                    # capture + replay
    graphs = 2 if seam else 1
    assert len(step.graphs) == graphs
    assert [e for e, _ in _FakeGraph.log] == (
        ["begin", "end", "begin", "end"] if seam else ["begin", "end"]
        ) + ["replay"] * graphs
    assert {pool for e, pool in _FakeGraph.log if e == "begin"} == {"pool"}
    assert step.graph_launches == (
        [{"fused_dopri5_attempt_fwd": 1}, {"fused_dopri5_attempt_bwd": 1}]
        if seam else
        [{"fused_dopri5_attempt_fwd": 1, "fused_dopri5_attempt_bwd": 1}])
    assert ck.LAUNCHES["fused_dopri5_attempt_fwd"] == 2
    assert ck.LAUNCHES["fused_dopri5_attempt_bwd"] == 2
    assert torch.equal(step._noise.scale, torch.tensor(2.0))
    step._rms.fill_(2.0)     # what a replay of graph A would write
    step(Noise(torch.tensor(3.0)), x)
    assert torch.equal(step._noise.scale, torch.tensor(3.0))
    if seam:   # graph A, the read, then the eager step (no seam: accepted)
        assert step.rejects == 1 and step.replays == 1
        assert ck.LAUNCHES["fused_dopri5_attempt_fwd"] == 4
    else:
        assert step.rejects == 0 and step.replays == 2
        assert ck.LAUNCHES["fused_dopri5_attempt_fwd"] == 3
    with pytest.raises(ValueError, match="shape"):
        step(Noise(torch.ones(2)), x)


def test_the_step_and_the_attempt_capture_on_one_stream(monkeypatch):
    """The captured train step and the prediction solve's captured attempt
    warm up and capture on one stream object, the card's capture stream
    (`ops/capture.py`): the step enters it for each warm-up step and its
    capture, the attempt for its warm-up and its capture."""
    _fake_cuda(monkeypatch)
    entered = []
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: (
        entered.append(stream), contextlib.nullcontext())[1])

    class _FakeCapture:
        def __init__(self, graph, pool=None, stream=None):
            del pool
            self.graph = graph
            entered.append(stream)

        def __enter__(self):
            self.graph.capture_begin()

        def __exit__(self, *exc):
            self.graph.capture_end()

    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)

    class Terms(NamedTuple):
        loss: torch.Tensor

    @dataclasses.dataclass
    class Noise:
        scale: torch.Tensor

    def loss_fn(p, noise, x):
        loss = torch.sum(p(x) ** 2) * noise.scale
        return loss, Terms(loss)

    params = torch.nn.Linear(2, 1)
    step = graph_step.CapturedStep(loss_fn, params, tt.Adam(params, 1e-3))
    step.cuda = True   # the capture path
    for _ in range(capture.WARMUP + 1):
        step(Noise(torch.tensor(1.0)), torch.ones(3, 2))
    assert len(step.graphs) == 1 and len(entered) == capture.WARMUP + 1

    gen = torch.Generator().manual_seed(0)
    gp_params = tgp.init_svgp(gen, 2, 2, 4)
    with torch.no_grad():
        draws = tgp.draw_posterior(
            gp_params, torch.randn(3, 8, 2, generator=gen),
            torch.randn(3, 2, 8, 2, generator=gen),
            torch.rand(3, 1, 8, 2, generator=gen),
            torch.randn(3, 4, 2, generator=gen))
        attempt = tflow.CapturedAttempt(
            gp_params, draws, torch.randn(3, 2, 2, generator=gen), 1.0, 1e-6,
            1e-6, False, True, 5)
        attempt.cuda = True   # the capture path
        attempt.capture()
    assert isinstance(attempt.graph, _FakeGraph)
    assert len(entered) == capture.WARMUP + 3
    stream = capture.capture_stream(torch.device("cpu"))
    assert isinstance(stream, _FakeStream)
    assert all(s is stream for s in entered)


# ---------------------------------------------------------------------------
# which steps are captured
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_like():
    """Shooting params at the bench problem's shape (6 sequences, 100
    steps, 5 latents) for each preset, built on the CPU."""
    ys = np.zeros((6, 100, 5), np.float32)
    out = {}
    for preset in ("official", "fast", "scale"):
        args = preset_model_args(preset)
        out[preset] = (args, build_shooting(torch.Generator().manual_seed(0),
                                            args, ys, device="cpu"))
    return out


@pytest.mark.parametrize("preset", ["official", "fast", "scale"])
def test_capture_refusal_takes_the_segment_kernel_presets(bench_like, preset):
    args, params = bench_like[preset]
    assert graph_step.capture_refusal(args, "cuda", params) is None


REFUSED = {
    "cpu": ({}, "CPU"),
    "mesh": ({}, "--mesh"),
    "adjoint": (dict(use_adjoint=True), "use_adjoint"),
    "hairer": (dict(first_step=None), "Hairer"),
    "set_first_step": (dict(first_step=0.01), "first step"),
    "euler": (dict(solver="euler"), "euler"),
    "midpoint": (dict(solver="midpoint"), "midpoint"),
    **{s: (dict(solver=s), "multistep") for s in
       ("explicit_adams", "fixed_adams", "implicit_adams", "adams", "bdf")},
    "plain_rule": ({}, "not taken"),
    "below_256_rows": (dict(segment_minibatch=8), "not taken"),
    "vanilla": ({}, "vanilla"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_capture_refusal_refuses(bench_like, case):
    changes, match = REFUSED[case]
    args, params = bench_like["official"]
    args = dataclasses.replace(args, **changes)
    device, mesh, kernels = "cuda", None, None
    if case == "cpu":
        device = "cpu"
    elif case == "mesh":
        mesh = object()
    elif case == "plain_rule":
        kernels = False
    elif case == "vanilla":
        params = build_gpode(torch.Generator().manual_seed(0), args,
                             np.zeros((6, 100, 5), np.float32), device="cpu")
    reason = graph_step.capture_refusal(args, device, params, kernels, mesh)
    assert reason is not None and match in reason


def test_trainer_with_model_args_on_the_cpu_runs_the_eager_step(caplog):
    """On the CPU the Trainer's default step stays the eager one (the
    refusal logged once); its losses and parameters equal a Trainer's
    without model args."""
    args = SMALL_ARGS["official"]
    runs = []
    graph_step._REFUSALS_LOGGED.discard("the CPU: CUDA graphs need a card")
    for model_args in (None, args):
        params, ys, ts = _problem(args)
        trainer = tt.Trainer(shooting_loss_fn(args),
                             tt.TrainConfig(num_iter=4, log_freq=0),
                             shooting_noise_fn(args), model_args=model_args)
        with caplog.at_level("INFO"):
            trainer.train(params, torch.Generator().manual_seed(1), ys, ts)
        runs.append((trainer.loss_meter.vals,
                     [p.detach().clone() for p in params.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert sum("not captured (the CPU" in r.getMessage()
               for r in caplog.records) == 1
