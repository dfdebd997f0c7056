"""An accepted attempt's commit on the device (`cuda_kernels.draws_commit`:
the dense output and the hand-over of `ops/ode.odeint_dopri5`, the last node
of the batched solve's captured attempt), on the CPU.

Its plain version against the host's dense output and hand-over, bit for
bit, over random intervals and the edges; the kernel's arithmetic
(`csrc/dopri5_draws.cu` `draws_commit_kernel`), mirrored op for op in numpy
float32, against the plain version; and the batched solve through the
rehearsed `CapturedAttempt` that commits against the solve with no captured
attempt: states, `ODEStats` and the dense-output counter
(`ode.DENSE_POINTS`).
"""

import numpy as np
import pytest
import torch

from gpode_tpu_torch.models import flow as tflow
from gpode_tpu_torch.models import gp as tgp
from gpode_tpu_torch.models.flow import SolverConfig, flow_forward_batched
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import ode

from _torch_capture import rehearse_captures

torch.set_num_threads(1)

F32 = np.float32
SHAPE = (4, 2, 5)   # draws, rows a draw, D


def _states(seed, shape=SHAPE):
    """x, k1, x_new, k7 of `shape`, seeded."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen) for _ in range(4)]


def _taus(seed, count=120, decreasing=False):
    """A solve's output times as `odeint_dopri5` forms them from a random
    grid: direction * (ts - ts[0]), float32, increasing from 0."""
    rng = np.random.default_rng(seed)
    ts = np.concatenate([[0.3], 0.3 + np.cumsum(rng.uniform(0.001, 0.05,
                                                            count - 1))])
    ts = ts[::-1] if decreasing else ts
    t_host = ts.astype(F32)
    direction = F32(np.sign(t_host[-1] - t_host[0]))
    return direction * (t_host - t_host[0])


def _host_commit(taus, tau, tau_end, x, k1, x_new, k7, ratio, dense):
    """`odeint_dopri5`'s host commit on copies: the points not yet covered
    (those after tau) up to tau_end from `_hermite`, then the hand-over;
    nothing on a reject. Returns (dense, x, k1)."""
    dense, x, k1 = dense.clone(), x.clone(), k1.clone()
    if float(ratio) <= 1.0:
        covered = [tau_j <= tau for tau_j in taus]
        for j, tau_j in enumerate(taus):
            if not covered[j] and tau_j <= tau_end:
                dense[j] = ode._hermite(tau_j, tau, tau_end, x, k1, x_new, k7)
        x, k1 = x_new.clone(), k7.clone()
    return dense, x, k1


def _interval(case, taus, rng):
    """(tau, tau_end) of a commit case, float32."""
    if case in ("random", "rejected", "nan", "ratio_one", "decreasing"):
        a, b = sorted(rng.choice(len(taus) - 1, 2, replace=False))
        lo = F32(taus[a] + F32(0.3) * (taus[a + 1] - taus[a]))
        return lo, F32(taus[b] + F32(0.5) * (taus[b + 1] - taus[b]))
    if case == "h_zero":
        return taus[7], taus[7]
    if case == "at_end":    # tau_end on an output time: it is written
        return F32(taus[3] + F32(0.5) * (taus[4] - taus[3])), taus[9]
    if case == "at_start":  # tau on an output time: it was written before
        return taus[3], F32(taus[9] + F32(0.5) * (taus[10] - taus[9]))
    if case == "no_point":  # inside one output interval
        return (F32(taus[5] + F32(0.2) * (taus[6] - taus[5])),
                F32(taus[5] + F32(0.7) * (taus[6] - taus[5])))
    if case == "whole_span":
        return F32(0.0), taus[-1]
    raise ValueError(case)


COMMIT_CASES = ["random", "h_zero", "at_end", "at_start", "no_point",
                "whole_span", "decreasing", "rejected", "nan", "ratio_one"]


def _commit_inputs(case, seed, shape=SHAPE):
    """(taus, tau, tau_end, ratio, scalars, dense) of a commit case: the
    dense output (T, *shape) filled with 7."""
    rng = np.random.default_rng(seed)
    taus = _taus(seed, decreasing=case == "decreasing")
    tau, tau_end = _interval(case, taus, rng)
    ratio = {"rejected": 1.5, "nan": float("nan"), "ratio_one": 1.0}.get(
        case, float(rng.uniform(0.0, 1.0)))
    scalars = torch.tensor([0.0, tau, tau_end], dtype=torch.float32)
    assert scalars[1].item() == tau and scalars[2].item() == tau_end
    dense = torch.full((len(taus), *shape), 7.0)
    return taus, tau, tau_end, torch.tensor(ratio), scalars, dense


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_the_plain_commit_is_the_host_dense_output_and_hand_over(case, seed):
    """`draws_commit_plain` and the wrapper on CPU tensors (no launch
    counted) write the points, x and k1 that the host's dense output and
    hand-over write, bit for bit, and nothing on a rejected or NaN ratio."""
    taus, tau, tau_end, ratio, scalars, dense = _commit_inputs(case, seed)
    x, k1, x_new, k7 = _states(seed)
    want = _host_commit(taus, tau, tau_end, x, k1, x_new, k7, ratio, dense)
    before = dict(ck.LAUNCHES)
    for fn in (ck.draws_commit_plain, ck.draws_commit):
        got = (dense.clone(), x.clone(), k1.clone())
        fn(ratio, scalars, torch.from_numpy(taus), got[0], got[1], got[2],
           x_new, k7)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ck.LAUNCHES == before
    written = int((~(want[0] == 7.0).all(dim=(1, 2, 3))).sum())
    expect = {"rejected": 0, "nan": 0, "h_zero": 0, "no_point": 0,
              "at_end": 6, "at_start": 6, "whole_span": len(taus) - 1}
    if case in expect:
        assert written == expect[case]
    else:
        assert written >= 1
    accepted = case not in ("rejected", "nan")
    assert torch.equal(want[1], x_new if accepted else x)


def _kernel_arith(ratio, scalars, taus, dense, x, k1, x_new, k7):
    """`draws_commit_kernel`'s arithmetic, op for op in numpy float32 (each
    op rounds once, as the kernel's `__f*_rn` intrinsics do): returns the
    new (dense, x, k1)."""
    dense, x, k1 = (t.numpy().copy() for t in (dense, x, k1))
    x_new, k7 = x_new.numpy(), k7.numpy()
    if not float(ratio) <= 1.0:
        return dense, x, k1
    _, t0, t1 = scalars.numpy()
    h = F32(t1 - t0)
    h = F32(1.0) if h == 0.0 else h
    for j, t in enumerate(taus):
        if not (t0 < t <= t1):
            continue
        s = F32(F32(t - t0) / h)
        s2 = F32(s * s)
        s3 = F32(s2 * s)
        h00 = F32(F32(F32(F32(2.0) * s3) - F32(F32(3.0) * s2)) + F32(1.0))
        h10 = F32(F32(s3 - F32(F32(2.0) * s2)) + s)
        h01 = F32(F32(F32(-2.0) * s3) + F32(F32(3.0) * s2))
        h11 = F32(s3 - s2)
        v = (h00 * x).astype(F32) + (F32(h10 * h) * k1).astype(F32)
        v = v.astype(F32) + (h01 * x_new).astype(F32)
        dense[j] = v.astype(F32) + (F32(h11 * h) * k7).astype(F32)
    return dense, x_new.copy(), k7.copy()


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_the_kernels_arithmetic_in_float32_is_the_plain_commit(case, seed):
    """The kernel's roundings (coefficients in float32 in numpy's order, no
    FMA, the terms added left to right), mirrored in numpy, give the plain
    version's points bit for bit."""
    taus, _, _, ratio, scalars, dense = _commit_inputs(case, seed)
    x, k1, x_new, k7 = _states(seed)
    want = (dense.clone(), x.clone(), k1.clone())
    ck.draws_commit_plain(ratio, scalars, torch.from_numpy(taus), *want,
                          x_new, k7)
    got = _kernel_arith(ratio, scalars, taus, dense, x, k1, x_new, k7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# the batched solve through the rehearsed captured attempt that commits
# ---------------------------------------------------------------------------

def _problem(num_draws=4, rows=2, dim=5, m=8, s=16, seed=0):
    """A dimwise GP with perturbed hyperparameters, `num_draws` posterior
    draws and start states (num_draws, rows, dim)."""
    gen = torch.Generator().manual_seed(seed)
    params = tgp.init_svgp(gen, dim, dim, m)
    with torch.no_grad():
        params.kernel.raw_lengthscales.add_(
            0.3 * torch.randn(dim, dim, generator=gen))
        params.u_mean.normal_(generator=gen)
        draws = tgp.draw_posterior(
            params, torch.randn(num_draws, s, dim, generator=gen),
            torch.randn(num_draws, dim, s, dim, generator=gen),
            torch.rand(num_draws, 1, s, dim, generator=gen),
            torch.randn(num_draws, m, dim, generator=gen))
    return params, draws, torch.randn(num_draws, rows, dim, generator=gen)


SOLVE_CASES = {  # ts, SolverConfig keywords
    "forward": (torch.linspace(0.0, 2.0, 30), {}),
    "backward": (torch.linspace(2.0, 0.0, 30), {}),
    "rejects": (torch.linspace(0.0, 2.0, 30),
                {"first_step": ode.FIRST_STEP_SPAN}),
    "max_steps": (torch.linspace(0.0, 2.0, 30), {"max_steps": 4}),
    "repeated_start": (torch.tensor([0.0, 0.0, 0.5, 0.5, 1.0]), {}),
    "kernels_off": (torch.linspace(0.0, 2.0, 30), {"kernels": False}),
}


def _solve(monkeypatch, captured, params, draws, x0, ts, **cfg):
    rehearse_captures(monkeypatch, captured)
    kw = dict(solver="dopri5", max_steps=64, rtol=1e-5, atol=1e-5)
    kw.update(cfg)
    points = dict(ode.DENSE_POINTS)
    with torch.no_grad():
        xs, stats = flow_forward_batched(params, draws, x0, ts,
                                         SolverConfig(**kw))
    return xs, stats, {k: ode.DENSE_POINTS[k] - points[k] for k in points}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_the_committing_captured_solve_equals_the_eager_one(monkeypatch,
                                                            case):
    """`flow_forward_batched` through the rehearsed `CapturedAttempt`, which
    commits each accepted attempt with the plain `draws_commit`, returns
    the solve with no captured attempt bit for bit, states and `ODEStats`
    (`num_covered` too): forward and backward in time, from the whole span
    (rejects), out of `max_steps` (the uncovered tail holds the last
    state), with output times at the start and repeated. The counter
    reads every point as the device's on the captured path and the host's
    on the eager one; with the kernels off no attempt is captured and the
    host forms the points on both sides."""
    monkeypatch.setattr(tflow, "_ATTEMPTS", type(tflow._ATTEMPTS)())
    ts, cfg = SOLVE_CASES[case]
    params, draws, x0 = _problem(seed=len(case))
    want, wst, wpoints = _solve(monkeypatch, False, params, draws, x0, ts,
                                **cfg)
    got, st, points = _solve(monkeypatch, True, params, draws, x0, ts, **cfg)
    assert torch.equal(got, want) and st == wst
    start = int((ts == ts[0]).sum())
    formed = wst.num_covered - start
    assert wpoints == {"host": formed, "device": 0}
    assert formed > 0
    if case == "max_steps":
        assert wst.num_covered < len(ts)
        assert torch.equal(got[:, :, -1], got[:, :, wst.num_covered])
    else:
        assert wst.num_covered == len(ts)
    if case == "rejects":
        assert wst.num_attempted > wst.num_accepted
    if case == "kernels_off":
        assert not tflow._ATTEMPTS
        assert points == {"host": formed, "device": 0}
        return
    (attempt,) = tflow._ATTEMPTS.values()
    assert len(attempt.taus) == len(ts)
    assert points == {"host": 0, "device": formed}
    statics = [attempt.x, attempt.k1, attempt.scalars, attempt.dense,
               *attempt.out]
    assert all(got.untyped_storage().data_ptr()
               != t.untyped_storage().data_ptr() for t in statics)


def test_solves_of_two_lengths_take_two_cached_attempts(monkeypatch):
    """The graph bakes in the dense output's size: solves over 30 and 12
    output times capture one attempt each, and each, again after the
    other, equals the eager solve bit for bit; the first's output is not
    written over by the second."""
    monkeypatch.setattr(tflow, "_ATTEMPTS", type(tflow._ATTEMPTS)())
    params, draws, x0 = _problem(seed=9)
    grids = (torch.linspace(0.0, 2.0, 30), torch.linspace(0.0, 1.0, 12))
    outs = []
    for ts in grids + grids:
        want, wst, _ = _solve(monkeypatch, False, params, draws, x0, ts)
        got, st, _ = _solve(monkeypatch, True, params, draws, x0, ts)
        assert torch.equal(got, want) and st == wst
        outs.append((got, got.clone()))
    assert sorted(len(a.taus) for a in tflow._ATTEMPTS.values()) == [12, 30]
    for got, copy in outs:
        assert torch.equal(got, copy)


def test_a_capture_that_fails_raises_and_caches_nothing(monkeypatch):
    """A capture that fails (a kernel that does not build or launch) fails
    the solve: no eager fallback, no cached attempt; the next solve
    captures again."""
    monkeypatch.setattr(tflow, "_ATTEMPTS", type(tflow._ATTEMPTS)())
    params, draws, x0 = _problem(seed=10)
    ts = torch.linspace(0.0, 2.0, 30)

    def fail(self):
        raise RuntimeError("the kernel did not build")

    monkeypatch.setattr(tflow.CapturedAttempt, "capture", fail)
    with pytest.raises(RuntimeError, match="did not build"):
        _solve(monkeypatch, True, params, draws, x0, ts)
    assert not tflow._ATTEMPTS
    monkeypatch.undo()
    monkeypatch.setattr(tflow, "_ATTEMPTS", type(tflow._ATTEMPTS)())
    want, wst, _ = _solve(monkeypatch, False, params, draws, x0, ts)
    got, st, _ = _solve(monkeypatch, True, params, draws, x0, ts)
    assert torch.equal(got, want) and st == wst
    assert len(tflow._ATTEMPTS) == 1
