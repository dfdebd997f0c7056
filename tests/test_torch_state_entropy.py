"""The shooting states' entropy (`states.shooting_entropy`) and its kernels
(`cuda_kernels.state_entropy`: `csrc/state_entropy.cu` on a card).

On the CPU: the route (`states.state_entropy_on_device`): a CPU tensor,
float64, D > 8 and `kernels=False` keep the unrolled chain, counted in
`cuda_kernels.STATE_ENTROPIES`, its value and gradient bit for bit the
chain as it stood before the kernels; the solver's rule reaches the
entropy; the backward kernel's arithmetic (`state_entropy_bwd_plain`)
bit for bit autograd's through the chain, and g A^{-1} L in float64; the
kernels' autograd
rule with plain launchers, first order only; the counter under capture;
the ctypes signatures against the C entry points; the benchmark's reader
of the counter (`device_state_entropies_pct`).

On the card (`-m gpu`; each test skips without one): the kernels against
the chain in float32 (the gradient bit for bit) and in float64 at D = 2,
5, 8 over (6, 99) factors, a
non-positive-definite factor non-finite on both paths, a captured graph's
replay bit for bit the eager call, one launch a direction a captured
official train step, no spills, refusals raising before any launch.
"""

import importlib.util
import math
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gpode_tpu_torch.models import states
from gpode_tpu_torch.ops import cuda_build
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import math as om

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "gpode_tpu_torch" / "csrc" / "state_entropy.cu"
N, T1, D = 6, 99, 5   # the MoCap train step: 6 sequences, 99 shooting states


def _scales(d, dtype=torch.float32, seed=0, device="cpu"):
    """Packed scales (N, T-1, d(d+1)/2) like a trained posterior's: the
    diagonal 0.1 e^(0.3 z), below it 0.02 z."""
    gen = torch.Generator().manual_seed(seed)
    rows, cols = torch.tril_indices(d, d)
    diag = (rows == cols).to(torch.float64)
    z = torch.randn(2, N, T1, d * (d + 1) // 2, generator=gen,
                    dtype=torch.float64)
    packed = diag * 0.1 * torch.exp(0.3 * z[0]) + (1 - diag) * 0.02 * z[1]
    return packed.to(dtype=dtype, device=device)


def _chain(tril_packed, d, jitter=om.DEFAULT_JITTER):
    """`shooting_entropy` as it stood before the kernels."""
    tril = om.fill_tril(tril_packed, d)
    chol = om.cholesky_jittered_auto(torch.matmul(tril, tril.mT), jitter)
    logdet = om.tri_logdet_from_chol(chol)
    return 0.5 * (d * (1.0 + math.log(2.0 * math.pi)) + logdet)


def _posterior(d, dtype=torch.float32, seed=0, device="cpu"):
    p = states.init_shooting_states(torch.Generator().manual_seed(seed), N, T1,
                                    d, device=device)
    with torch.no_grad():
        p.tril_packed.copy_(_scales(d, seed=seed, device=device))
    return p.to(dtype)


def _card_like(dtype=torch.float32):
    """What `state_entropy_on_device` reads of the packed scales, as a
    card's tensor."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype)


def _source():
    return SOURCE.read_text()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,kernels,on_device", [
    (torch.float32, 5, None, True), (torch.float32, 5, True, True),
    (torch.float32, 5, False, False), (torch.float64, 5, None, False),
    (torch.float32, 8, None, True), (torch.float32, 2, None, True),
    (torch.float32, 1, None, True), (torch.float32, 9, None, False),
    (torch.float64, 9, True, False)],
    ids=["auto", "on", "off", "float64", "d8", "d2", "d1", "d9",
         "d9_float64_on"])
def test_the_route_on_a_card(dtype, d, kernels, on_device):
    """A card's float32 scales at D <= 8 take the kernels unless the rule
    is False; float64 and D > 8 keep the unrolled chain under any rule."""
    assert states.state_entropy_on_device(_card_like(dtype), d,
                                          kernels) is on_device


@pytest.mark.parametrize("dtype,d,kernels", [
    (torch.float32, 5, None), (torch.float32, 5, True),
    (torch.float32, 5, False), (torch.float64, 5, None),
    (torch.float32, 9, None), (torch.float32, 2, None)],
    ids=["cpu", "cpu_on", "off", "float64", "d9", "d2"])
def test_the_cpu_keeps_the_unrolled_chain_bit_for_bit(dtype, d, kernels):
    """On the CPU every rule keeps the unrolled chain (D > 8: the library's
    factorisation, as before), counted "state_unrolled"; value and gradient
    are the chain's as it stood before the kernels, bit for bit."""
    p = _posterior(d, dtype)
    before = dict(ck.STATE_ENTROPIES)
    got = states.shooting_entropy(p, kernels=kernels)
    assert ck.STATE_ENTROPIES == {**before,
                                  "state_unrolled": before["state_unrolled"] + 1}
    (g_got,) = torch.autograd.grad(got.sum(), p.tril_packed)
    leaf = p.tril_packed.detach().clone().requires_grad_()
    want = _chain(leaf, d)
    (g_want,) = torch.autograd.grad(want.sum(), leaf)
    assert got.shape == (N, T1)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)


@pytest.mark.parametrize("kernels", [None, True, False],
                         ids=["auto", "on", "off"])
def test_the_kernel_rule_reaches_the_entropy(monkeypatch, kernels):
    """The shooting ELBO hands its solver's rule to the entropy."""
    from gpode_tpu_torch.models import flow
    from gpode_tpu_torch.models.shooting import elbo_loss, sample_step_noise
    from gpode_tpu_torch.train.builders import ModelArgs, build_shooting

    seen, route = [], states.state_entropy_on_device
    monkeypatch.setattr(states, "state_entropy_on_device",
                        lambda tril, d, rule: (seen.append(rule),
                                               route(tril, d, rule))[1])
    args = ModelArgs(num_features=8, num_inducing=6)
    ys = torch.randn(2, 4, 2, generator=torch.Generator().manual_seed(0))
    ts = 0.1 * torch.arange(4, dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    shoot = build_shooting(gen, args, ys.numpy(), device="cpu")
    elbo_loss(shoot, sample_step_noise(shoot, 8, 2, gen), ys, ts,
              flow.SolverConfig(kernels=kernels))
    assert seen == [kernels]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 5, 8])
def test_the_backward_arithmetic_is_autograds_through_the_chain(d, dtype):
    """The backward kernel's arithmetic (`state_entropy_bwd_plain`: the
    Cholesky's adjoint in autograd's order, then G L + (L^T G)^T) is
    autograd's gradient through the unrolled chain bit for bit."""
    leaf = _scales(d, dtype, seed=d).requires_grad_()
    g = torch.randn(N, T1, dtype=dtype,
                    generator=torch.Generator().manual_seed(d))
    (want,) = torch.autograd.grad(_chain(leaf, d), leaf, g)
    got = ck.state_entropy_bwd_plain(leaf.detach(), g, d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [2, 5])
def test_the_backward_is_g_a_inverse_l(d):
    """Mathematically the gradient is g A^{-1} L, A = L L^T + jitter I:
    two triangular solves on C = chol(A), in float64."""
    packed = _scales(d, torch.float64, seed=d)
    g = torch.randn(N, T1, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(d))
    L = om.fill_tril(packed, d)
    C = torch.linalg.cholesky(om.add_jitter(L @ L.mT, om.DEFAULT_JITTER))
    want = g[..., None] * om.pack_tril(
        om.solve_upper_from_lower(C, om.solve_lower(C, L)))
    torch.testing.assert_close(ck.state_entropy_bwd_plain(packed, g, d), want,
                               rtol=1e-10, atol=1e-12)


def _plain_launchers(monkeypatch):
    """The kernels' launchers as their plain versions (CPU tensors)."""
    monkeypatch.setattr(ck, "_state_entropy_fwd", lambda tril, d, jitter:
                        _chain(tril, d, jitter))
    monkeypatch.setattr(ck, "_state_entropy_bwd", lambda tril, g, d, jitter:
                        ck.state_entropy_bwd_plain(tril, g, d, jitter))


@pytest.mark.parametrize("d", [2, 5])
def test_the_autograd_rule_with_plain_launchers(monkeypatch, d):
    """The kernels' autograd rule (launchers monkeypatched: the plain
    versions stand in for the kernels) gives the chain's value and, through
    the backward, its gradient."""
    _plain_launchers(monkeypatch)
    leaf = _scales(d, torch.float64, seed=3).requires_grad_()
    out = ck._StateEntropyFn.apply(leaf, d, om.DEFAULT_JITTER)
    (got,) = torch.autograd.grad(out.sum(), leaf)
    ref = leaf.detach().clone().requires_grad_()
    want = _chain(ref, d)
    (g_want,) = torch.autograd.grad(want.sum(), ref)
    assert torch.equal(out.detach(), want.detach())
    torch.testing.assert_close(got, g_want, rtol=1e-10, atol=1e-12)


def test_double_backward_raises(monkeypatch):
    """The kernels' autograd rule is first order only."""
    _plain_launchers(monkeypatch)
    leaf = _scales(D, torch.float64).requires_grad_()
    out = ck._StateEntropyFn.apply(leaf, D, om.DEFAULT_JITTER)
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(out.sum(), leaf, create_graph=True)


def test_the_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: the CPU's path is the chain."""
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match="runs on a card"):
        ck.state_entropy(_scales(D), D)
    assert ck.LAUNCHES == before


def _c_parameters(text, fn):
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    return [p.strip() for p in params.split(",")]


@pytest.mark.parametrize("fn", sorted(ck._SIGNATURES["state_entropy"]))
def test_ctypes_signatures_match_the_c_entry_points(fn):
    """Pointers (and the stream) as void pointers, ints as ints, floats as
    floats, as the C declarations say."""
    want = [ck._P if "*" in p else ck._F if p.startswith("float ") else ck._I
            for p in _c_parameters(_source(), fn)]
    assert ck._SIGNATURES["state_entropy"][fn] == want


def test_the_source_states_its_limits_and_builds_with_the_others():
    """The C template covers D up to the route's limit, its kernels are the
    ones the occupancy query names, it takes no atomics, and the library
    builds with the others and counts both launches."""
    text = _source()
    assert re.search(r"#define MAX_DIM (\d+)", text).group(1) == str(
        om.SMALL_CHOL_MAX_DIM)
    for d in range(1, om.SMALL_CHOL_MAX_DIM + 1):
        assert f"case {d}: return RUN<{d}>" in text
    for name in ("state_entropy_fwd_kernel", "state_entropy_bwd_kernel"):
        assert re.search(rf"\b{name}\(", text), name
    assert "atomicAdd" not in text and "atomicCAS" not in text
    assert cuda_build.SOURCES["state_entropy"] == SOURCE.name
    assert {"state_entropy_fwd", "state_entropy_bwd"} <= set(ck.LAUNCHES)


def test_capture_counts_entropies_like_launches():
    """A capture's entropy calls are taken back out of
    `cuda_kernels.STATE_ENTROPIES` with its launches and draws, and each
    replay adds each key back to the counter that holds it; the three
    counters' keys are disjoint."""
    from gpode_tpu_torch.ops import capture
    keys = [set(c) for c in (ck.LAUNCHES, ck.DRAW_SOLVES, ck.STATE_ENTROPIES)]
    assert sum(map(len, keys)) == len(set().union(*keys))
    counters = [dict(c) for c in (ck.LAUNCHES, ck.DRAW_SOLVES,
                                  ck.STATE_ENTROPIES)]
    take = capture.launch_counter()
    ck.STATE_ENTROPIES["state_device"] += 1
    ck.LAUNCHES["state_entropy_fwd"] += 1
    ck.LAUNCHES["state_entropy_bwd"] += 1
    ck.DRAW_SOLVES["device"] += 1
    delta = take()
    assert delta == {"state_entropy_fwd": 1, "state_entropy_bwd": 1,
                     "device": 1, "state_device": 1}
    assert [ck.LAUNCHES, ck.DRAW_SOLVES, ck.STATE_ENTROPIES] == counters
    for _ in range(3):
        capture.replay_launches(delta)
    assert ck.STATE_ENTROPIES == {**counters[2], "state_device":
                                  counters[2]["state_device"] + 3}
    assert ck.DRAW_SOLVES["device"] == counters[1]["device"] + 3
    assert ck.LAUNCHES["state_entropy_bwd"] == counters[0]["state_entropy_bwd"] + 3


def _reader():
    path = ROOT / "benchmark" / "metrics" / "device_state_entropies_pct.py"
    spec = importlib.util.spec_from_file_location("device_state_entropies_pct",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("device,unrolled,pct",
                         [(22000, 0, 100.0), (0, 5, 0.0), (300, 100, 75.0)])
def test_reader_share_of_entropies_on_the_device(monkeypatch, device,
                                                 unrolled, pct):
    monkeypatch.setattr(ck, "STATE_ENTROPIES", {"state_device": device,
                                                "state_unrolled": unrolled})
    got = _reader().read(SimpleNamespace(trace=None, on_device=True))
    assert got == pytest.approx(pct)


@pytest.mark.parametrize("case", ["cpu", "no_counter", "no_call"])
def test_reader_nothing_to_read(monkeypatch, case):
    counts = ({"state_device": 0, "state_unrolled": 0} if case == "no_call"
              else {"state_device": 7, "state_unrolled": 1})
    monkeypatch.setattr(ck, "STATE_ENTROPIES", counts)
    if case == "no_counter":
        monkeypatch.delattr(ck, "STATE_ENTROPIES")
    ctx = SimpleNamespace(trace=None, on_device=case != "cpu")
    assert _reader().read(ctx) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 5, 8])
def test_the_kernels_match_the_chain(cuda, d):
    """Over (6, 99) factors: the forward within 1e-6 of the unrolled chain
    on the card and 1e-5 of float64 (relative to the largest entry); the
    backward bit for bit autograd's through the chain on the card, and so
    within 1e-5 of float64."""
    packed = _scales(d, seed=d, device=cuda)
    g = torch.randn(N, T1, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(d))
    before = dict(ck.LAUNCHES)
    leaf = packed.clone().requires_grad_()
    got = ck.state_entropy(leaf, d)
    (g_got,) = torch.autograd.grad(got, leaf, g)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["state_entropy_fwd"] == before["state_entropy_fwd"] + 1
    assert ck.LAUNCHES["state_entropy_bwd"] == before["state_entropy_bwd"] + 1
    chain_leaf = packed.clone().requires_grad_()
    chain = _chain(chain_leaf, d)
    (g_chain,) = torch.autograd.grad(chain, chain_leaf, g)
    assert torch.equal(g_got, g_chain)
    ref = packed.double().requires_grad_()
    exact = _chain(ref, d)
    (g_exact,) = torch.autograd.grad(exact, ref, g.double())
    errs = (_rel(got, chain), _rel(got, exact), _rel(g_got, g_exact))
    print(f"D={d}: forward {errs[0]:.2e} off the chain, {errs[1]:.2e} off "
          f"float64; backward {errs[2]:.2e} off float64")
    assert errs[0] <= 1e-6 and errs[1] <= 1e-5 and errs[2] <= 1e-5
    again = ck.state_entropy(leaf, d)
    (g_again,) = torch.autograd.grad(again, leaf, g)
    assert torch.equal(got, again) and torch.equal(g_got, g_again)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["negative_pivot", "singular"])
def test_a_non_positive_definite_factor_is_non_finite(cuda, case):
    """A negative pivot (jitter -1 on 0.1 I: NaN) and a zero one (two equal
    rows of L, no jitter: -inf) give a non-finite entropy on both paths, in
    that factor only."""
    p = _posterior(D, device=cuda)
    jitter = -1.0 if case == "negative_pivot" else 0.0
    with torch.no_grad():
        p.tril_packed.copy_(om.pack_tril(0.1 * torch.eye(D, device=cuda)))
        if case == "singular":
            p.tril_packed[0, 0].copy_(om.pack_tril(torch.tensor(
                [[1.0, 0, 0, 0, 0], [1.0, 0, 0, 0, 0], [0, 0, 1.0, 0, 0],
                 [0, 0, 0, 1.0, 0], [0, 0, 0, 0, 1.0]], device=cuda)))
    kern = states.shooting_entropy(p, jitter)
    chain = states.shooting_entropy(p, jitter, kernels=False)
    for out in (kern, chain):
        if case == "singular":
            assert not torch.isfinite(out[0, 0])
            assert torch.isfinite(out.flatten()[1:]).all()
        else:
            assert not torch.isfinite(out).any()


@pytest.mark.gpu
def test_a_captured_replay_equals_the_eager_call(cuda):
    """Both kernels captured in a CUDA graph: a replay on fresh scales and
    cotangents equals the eager launches on them, bit for bit."""
    from gpode_tpu_torch.ops import capture

    packed = _scales(D, device=cuda)
    g = torch.randn(N, T1, device=cuda)

    def run():
        leaf = packed.requires_grad_()
        out = ck.state_entropy(leaf, D)
        (grad,) = torch.autograd.grad(out, leaf, g)
        packed.requires_grad_(False)
        return out.detach(), grad

    graph = torch.cuda.CUDAGraph()
    with capture.on_capture_stream(cuda) as stream:
        for _ in range(capture.WARMUP):
            run()
        with torch.cuda.graph(graph, stream=stream):
            static = run()
    for seed in (1, 2):
        with torch.no_grad():
            packed.copy_(_scales(D, seed=seed, device=cuda))
            g.normal_(generator=torch.Generator(cuda).manual_seed(seed))
        graph.replay()
        torch.cuda.synchronize()
        eager = run()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))


@pytest.mark.gpu
def test_a_captured_official_step_launches_each_kernel_once(cuda):
    """The official train step, eager and captured, 10 steps each: the
    entropy takes the kernels, one forward and one backward launch a step
    (a replay counted as its capture), one "state_device" call a step."""
    import copy

    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.graph_step import make_captured_train_step
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(preset_model_args("official"),
                                               device=cuda)
    for make in (make_train_step, make_captured_train_step):
        p = copy.deepcopy(params)
        step = make(shooting_loss_fn(args), p, default_optimizer(p, 5e-3))
        gen = torch.Generator(cuda).manual_seed(5)
        launches, calls = dict(ck.LAUNCHES), dict(ck.STATE_ENTROPIES)
        for _ in range(10):
            step(sample_step_noise(p, args.num_features, args.num_samples,
                                   gen), ys, ts)
        torch.cuda.synchronize()
        for k in ("state_entropy_fwd", "state_entropy_bwd"):
            assert ck.LAUNCHES[k] - launches[k] == 10, (make.__name__, k)
        assert ck.STATE_ENTROPIES == {
            "state_device": calls["state_device"] + 10,
            "state_unrolled": calls["state_unrolled"]}


@pytest.mark.gpu
def test_the_kernels_compile_without_spills(cuda):
    """Every instantiation (D = 1..8, both directions) free of spills and
    of local memory."""
    found = cuda_build.kernel_resources("state_entropy")
    assert len(found) == 2 * om.SMALL_CHOL_MAX_DIM
    for rec in found.values():
        assert rec["spill_stores"] == 0 and rec["spill_loads"] == 0
    for direction in ("fwd", "bwd"):
        for d in range(1, om.SMALL_CHOL_MAX_DIM + 1):
            report = ck.state_entropy_occupancy(direction, d)
            assert report["local_bytes"] == 0 and report["blocks_per_sm"] >= 1


@pytest.mark.gpu
def test_the_wrapper_raises_instead_of_falling_back(cuda):
    """On the card the wrapper launches or raises: float64, D=9 and a
    packed size that is not D's raise before any launch."""
    before = dict(ck.LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        ck.state_entropy(_scales(D, torch.float64, device=cuda), D)
    with pytest.raises(ValueError, match="D <= 8"):
        ck.state_entropy(torch.zeros(4, 45, device=cuda), 9)
    with pytest.raises(ValueError, match="tril_packed must be"):
        ck.state_entropy(torch.zeros(4, 14, device=cuda), D)
    assert ck.LAUNCHES == before
