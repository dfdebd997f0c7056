"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at the official bench shapes (N=3000 segment rows, Din=D=5, M=100, S=256).

Needs an NVIDIA GPU with nvcc: `pytest -m gpu tests/test_torch_gpu.py`.
Without a card every test here skips (the check runs inside a fixture).
Tolerances: forward rtol 1e-4 (atol 1e-5 * max|ref|); cotangents atol
1e-3 * max|g| (the kernels sum features, inducing points and blocks in
another order than the plain version).
"""

import numpy as np
import pytest
import torch

from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import wide_rhs as wr

pytestmark = pytest.mark.gpu

N, DIM, M, S = 3000, 5, 100, 256
NAMES = ("x", "z", "lengthscales", "variance", "omega", "phase", "weights", "nu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ls = rng.uniform(0.8, 1.6, size=(DIM, DIM)).astype(f32)
    arrays = (rng.normal(size=(N, DIM)), rng.normal(size=(M, DIM)), ls,
              rng.uniform(0.3, 0.8, size=(DIM,)),
              rng.normal(size=(DIM, S, DIM)) / ls.T[:, None, :],
              2 * np.pi * rng.uniform(size=(1, S, DIM)),
              rng.normal(size=(S, DIM)), 0.3 * rng.normal(size=(DIM, M)))
    return [torch.tensor(np.asarray(a, f32), device=dev, requires_grad=True)
            for a in arrays]


def _grads(out, inputs, g, retain=False):
    return torch.autograd.grad(out, inputs, g, retain_graph=retain)


def _assert_close(got, want, what, fwd=True):
    want = want.detach()
    scale = float(want.abs().max())
    atol = (1e-5 if fwd else 1e-3) * scale
    torch.testing.assert_close(got.detach(), want, rtol=1e-4 if fwd else 0.0,
                               atol=atol, msg=what)


def test_fused_rhs_forward_and_backward_match_plain(cuda):
    args = _inputs(cuda)
    g = torch.randn(N, DIM, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = dict(ck.LAUNCHES)
    out = ck.fused_rhs(*args)
    ref = ck.fused_rhs_plain(*args)
    _assert_close(out, ref, "forward")
    for name, a, b in zip(NAMES, _grads(out, args, g), _grads(ref, args, g)):
        _assert_close(a, b, name, fwd=False)
    assert ck.LAUNCHES["fused_rhs_fwd"] == before["fused_rhs_fwd"] + 1
    assert ck.LAUNCHES["fused_rhs_bwd"] == before["fused_rhs_bwd"] + 1


def test_fused_dopri5_attempt_forward_and_backward_match_plain(cuda):
    args = _inputs(cuda, seed=2)
    dt = torch.full((1,), 0.01, device=cuda)
    g = torch.randn(N, DIM, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    x5, err = ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    rx5, rerr, _ = ck.dopri5_attempt_plain(args[0], dt, *args[1:], 1e-6, 1e-6)
    _assert_close(x5, rx5, "x5")
    # the embedded error at dt=0.01 is of the order of float32 rounding of
    # the stage sums in both versions; the step compares its RMS with 1
    torch.testing.assert_close(err, rerr, rtol=0.0, atol=0.1)
    for name, a, b in zip(NAMES, _grads(x5, args, g), _grads(rx5, args, g)):
        _assert_close(a, b, name, fwd=False)


def test_fused_dopri5_attempt_error_estimate_over_a_long_span(cuda):
    """Over a long span the embedded error stands far above rounding, so the
    kernel's error estimate is held to the plain one tightly."""
    args = [a.detach() for a in _inputs(cuda, seed=5)]
    dt = torch.full((1,), 0.5, device=cuda)
    x5, err = ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    rx5, rerr, _ = ck.dopri5_attempt_plain(args[0], dt, *args[1:], 1e-6, 1e-6)
    _assert_close(x5, rx5, "x5")
    assert float(rerr.abs().max()) > 1e3
    torch.testing.assert_close(err, rerr, rtol=1e-3,
                               atol=1e-4 * float(rerr.abs().max()))


def test_ragged_last_block_and_bit_reproducible_cotangents(cuda):
    args = _inputs(cuda, seed=4)
    x = args[0][:37].detach().clone().requires_grad_()
    g = torch.randn(37, DIM, device=cuda)
    out = ck.fused_rhs(x, *args[1:])
    _assert_close(out, ck.fused_rhs_plain(x, *args[1:]), "ragged forward")
    first = _grads(out, [x] + args[1:], g)
    second = _grads(ck.fused_rhs(x, *args[1:]), [x] + args[1:], g)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name  # fixed-order reduction, no atomics


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    args = _inputs(cuda)
    with pytest.raises(ValueError):
        ck.fused_rhs(args[0][:, :3].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        ck.fused_rhs(args[0].detach().t().contiguous().t(), *args[1:])
    dt = torch.full((1,), 0.01, device=cuda)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError):  # Din != D
        ck.fused_rk4_segment(args[0][:, :3].contiguous(), dt, *args[1:])
    with pytest.raises(ValueError):  # dt on the host
        ck.fused_rk4_segment(args[0], dt.cpu(), *args[1:])
    with pytest.raises(TypeError):   # float64 operands
        ck.fused_rk4_segment(args[0].double(), dt, *args[1:])
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("substeps", [1, 3])
def test_fused_rk4_segment_forward_and_backward_match_plain(cuda, substeps):
    args = _inputs(cuda, seed=6)
    dt = torch.full((1,), 0.01, device=cuda)
    g = torch.randn(N, DIM, device=cuda, generator=torch.Generator(cuda).manual_seed(7))
    before = dict(ck.LAUNCHES)
    x1 = ck.fused_rk4_segment(args[0], dt, *args[1:], substeps)
    rx1, rxs = ck.rk4_segment_plain(args[0], dt, *args[1:], substeps)
    _assert_close(x1, rx1, "x1")
    for name, a, b in zip(NAMES, _grads(x1, args, g), _grads(rx1, args, g)):
        _assert_close(a, b, name, fwd=False)
    assert ck.LAUNCHES["fused_rk4_segment_fwd"] == before["fused_rk4_segment_fwd"] + 1
    assert ck.LAUNCHES["fused_rk4_segment_bwd"] == before["fused_rk4_segment_bwd"] + 1
    # the stage inputs the forward kernel saves for the backward
    with torch.no_grad():
        ops = ck._kernel_operands(*[a.detach() for a in args[1:]])
        _, xs = ck._launch_rk4_fwd(args[0].detach(), dt, substeps, ops, DIM,
                                   DIM, M, S)
    _assert_close(xs, rxs, "stage inputs")


def test_batched_draws_take_the_kernel_once_per_draw_at_the_gate(cuda):
    """`gp.eval_draws` at 256 rows per draw (the gate) launches the fused
    rhs once per draw and equals the batched plain evaluation."""
    from gpode_tpu_torch.models import gp

    params = gp.init_svgp(torch.Generator().manual_seed(0), DIM, DIM, M,
                          device=cuda)
    n_draws, rows = 3, 256
    gen = torch.Generator(cuda).manual_seed(9)
    with torch.no_grad():
        draws = gp.draw_posterior(
            params, torch.randn(n_draws, S, DIM, device=cuda, generator=gen),
            torch.randn(n_draws, DIM, S, DIM, device=cuda, generator=gen),
            torch.rand(n_draws, 1, S, DIM, device=cuda, generator=gen),
            torch.randn(n_draws, M, DIM, device=cuda, generator=gen))
        x = torch.randn(n_draws, rows, DIM, device=cuda, generator=gen)
        before = ck.LAUNCHES["fused_rhs_fwd"]
        got = gp.eval_draws(params, draws, x)
        assert ck.LAUNCHES["fused_rhs_fwd"] == before + n_draws
        _assert_close(got, gp.eval_draws(params, draws, x, use_kernel=False),
                      "per-draw kernel")
        assert ck.LAUNCHES["fused_rhs_fwd"] == before + n_draws


def test_fused_rk4_segment_ragged_block_and_bit_reproducible_cotangents(cuda):
    args = _inputs(cuda, seed=8)
    x = args[0][:37].detach().clone().requires_grad_()
    dt = torch.full((1,), 0.05, device=cuda)
    g = torch.randn(37, DIM, device=cuda)
    out = ck.fused_rk4_segment(x, dt, *args[1:], 2)
    ref, _ = ck.rk4_segment_plain(x, dt, *args[1:], 2)
    _assert_close(out, ref, "ragged forward")
    first = _grads(out, [x] + args[1:], g)
    for name, a, b in zip(NAMES, first, _grads(ref, [x] + args[1:], g)):
        _assert_close(a, b, name, fwd=False)
    second = _grads(ck.fused_rk4_segment(x, dt, *args[1:], 2), [x] + args[1:], g)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name  # fixed-order reduction, no atomics


@pytest.mark.parametrize("n,m", [(N, M), (77, M), (N, 256)],
                         ids=["bench", "ragged_n77", "m256"])
def test_rbf_gram_matches_plain(cuda, n, m):
    rng = np.random.default_rng(10)
    f32 = np.float32
    x, z, ls, var = (torch.tensor(np.asarray(a, f32), device=cuda) for a in (
        rng.normal(size=(n, DIM)), rng.normal(size=(m, DIM)),
        rng.uniform(0.8, 1.6, size=(DIM, DIM)), rng.uniform(0.3, 0.8, size=(DIM,))))
    before = ck.LAUNCHES["rbf_gram"]
    got = ck.rbf_gram(x, z, ls, var)
    assert ck.LAUNCHES["rbf_gram"] == before + 1
    assert got.shape == (DIM, n, m)
    _assert_close(got, ck.rbf_gram_plain(x, z, ls, var), "gram")
    with pytest.raises(RuntimeError, match="forward only"):
        ck.rbf_gram(x.clone().requires_grad_(), z, ls, var)
    with pytest.raises(TypeError):
        ck.rbf_gram(x.double(), z, ls, var)
    with pytest.raises(ValueError):
        ck.rbf_gram(x, z.cpu(), ls, var)
    assert ck.LAUNCHES["rbf_gram"] == before + 1


def _wide_inputs(dev, n, m, seed, din=DIM, d=DIM, s=S):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = (rng.normal(size=(n, din)), rng.normal(size=(m, din)),
              1.0 + rng.uniform(size=(d, din)), 0.5 + rng.uniform(size=(d,)),
              rng.normal(size=(din, s, d)), 6.28 * rng.uniform(size=(1, s, d)),
              rng.normal(size=(s, d)), rng.normal(size=(d, m)))
    return [torch.tensor(np.asarray(a, f32), device=dev) for a in arrays]


@pytest.mark.parametrize("n,m,din,d,s", [
    (2995, M, DIM, DIM, S), (N, 256, DIM, DIM, S), (37, 27, DIM, DIM, S),
    (203, 40, 10, 12, 100), (203, 40, 3, 2, S)],
    ids=["rows2995", "m256", "ragged_padded", "din10_d12_s100", "din3_d2"])
def test_wide_kernels_match_plain(cuda, n, m, din, d, s):
    """The three wide kernels against their plain versions; 2995 rows and
    (37, M=27) leave a ragged last pass, M=27 and S=100 pad their blocks;
    Din=10, D=12 takes the kernels' wider register layout (its backward's
    accumulators fill 212 KB of shared memory), Din != D both ways."""
    args = _wide_inputs(cuda, n, m, seed=11, din=din, d=d, s=s)
    g = torch.randn(n, d, device=cuda, generator=torch.Generator(cuda).manual_seed(12))
    before = dict(ck.LAUNCHES)
    _assert_close(wr.fused_rhs_wide(*args), wr.fused_rhs_wide_plain(*args), "wide")
    _assert_close(wr.fused_rhs_wide2(*args), wr.fused_rhs_wide2_plain(*args), "wide2")
    _assert_close(wr.fused_rhs_wide(*args), ck.fused_rhs_plain(*args), "per-dim plain")
    got = wr.fused_rhs_wide_bwd(*args, g)
    for name, a, b in zip(NAMES, got, wr.fused_rhs_wide_bwd_plain(*args, g)):
        _assert_close(a, b, name, fwd=False)
    again = wr.fused_rhs_wide_bwd(*args, g)
    for name, a, b in zip(NAMES, got, again):
        assert torch.equal(a, b), name  # fixed-order reduction, no atomics
    assert ck.LAUNCHES["fused_rhs_wide_fwd"] == before["fused_rhs_wide_fwd"] + 2
    assert ck.LAUNCHES["fused_rhs_wide2_fwd"] == before["fused_rhs_wide2_fwd"] + 1
    assert ck.LAUNCHES["fused_rhs_wide_bwd"] == before["fused_rhs_wide_bwd"] + 2


def test_wide_wrappers_raise_instead_of_falling_back(cuda):
    args = _wide_inputs(cuda, 64, M, seed=13)
    before = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="forward only"):
        wr.fused_rhs_wide(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(TypeError):
        wr.fused_rhs_wide2(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        wr.fused_rhs_wide_bwd(*args, torch.ones(64, DIM + 1, device=cuda))
    big = _wide_inputs(cuda, 64, 40, seed=14, din=10, d=12)  # W = 3840
    with pytest.raises(ValueError, match="shared memory"):
        wr.fused_rhs_wide_bwd(*big, torch.ones(64, 12, device=cuda))
    with pytest.raises(ValueError, match="Din, D <= 16"):
        wr.fused_rhs_wide(*_wide_inputs(cuda, 8, 8, seed=15, din=3, d=17, s=32))
    assert ck.LAUNCHES == before


def _segment_inputs(dev, n, dim, m, s, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ls = rng.uniform(0.8, 1.6, size=(dim, dim)).astype(f32)
    arrays = (rng.normal(size=(n, dim)), rng.normal(size=(m, dim)), ls,
              rng.uniform(0.3, 0.8, size=(dim,)),
              rng.normal(size=(dim, s, dim)) / ls.T[:, None, :],
              2 * np.pi * rng.uniform(size=(1, s, dim)),
              rng.normal(size=(s, dim)), 0.3 * rng.normal(size=(dim, m)))
    return [torch.tensor(np.asarray(a, f32), device=dev, requires_grad=True)
            for a in arrays]


# (N, Din = D, M, S): N off the row tile, one row, M = 256, the exact-width
# variant (5), both padded widths (8 and 10 -> 16), the narrow one (2), and S
# and M that leave ragged 32-column units
SEGMENT_SHAPES = [(2970, 5, 100, 256), (2970, 5, 256, 256), (77, 5, 100, 256),
                  (1, 5, 100, 256), (203, 8, 100, 256), (203, 10, 100, 256),
                  (50, 2, 16, 32), (203, 3, 40, 100)]
SEGMENT_IDS = ["official", "m256", "ragged_n77", "one_row", "din8", "din10",
               "tiny", "ragged_units"]


def _check_segment_backward(cuda, out, ref, args, what):
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(21))
    first = _grads(out, args, g, retain=True)
    for name, a, b in zip(NAMES, first, _grads(ref, args, g)):
        _assert_close(a, b, f"{what} d{name}", fwd=False)
    for name, a, b in zip(NAMES, first, _grads(out, args, g)):
        assert torch.equal(a, b), name  # fixed-order reduction, no atomics


@pytest.mark.parametrize("n,dim,m,s", SEGMENT_SHAPES, ids=SEGMENT_IDS)
def test_fused_dopri5_attempt_backward_over_shapes(cuda, n, dim, m, s):
    args = _segment_inputs(cuda, n, dim, m, s, seed=20)
    dt = torch.full((1,), 0.01, device=cuda)
    before = ck.LAUNCHES["fused_dopri5_attempt_bwd"]
    x5, _ = ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    rx5, _, _ = ck.dopri5_attempt_plain(args[0], dt, *args[1:], 1e-6, 1e-6)
    _check_segment_backward(cuda, x5, rx5, args, "dopri5 attempt")
    assert ck.LAUNCHES["fused_dopri5_attempt_bwd"] == before + 2


@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("n,dim,m,s", SEGMENT_SHAPES, ids=SEGMENT_IDS)
def test_fused_rk4_segment_backward_over_shapes(cuda, n, dim, m, s, substeps):
    args = _segment_inputs(cuda, n, dim, m, s, seed=22)
    dt = torch.full((1,), 0.03, device=cuda)
    before = ck.LAUNCHES["fused_rk4_segment_bwd"]
    x1 = ck.fused_rk4_segment(args[0], dt, *args[1:], substeps)
    rx1, _ = ck.rk4_segment_plain(args[0], dt, *args[1:], substeps)
    _check_segment_backward(cuda, x1, rx1, args, f"rk4 x{substeps}")
    assert ck.LAUNCHES["fused_rk4_segment_bwd"] == before + 2


def test_segment_backward_raises_on_unsupported_shapes(cuda):
    """Din = D = 16 needs 404 KB of accumulators: refused before a launch."""
    args = _segment_inputs(cuda, 8, 16, 100, 256, seed=23)
    dt = torch.full((1,), 0.01, device=cuda)
    before = (ck.LAUNCHES["fused_rk4_segment_bwd"],
              ck.LAUNCHES["fused_dopri5_attempt_bwd"])
    x1 = ck.fused_rk4_segment(args[0], dt, *args[1:], 1)
    with pytest.raises(ValueError, match="shared memory"):
        x1.sum().backward()
    x5, _ = ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    with pytest.raises(ValueError, match="shared memory"):
        x5.sum().backward()
    assert before == (ck.LAUNCHES["fused_rk4_segment_bwd"],
                      ck.LAUNCHES["fused_dopri5_attempt_bwd"])
