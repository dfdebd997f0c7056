"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at the official bench shapes (N=3000 segment rows, Din=D=5, M=100, S=256),
and at the FHN shooting default and the plots' VDP grid.

Needs an NVIDIA GPU with nvcc: `pytest -m gpu tests/test_torch_gpu.py`.
Without a card every test here skips (the check runs inside a fixture).
Tolerances: forward rtol 1e-4 (atol 1e-5 * max|ref|); cotangents atol
1e-3 * max|g| (the kernels sum features, inducing points and blocks in
another order than the plain version). Also the time-to-LL driver's init
on the card against the same init on the CPU.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gpode_tpu_torch.ops import capture
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


def test_double_backward_through_the_kernels_raises(cuda):
    """A backward with `create_graph` through each kernel's autograd rule
    raises, also under the unit cotangents of a Newton Jacobian; a
    first-order backward runs."""
    args = _inputs(cuda)
    dt = torch.full((1,), 0.01, device=cuda)
    outs = {"fused_rhs": ck.fused_rhs(*args),
            "dopri5": ck.fused_dopri5_attempt(args[0], dt, *args[1:])[0],
            "rk4": ck.fused_rk4_segment(args[0], dt, *args[1:])}
    for name, out in outs.items():
        unit = torch.zeros_like(out)
        unit[:, 0] = 1.0
        _grads(out, args, unit, retain=True)
        with pytest.raises(RuntimeError, match="first order"):
            torch.autograd.grad(out, args[0], unit, create_graph=True)


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


@pytest.mark.parametrize("d", [1, 2, 5])
@pytest.mark.parametrize("din", [2, 5, 17, 40])
@pytest.mark.parametrize("m", [16, 17, 100, 256])
@pytest.mark.parametrize("n", [1, 77, 900, N])
def test_rbf_gram_over_shapes(cuda, n, m, din, d):
    """One launch per call, the plain version's values (M % 4 != 0 takes the
    scalar stores; Din 17 and 40 the runtime-Din variant), and a rerun
    bit-identical."""
    rng = np.random.default_rng(n + 7 * m + 31 * din + 101 * d)
    f32 = np.float32
    x, z, ls, var = (torch.tensor(np.asarray(a, f32), device=cuda) for a in (
        rng.normal(size=(n, din)), rng.normal(size=(m, din)),
        rng.uniform(0.8, 1.6, size=(d, din)), rng.uniform(0.3, 0.8, size=(d,))))
    before = ck.LAUNCHES["rbf_gram"]
    got = ck.rbf_gram(x, z, ls, var)
    assert ck.LAUNCHES["rbf_gram"] == before + 1
    assert got.shape == (d, n, m)
    _assert_close(got, ck.rbf_gram_plain(x, z, ls, var), f"gram {n}x{m}")
    assert torch.equal(got, ck.rbf_gram(x, z, ls, var))



@pytest.mark.parametrize("n,m,din", [(N, M, DIM), (77, 17, 2), (900, 16, 16)],
                         ids=["bench", "ragged", "din16"])
def test_rbf_gram_any_din_variant_gives_the_exact_variants_bits(cuda, n, m, din):
    """The runtime-Din variant (z rows in shared memory) launched at the
    geometry of a Din the exact variants take gives their bits."""
    rng = np.random.default_rng(n + m + din)
    f32 = np.float32
    x, z, ls, var = (torch.tensor(np.asarray(a, f32), device=cuda) for a in (
        rng.normal(size=(n, din)), rng.normal(size=(m, din)),
        rng.uniform(0.8, 1.6, size=(DIM, din)), rng.uniform(0.3, 0.8, size=(DIM,))))
    exact = ck.rbf_gram(x, z, ls, var)
    geo = ck.gram_geometry(n, din, DIM, m, ck._sms(cuda))
    assert geo.dp != ck.GRAM_ANY_DIN
    out = torch.empty_like(exact)
    inv_ls = (1.0 / ls).contiguous()
    rc = ck._lib("rbf_gram").gpode_rbf_gram(
        ck._ptr(x), ck._ptr(z), ck._ptr(inv_ls), ck._ptr(var), ck._ptr(out),
        n, din, DIM, m, ck.GRAM_ANY_DIN, geo.rows_per_block, geo.lanes,
        geo.groups_per_block, ck._stream(cuda))
    assert rc == 0
    assert torch.equal(out, exact)


@pytest.mark.parametrize("din", [17, 40])
def test_cross_gram_takes_rbf_gram_past_din_16(cuda, din):
    """`gp.cross_gram` without gradients launches `rbf_gram` once at a Din
    above the exact variants and agrees with the `rbf_K` route; a Din over
    the kernel's shared-memory limit raises before any launch."""
    from gpode_tpu_torch.models import gp
    params = gp.init_svgp(torch.Generator().manual_seed(0), din, din, M,
                          device=cuda)
    x = torch.randn(N, din, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = ck.LAUNCHES["rbf_gram"]
    with torch.no_grad():
        got = gp.cross_gram(params, x)
        want = gp.rbf_K(params.kernel, params.z, x)
    assert ck.LAUNCHES["rbf_gram"] == before + 1
    _assert_close(got, want, f"cross_gram Din={din}")
    wide = ck.GRAM_MAX_DIN + 1
    with pytest.raises(ValueError, match="Din <="):
        ck.rbf_gram(torch.zeros(3, wide, device=cuda),
                    torch.zeros(4, wide, device=cuda),
                    torch.ones(1, wide, device=cuda), torch.ones(1, device=cuda))
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
    (1, M, DIM, DIM, S), (203, 40, 10, 12, 100), (203, 40, 3, 2, S),
    (203, 40, 2, 8, S), (300, M, 16, 16, S)],
    ids=["rows2995", "m256", "ragged_padded", "one_row", "din10_d12_s100",
         "din3_d2", "din2_d8", "widest_d16"])
def test_wide_kernels_match_plain(cuda, n, m, din, d, s):
    """The three wide kernels against their plain versions, and two runs of
    each bit-identical (every sum in one fixed order, no atomics); 2995 rows,
    (37, M=27) and one row leave a ragged last tile, M=27 and S=100 pad
    their units; Din != D both ways takes the variant of max(Din, D): 5, 8
    and 16 (Din=10, D=12 and the widest, 16)."""
    args = _wide_inputs(cuda, n, m, seed=11, din=din, d=d, s=s)
    g = torch.randn(n, d, device=cuda, generator=torch.Generator(cuda).manual_seed(12))
    before = dict(ck.LAUNCHES)
    f, f2 = wr.fused_rhs_wide(*args), wr.fused_rhs_wide2(*args)
    _assert_close(f, wr.fused_rhs_wide_plain(*args), "wide")
    _assert_close(f2, wr.fused_rhs_wide2_plain(*args), "wide2")
    _assert_close(f, ck.fused_rhs_plain(*args), "per-dim plain")
    assert torch.equal(f, wr.fused_rhs_wide(*args))
    assert torch.equal(f2, wr.fused_rhs_wide2(*args))
    got = wr.fused_rhs_wide_bwd(*args, g)
    for name, a, b in zip(NAMES, got, wr.fused_rhs_wide_bwd_plain(*args, g)):
        _assert_close(a, b, name, fwd=False)
    again = wr.fused_rhs_wide_bwd(*args, g)
    for name, a, b in zip(NAMES, got, again):
        assert torch.equal(a, b), name
    assert ck.LAUNCHES["fused_rhs_wide_fwd"] == before["fused_rhs_wide_fwd"] + 2
    assert ck.LAUNCHES["fused_rhs_wide2_fwd"] == before["fused_rhs_wide2_fwd"] + 2
    assert ck.LAUNCHES["fused_rhs_wide_bwd"] == before["fused_rhs_wide_bwd"] + 2


def test_wide_wrappers_raise_instead_of_falling_back(cuda):
    """Wrong operands raise, and so does a shape the geometry refuses, all
    before any launch. The backward holds one dim's accumulators per block:
    it takes Din=10, D=12, M=40 (which the whole-axis accumulators of the
    former backward refused) and refuses Din = D = 16 at M = S = 1024 (33
    floats for each of a dim's 2048 columns, 270 KB)."""
    args = _wide_inputs(cuda, 64, M, seed=13)
    before = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="forward only"):
        wr.fused_rhs_wide(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(TypeError):
        wr.fused_rhs_wide2(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        wr.fused_rhs_wide_bwd(*args, torch.ones(64, DIM + 1, device=cuda))
    big = _wide_inputs(cuda, 64, 1024, seed=14, din=16, d=16, s=1024)
    with pytest.raises(ValueError, match="shared memory"):
        wr.fused_rhs_wide_bwd(*big, torch.ones(64, 16, device=cuda))
    with pytest.raises(ValueError, match="Din, D <= 16"):
        wr.fused_rhs_wide(*_wide_inputs(cuda, 8, 8, seed=15, din=3, d=17, s=32))
    assert ck.LAUNCHES == before
    taken = _wide_inputs(cuda, 64, 40, seed=14, din=10, d=12)   # W = 3840
    g = torch.randn(64, 12, device=cuda, generator=torch.Generator(cuda).manual_seed(16))
    for name, a, b in zip(NAMES, wr.fused_rhs_wide_bwd(*taken, g),
                          wr.fused_rhs_wide_bwd_plain(*taken, g)):
        _assert_close(a, b, name, fwd=False)
    assert ck.LAUNCHES["fused_rhs_wide_bwd"] == before["fused_rhs_wide_bwd"] + 1


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
    """Din = D = 16 needs 404 KB of accumulators: when a gradient will be
    taken, the call raises before any launch (the forward's included);
    without one the forward runs."""
    args = _segment_inputs(cuda, 8, 16, 100, 256, seed=23)
    dt = torch.full((1,), 0.01, device=cuda)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ck.fused_rk4_segment(args[0], dt, *args[1:], 1)
    with pytest.raises(ValueError, match="shared memory"):
        ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    assert ck.LAUNCHES == before
    with torch.no_grad():
        x1 = ck.fused_rk4_segment(args[0], dt, *args[1:], 1)
        x5, _ = ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    _assert_close(x1, ck.rk4_segment_plain(args[0], dt, *args[1:], 1)[0], "x1")
    _assert_close(x5, ck.dopri5_attempt_plain(args[0], dt, *args[1:])[0], "x5")
    assert ck.LAUNCHES["fused_rk4_segment_fwd"] == before["fused_rk4_segment_fwd"] + 1
    assert ck.LAUNCHES["fused_rk4_segment_bwd"] == before["fused_rk4_segment_bwd"]


# (N, Din, D, M, S): the bench shape, ragged tiles (37, 2995 rows; S=100
# and M=40 leave ragged 32-column units), one row, M=256, Din != D both
# ways, and the widest D the backward takes (square at the bench's M and S;
# Din <= 4 with its 640-thread variant)
RHS_SHAPES = [(N, DIM, DIM, M, S), (37, DIM, DIM, M, S), (1, DIM, DIM, M, S),
              (2995, DIM, DIM, M, S), (N, DIM, DIM, 256, S),
              (203, DIM, DIM, 40, 100), (300, 3, 5, M, S), (300, 8, 2, M, S),
              (300, 11, 11, M, S), (300, 4, 20, 40, 64)]
RHS_IDS = ["bench", "ragged_n37", "one_row", "rows2995", "m256",
           "ragged_units", "din3_d5", "din8_d2", "widest_square_d11",
           "widest_d20"]


@pytest.mark.parametrize("n,din,d,m,s", RHS_SHAPES, ids=RHS_IDS)
def test_fused_rhs_over_shapes(cuda, n, din, d, m, s):
    """Both `fused_rhs` kernels against the plain version, one launch per
    direction per call, and two calls bit-identical (every sum in one fixed
    order, no atomics)."""
    args = [a.requires_grad_() for a in _wide_inputs(cuda, n, m, 30, din, d, s)]
    g = torch.randn(n, d, device=cuda, generator=torch.Generator(cuda).manual_seed(31))
    before = dict(ck.LAUNCHES)
    out = ck.fused_rhs(*args)
    first = _grads(out, args, g)
    assert ck.LAUNCHES["fused_rhs_fwd"] == before["fused_rhs_fwd"] + 1
    assert ck.LAUNCHES["fused_rhs_bwd"] == before["fused_rhs_bwd"] + 1
    ref = ck.fused_rhs_plain(*args)
    _assert_close(out, ref, "forward")
    for name, a, b in zip(NAMES, first, _grads(ref, args, g)):
        _assert_close(a, b, name, fwd=False)
    again = ck.fused_rhs(*args)
    assert torch.equal(out, again)
    for name, a, b in zip(NAMES, first, _grads(again, args, g)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("din,d,m,s,match", [
    (4, 21, 40, 64, "D <= 20"), (12, 12, M, S, "shared memory")],
    ids=["d21_threads", "d12_smem"])
def test_fused_rhs_refuses_before_any_launch(cuda, din, d, m, s, match):
    """A shape the backward refuses raises at the call when a gradient will
    be taken, before the forward launches; without one the forward runs."""
    args = _wide_inputs(cuda, 300, m, 32, din, d, s)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ck.fused_rhs(args[0].clone().requires_grad_(), *args[1:])
    assert ck.LAUNCHES == before
    _assert_close(ck.fused_rhs(*args), ck.fused_rhs_plain(*args), "forward")
    assert ck.LAUNCHES["fused_rhs_fwd"] == before["fused_rhs_fwd"] + 1


@pytest.mark.parametrize("dim", [12, 17])
@pytest.mark.parametrize("preset", ["official", "fast"])
def test_wide_shooting_step_takes_the_plain_path(cuda, preset, dim):
    """A shooting step at D = 12 (the segment backwards' shared memory) and
    D = 17 (every kernel's width) over 4 x 32 x 5 = 640 segment rows:
    kernels=False launches nothing; the auto rule takes the plain segment
    path (no segment or rhs launch, no ValueError), so the step-0 loss
    equals kernels=False and a train step runs, and only the draw's
    `draw_solve` kernels launch (the draw factors K(Z, Z) itself at every
    width); forcing the kernels raises ValueError before any segment
    launch."""
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.train.bench_setup import preset_model_args
    from gpode_tpu_torch.train.builders import build_shooting, shooting_loss_fn
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args = preset_model_args(preset)
    ys = np.random.default_rng(40).normal(size=(4, 33, dim)).astype(np.float32)
    params = build_shooting(torch.Generator().manual_seed(0), args, ys,
                            device=cuda)
    ys_t = torch.as_tensor(ys, device=cuda)
    ts = 0.01 * torch.arange(33, dtype=torch.float32, device=cuda)
    noise = sample_step_noise(params, args.num_features, args.num_samples,
                              torch.Generator(cuda).manual_seed(41))

    def launched(since):
        return {k: n - since[k] for k, n in ck.LAUNCHES.items()
                if n != since[k]}

    before = dict(ck.LAUNCHES)
    with torch.no_grad():
        plain = float(shooting_loss_fn(args, kernels=False)(params, noise, ys_t, ts)[0])
    assert ck.LAUNCHES == before
    with torch.no_grad():
        loss = float(shooting_loss_fn(args)(params, noise, ys_t, ts)[0])
    assert np.isfinite(loss) and abs(loss - plain) <= 1e-4 * abs(plain)
    step = make_train_step(shooting_loss_fn(args), params,
                           default_optimizer(params, 5e-3))
    assert np.isfinite(float(step(noise, ys_t, ts).loss))
    assert launched(before) == {"draw_solve_fwd": 2, "draw_solve_bwd": 1}
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError):
        shooting_loss_fn(args, kernels=True)(params, noise, ys_t, ts)
    assert set(launched(before)) <= {"draw_solve_fwd"}


def _segment_forward(kind, args, dt, substeps):
    """One launch of a segment forward kernel and its plain version on the
    same operands: ((state, stage inputs[, scaled error]), the same plain)."""
    x0, params = args[0].detach(), [a.detach() for a in args[1:]]
    n, dim = x0.shape
    m, s = params[0].shape[0], params[5].shape[0]
    ops = ck._kernel_operands(*params)
    with torch.no_grad():
        if kind == "dopri5":
            x5, err, xs = ck._launch_dp_fwd(x0, dt, 1e-6, 1e-6, ops, dim, dim, m, s)
            rx5, rerr, rxs = ck.dopri5_attempt_plain(x0, dt, *params, 1e-6, 1e-6)
            return (x5, xs, err), (rx5, rxs, rerr)
        x1, xs = ck._launch_rk4_fwd(x0, dt, substeps, ops, dim, dim, m, s)
        return (x1, xs), ck.rk4_segment_plain(x0, dt, *params, substeps)


@pytest.mark.parametrize("kind,substeps", [("dopri5", 1), ("rk4", 1), ("rk4", 3)],
                         ids=["dopri5", "rk4", "rk4_x3"])
@pytest.mark.parametrize("n,dim,m,s", SEGMENT_SHAPES, ids=SEGMENT_IDS)
def test_segment_forward_over_shapes(cuda, n, dim, m, s, kind, substeps):
    """Both segment forwards against their plain versions: the state, the
    stage inputs the backward reads back, and dopri5's scaled error (at
    dt=0.01 float32 rounding of the stage sums in both versions); N=77, 203
    and 50 end in a ragged tile. Two launches are bit-identical."""
    args = _segment_inputs(cuda, n, dim, m, s, seed=24)
    dt = torch.full((1,), 0.01, device=cuda)
    key = {"dopri5": "fused_dopri5_attempt_fwd", "rk4": "fused_rk4_segment_fwd"}[kind]
    before = ck.LAUNCHES[key]
    got, want = _segment_forward(kind, args, dt, substeps)
    _assert_close(got[0], want[0], "state")
    _assert_close(got[1], want[1], "stage inputs")
    if kind == "dopri5":
        torch.testing.assert_close(got[2], want[2], rtol=0.0, atol=0.1)
    again, _ = _segment_forward(kind, args, dt, substeps)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # every (row, dim) sum in one fixed order
    assert ck.LAUNCHES[key] == before + 2


@pytest.mark.parametrize("preset", ["fast", "official"])
def test_time_to_nll_init_on_the_card_matches_the_cpu(cuda, preset):
    """The time-to-LL driver's init at a preset on the card against the same
    on the CPU. The kernel and inducing init (`build_model`): atol 1e-4 *
    max|ref|, since the whitening solve with chol(K(Z,Z) + 1e-6 I) at the
    k-means centers amplifies float32 rounding (as in
    tests/test_torch_eval.py). Then from the same parameters and the same
    noise the states and noise init (`init_states_and_noise`: the x0 mean by
    backward integration over 50 draws under the eval solver, the states at
    the data, the noise variance from a 16-draw predict): every parameter
    rtol 1e-4, atol 1e-5 * max|ref|."""
    import copy

    from gpode_tpu_torch.models.gpode import PredictNoise, sample_predict_noise
    from gpode_tpu_torch.scripts import bench_time_to_nll as ttn
    from gpode_tpu_torch.train.bench_setup import preset_model_args

    margs = preset_model_args(preset)
    data_pca, data_full = ttn.load_bench_data()
    cpu = ttn.build_model(margs, data_pca, data_full, 121, "cpu")
    want = dict(cpu.named_parameters())
    for name, got in ttn.build_model(margs, data_pca, data_full, 121,
                                     cuda).named_parameters():
        torch.testing.assert_close(
            got.detach().cpu(), want[name].detach(), rtol=1e-4,
            atol=1e-4 * float(want[name].detach().abs().max()), msg=name)

    params = {"cpu": cpu, cuda: copy.deepcopy(cpu).to(cuda)}
    gen = torch.Generator().manual_seed(0)
    f = margs.num_features
    noise = (sample_predict_noise(ttn.view(cpu), f, ttn.X0_DRAWS, gen,
                                  sample_x0=False),
             sample_predict_noise(ttn.view(cpu), f, ttn.NOISEVAR_DRAWS, gen))

    def on(dev, n):
        return PredictNoise(*(None if t is None else t.to(dev) for t in (
            n.rff_weights, n.rff_freq, n.rff_phase, n.inducing, n.x0)))

    for dev, p in params.items():
        ttn.init_states_and_noise(p, margs, data_pca, data_full,
                                  *(on(dev, n) for n in noise))
    want = dict(params["cpu"].named_parameters())
    for name, got in params[cuda].named_parameters():
        _assert_close(got.cpu(), want[name], name)


# The FHN shooting twin's default step: 10 draws x 1 sequence x 30 states =
# 300 segment rows (and 290, a ragged last row tile), Din = D = 2, M = 16,
# S = 256, over its 6 / 29 interval.
@pytest.mark.parametrize("n", [290, 300])
def test_attempt_kernels_at_the_fhn_shooting_default(cuda, n):
    args = _segment_inputs(cuda, n, 2, 16, 256, seed=30)
    dt = torch.full((1,), 6.0 / 29.0, device=cuda)
    before = dict(ck.LAUNCHES)
    x5, err = ck.fused_dopri5_attempt(args[0], dt, *args[1:], 1e-6, 1e-6)
    rx5, rerr, _ = ck.dopri5_attempt_plain(args[0], dt, *args[1:], 1e-6, 1e-6)
    _assert_close(x5, rx5, "x5")
    torch.testing.assert_close(err, rerr.detach(), rtol=1e-3,
                               atol=1e-3 * float(rerr.abs().max()))
    _check_segment_backward(cuda, x5, rx5, args, "dopri5 attempt (FHN)")
    assert ck.LAUNCHES["fused_dopri5_attempt_fwd"] == before["fused_dopri5_attempt_fwd"] + 1
    assert ck.LAUNCHES["fused_dopri5_attempt_bwd"] == before["fused_dopri5_attempt_bwd"] + 2


def test_plots_grid_conditional_takes_rbf_gram_once(cuda):
    """The plots' grid conditional of a VDP GP on the card (rbf_gram at the
    30x30 grid's N=900, Din=D=2, M=16): one launch, mean and variance equal
    to the same call on the CPU (rtol 1e-4, atol 1e-4 * max|ref|)."""
    import copy

    from gpode_tpu_torch.data.vanderpol import VanderPol
    from gpode_tpu_torch.plots import plots_2d
    from gpode_tpu_torch.train.builders import ModelArgs, build_gpode

    data = VanderPol(s_train=25, t_train=7.0, noise_var=0.05)
    params = build_gpode(torch.Generator().manual_seed(0),
                         ModelArgs(num_inducing=16), data.trn.ys, device="cpu")
    gp_card = copy.deepcopy(params.gp).to(cuda)
    before = ck.LAUNCHES["rbf_gram"]
    _, _, mean, var = plots_2d.grid_conditional(gp_card, data)
    assert ck.LAUNCHES["rbf_gram"] == before + 1
    _, _, mean_c, var_c = plots_2d.grid_conditional(params.gp, data)
    assert mean.shape == var.shape == (900, 2)
    for got, want in ((mean, mean_c), (var, var_c)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["constant", "cosine", "clip"])
def test_device_count_adam_is_bit_equal_to_host_float_adam_on_the_card(
        cuda, case):
    """The device-count Adam (lr and bias-correction tables indexed by the
    count on the card) against the host-float Adam it replaced, 50 updates:
    bit-equal, so the tables keep PyTorch's division of a CUDA tensor by a
    host scalar (a multiply by its float32 reciprocal)."""
    from gpode_tpu_torch.train import trainer as tt

    from _torch_host_adam import HostFloatAdam, run_adam_pair

    kw = {"constant": dict(lr=5e-3),
          "cosine": dict(lr=tt.cosine_decay(5e-3, 50, alpha=0.01)),
          "clip": dict(lr=5e-3, grad_clip=1.0)}[case]
    (new_p, new), (host_p, host) = run_adam_pair(
        lambda p: tt.Adam(p, **kw), lambda p: HostFloatAdam(p, **kw), 50,
        reload_at=20, device=cuda)
    assert new.count == host.count == 50
    for a, b in zip(list(new_p.parameters()) + new.mu + new.nu,
                    list(host_p.parameters()) + host.mu + host.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("preset", ["official", "fast"])
def test_captured_step_equals_the_eager_step(cuda, preset):
    """10 steps of the bench problem through the captured step against 10
    eager ones from the same start and noise: losses rtol 1e-6, every
    parameter within 1e-5 of its largest magnitude; two graphs (official:
    split at the accept read) or one (`fast`), each segment kernel once per
    step and direction in both runs."""
    import copy

    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.graph_step import (capture_refusal,
                                                  make_captured_train_step)
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(preset_model_args(preset),
                                               device=cuda)
    assert capture_refusal(args, cuda, params) is None
    kernels = (("fused_rk4_segment_fwd", "fused_rk4_segment_bwd")
               if preset == "fast" else
               ("fused_dopri5_attempt_fwd", "fused_dopri5_attempt_bwd"))
    runs = []
    for make in (make_train_step, make_captured_train_step):
        p = copy.deepcopy(params)
        step = make(shooting_loss_fn(args), p, default_optimizer(p, 5e-3))
        gen = torch.Generator(cuda).manual_seed(5)
        before = dict(ck.LAUNCHES)
        losses = torch.stack([step(sample_step_noise(
            p, args.num_features, args.num_samples, gen), ys, ts).loss.detach()
            for _ in range(10)])
        torch.cuda.synchronize()
        assert all(ck.LAUNCHES[k] - before[k] == 10 for k in kernels)
        runs.append((losses, p, step))
    (le, pe, _), (lc, pc, step) = runs
    assert len(step.graphs) == (1 if preset == "fast" else 2)
    assert step.replays == 10 - capture.WARMUP and step.rejects == 0
    torch.testing.assert_close(lc, le, rtol=1e-6, atol=0.0)
    for a, b in zip(pc.parameters(), pe.parameters()):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0.0,
                                   atol=1e-5 * float(b.detach().abs().max()))


def test_captured_step_clocks_its_untraced_launches(cuda):
    """The official captured step on the card: with no profiler each call
    and each graph launch is counted and timed in `profiling.UNTRACED`
    (two launches a replayed step); under a profiler the same calls add
    nothing there and are spans instead, two replays and one accept read a
    step."""
    from torch.profiler import ProfilerActivity, profile

    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.graph_step import make_captured_train_step
    from gpode_tpu_torch.train.trainer import default_optimizer
    from gpode_tpu_torch.utils import profiling

    args, params, ys, ts = build_bench_problem(
        preset_model_args("official"), device=cuda)
    step = make_captured_train_step(shooting_loss_fn(args), params,
                                    default_optimizer(params, 5e-3))
    gen = torch.Generator(cuda).manual_seed(5)

    def run(n):
        for _ in range(n):
            terms = step(sample_step_noise(params, args.num_features,
                                           args.num_samples, gen), ys, ts)
        float(terms.loss.detach())

    def clock(name):
        return tuple(profiling.UNTRACED[name])

    before = {n: clock(n) for n in ("gpode.step", "gpode.step.replay")}
    run(6)
    assert step.rejects == 0 and step.replays == 6 - capture.WARMUP
    calls, seconds = (a - b for a, b in zip(clock("gpode.step"),
                                            before["gpode.step"]))
    launches, launch_s = (a - b for a, b in zip(clock("gpode.step.replay"),
                                                before["gpode.step.replay"]))
    assert calls == 6 and launches == 2 * step.replays
    assert 0.0 < launch_s < seconds
    untraced = {n: clock(n) for n in before}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(2)
        torch.cuda.synchronize()
    assert {n: clock(n) for n in before} == untraced
    names = [e.name for e in prof.events()
             if "CPU" in str(e.device_type) and e.name.startswith("gpode.")]
    assert names.count("gpode.step") == 2
    assert names.count("gpode.step.replay") == 4
    assert names.count("gpode.step.accept_read") == 2


# the batched prediction solve's captured attempt (`models/flow.py`):
# (draws, rows per draw, first step); the cell's shape is the validation
# request's, 32 draws x 2 sequences with Hairer's start
PREDICT_CASES = {"cell": (32, 2, None), "kernel_gate": (4, 256, None),
                 "rejects": (8, 2, -1.0)}


def _predict_problem(cuda, draws_n, rows, seed=7):
    """The bench problem's GP (M=100, 256 features, D=5), `draws_n` draws of
    a seeded noise, `rows` start states from the state means, and a grid of
    120 of the data's steps."""
    from gpode_tpu_torch.models import gp, gpode
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)

    _, params, _, ts = build_bench_problem(preset_model_args("official"),
                                           device=cuda)
    gp_params = params.gp
    means = params.states.mean.detach()
    x0 = means.reshape(-1, means.shape[-1])[:rows].expand(draws_n, -1, -1)
    grid = float(ts[1] - ts[0]) * torch.arange(120, device=cuda,
                                               dtype=torch.float32)

    def draws(s):
        noise = gpode.sample_draw_noise(gp_params, 256, draws_n,
                                        torch.Generator(cuda).manual_seed(s))
        return gp.draw_posterior(gp_params, noise.rff_weights, noise.rff_freq,
                                 noise.rff_phase, noise.inducing)

    return gp_params, draws, x0, grid


def _predict_solver(monkeypatch, gp_params, x0, grid, first_step=None):
    """`solve(draws, mode) -> (xs, stats, launches)`: the batched solve with
    the eager plain attempt ("plain"; "float64": the same on float64 copies
    of the GP, the draws and the states), with the program's attempt
    launched eagerly at every attempt ("eager": `CapturedAttempt.rehearse`,
    a cache of its own), or through the route the program takes
    ("captured")."""
    from gpode_tpu_torch.models import flow

    attempts = {"eager": type(flow._ATTEMPTS)(),
                "captured": type(flow._ATTEMPTS)()}
    route, capture_ = flow._capture_route, flow.CapturedAttempt.capture
    cfg = flow.SolverConfig(solver="dopri5", max_steps=512,
                            first_step=first_step)

    def solve(draws, mode):
        eager = mode in ("plain", "float64")
        monkeypatch.setattr(flow, "_capture_route",
                            (lambda *a: None) if eager else route)
        monkeypatch.setattr(flow.CapturedAttempt, "capture",
                            flow.CapturedAttempt.rehearse if mode == "eager"
                            else capture_)
        if not eager:
            monkeypatch.setattr(flow, "_ATTEMPTS", attempts[mode])
        params, start, config = gp_params, x0, cfg
        if mode == "float64":  # the plain field: the kernels take float32
            params, start = copy.deepcopy(gp_params).double(), x0.double()
            draws = type(draws)(*(leaf.double() for leaf in draws))
            config = dataclasses.replace(cfg, kernels=False)
        before = dict(ck.LAUNCHES)
        with torch.no_grad():
            xs, stats = flow.flow_forward_batched(params, draws, start, grid,
                                                  config)
        torch.cuda.synchronize()
        return xs, stats, {k: ck.LAUNCHES[k] - before[k] for k in before}

    return solve


@pytest.mark.parametrize("case", list(PREDICT_CASES))
def test_captured_prediction_attempt_equals_the_eager_one(cuda, monkeypatch,
                                                          case):
    """The batched solve with its attempt captured equals the same attempt
    launched eagerly bit for bit, states and all four `ODEStats` fields: at
    the validation request's shape, at 256 rows a draw (several tiles a
    draw; f0 and Hairer's probe take `fused_rhs` per draw) and from the whole
    span, whose first attempt is rejected. The attempt is the fused
    `dopri5_attempt_draws` kernel, once per attempt; the first captured
    solve captures, the second replays the cached graph. Against the plain
    attempt the kernel sums the field in another order, which moves the
    adaptive step sizes a little and can flip an accept decision near 1: the
    attempts within 5% (or 2) of the plain solve's, and the states no
    farther from the float64 plain solve than twice the float32 plain
    solve's distance (+ 1e-6 * max|ref|)."""
    from gpode_tpu_torch.models import flow

    draws_n, rows, first_step = PREDICT_CASES[case]
    gp_params, draws, x0, grid = _predict_problem(cuda, draws_n, rows)
    solve = _predict_solver(monkeypatch, gp_params, x0, grid, first_step)
    d = draws(11)
    for _ in range(2):  # the second run replays without a first attempt
        want, wst, wl = solve(d, "eager")
    for _ in range(2):
        got, st, launches = solve(d, "captured")
        assert torch.equal(got, want) and st == wst
    assert launches == wl
    (attempt,) = flow._ATTEMPTS.values()
    assert attempt is not None and attempt.graph is not None and attempt.fused
    assert wl["dopri5_attempt_draws"] == wst.num_attempted
    assert wl["fused_rhs_fwd"] == (2 * draws_n if rows >= 256 else 0)
    plain, pst, _ = solve(d, "plain")
    ref, _, _ = solve(d, "float64")
    e_kernel = float((got.double() - ref).abs().max())
    e_plain = float((plain.double() - ref).abs().max())
    print(f"{case}: kernel {wst}, plain {pst}; max abs error against the "
          f"float64 solve: kernel {e_kernel:.3e}, plain {e_plain:.3e} "
          f"(max|ref| {float(ref.abs().max()):.3e})")
    assert abs(wst.num_attempted - pst.num_attempted) <= max(
        2, 0.05 * pst.num_attempted)
    assert wst.num_covered == pst.num_covered == grid.shape[0]
    assert e_kernel <= 2.0 * e_plain + 1e-6 * float(ref.abs().max())
    if case == "rejects":
        assert wst.num_attempted > wst.num_accepted


def test_captured_prediction_attempt_reads_fresh_draws_and_parameters(
        cuda, monkeypatch):
    """Two requests' draws, then an in-place change of the GP's parameters
    (as Adam makes between validations), each solve through the one cached
    graph against the attempt launched eagerly, bit for bit; one replay an
    attempt; no output shares memory with a static buffer or changes after
    a later solve."""
    from gpode_tpu_torch.models import flow
    from gpode_tpu_torch.utils import profiling

    gp_params, draws, x0, grid = _predict_problem(cuda, 32, 2)
    solve = _predict_solver(monkeypatch, gp_params, x0, grid)
    outs = []
    for seed, update in ((21, False), (22, False), (21, True)):
        if update:
            with torch.no_grad():
                gp_params.z.add_(0.05)
                gp_params.kernel.raw_lengthscales.mul_(0.9)
        d = draws(seed)
        want, wst, _ = solve(d, "eager")
        replays = profiling.UNTRACED["gpode.solve.replay"][0]
        got, st, _ = solve(d, "captured")
        assert torch.equal(got, want) and st == wst
        assert (profiling.UNTRACED["gpode.solve.replay"][0] - replays
                == st.num_attempted)
        outs.append((got, got.clone()))
    (attempt,) = flow._ATTEMPTS.values()
    statics = [attempt.x, attempt.k1, attempt.scalars, attempt.taus,
               attempt.dense, *attempt.out, *attempt.draws, *attempt.hyper]
    for got, copy in outs:
        assert torch.equal(got, copy)
        assert all(got.untyped_storage().data_ptr()
                   != t.untyped_storage().data_ptr() for t in statics)
    assert not torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[2][0])


# the draws kernel's shapes on the card: (draws, rows, Din = D, M, S)
DRAWS_SHAPES = {"validation": (32, 2, 5, 100, 256),
                "test_eval": (128, 2, 5, 100, 256),
                "tiles": (3, 77, 5, 100, 256), "small": (4, 3, 2, 16, 32)}


def _draws_inputs(dev, draws_n, rows, dim, m, s, seed):
    """A dimwise GP of the given widths with seeded hyperparameters, its
    draws, start states and their FSAL k1, all on `dev`."""
    from gpode_tpu_torch.models import gp

    gen = torch.Generator(dev).manual_seed(seed)
    params = gp.init_svgp(torch.Generator().manual_seed(seed), dim, dim, m,
                          device=dev)
    with torch.no_grad():
        params.kernel.raw_lengthscales.add_(
            0.3 * torch.randn(dim, dim, device=dev, generator=gen))
        params.u_mean.normal_(generator=gen)
        draws = gp.draw_posterior(
            params, torch.randn(draws_n, s, dim, device=dev, generator=gen),
            torch.randn(draws_n, dim, s, dim, device=dev, generator=gen),
            torch.rand(draws_n, 1, s, dim, device=dev, generator=gen),
            torch.randn(draws_n, m, dim, device=dev, generator=gen))
        x = torch.randn(draws_n, rows, dim, device=dev, generator=gen)
    k = params.kernel
    operands = (params.z.detach(), k.lengthscales.detach(),
                k.variance.detach(), draws.omega, draws.phase,
                gp.kernel_rff_weights(draws.weights), draws.nu)
    return params, draws, x, operands


@pytest.mark.parametrize("direction", [1.0, -1.0], ids=["forward", "backward"])
@pytest.mark.parametrize("shape", list(DRAWS_SHAPES))
def test_dopri5_attempt_draws_matches_plain(cuda, shape, direction):
    """The kernel against `dopri5_attempt_draws_plain` on the card. At a
    short step, x_new and k7 at the forward tolerance (rtol 1e-4, atol 1e-5
    * max|ref|: the field is summed in another order, the stage
    combinations round alike), and the accept decision where the plain
    ratio is not within 5% of 1 (there the embedded error is float32
    rounding of the stage sums in both versions). Over the shortest step
    0.02 * 1.25^k whose plain error ratio stands far above that rounding
    (> 1e3; near 10 the two still part by up to ~0.5% at D=2), the ratio
    at rtol 1e-3; x_new and k7 are not held there, since a long
    step amplifies the field's rounding. Two launches are bit-identical;
    each launch is counted."""
    draws_n, rows, dim, m, s = DRAWS_SHAPES[shape]
    _, _, x, operands = _draws_inputs(cuda, draws_n, rows, dim, m, s, 31)
    with torch.no_grad():
        k1 = (direction * ck.draws_field_plain(x, *operands)).contiguous()

        def plain_ratio(span):
            return float(ck.dopri5_attempt_draws_plain(
                x, k1, torch.tensor(span, device=cuda), direction,
                *operands)[1])

        long_span = next(0.02 * 1.25 ** k for k in range(60)
                         if plain_ratio(0.02 * 1.25 ** k) > 1e3)
        for span, long in ((0.02, False), (long_span, True)):
            dt = torch.tensor(span, device=cuda)
            before = ck.LAUNCHES["dopri5_attempt_draws"]
            got = ck.dopri5_attempt_draws(x, k1, dt, direction, *operands)
            again = ck.dopri5_attempt_draws(x, k1, dt, direction, *operands)
            assert ck.LAUNCHES["dopri5_attempt_draws"] == before + 2
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            want = ck.dopri5_attempt_draws_plain(x, k1, dt, direction,
                                                 *operands)
            ratio, ref = float(got[1]), float(want[1])
            if not long:
                _assert_close(got[0], want[0], f"x_new at dt={span}")
                _assert_close(got[2], want[2], f"k7 at dt={span}")
                if abs(ref - 1.0) > 0.05:
                    assert (ratio <= 1.0) == (ref <= 1.0)
            else:
                assert ref > 1e3
                assert ratio == pytest.approx(ref, rel=1e-3)


def test_dopri5_attempt_draws_raises_instead_of_falling_back(cuda):
    _, _, x, operands = _draws_inputs(cuda, 2, 3, 5, 16, 32, 32)
    dt = torch.tensor(0.1, device=cuda)
    k1 = torch.zeros_like(x)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        ck.dopri5_attempt_draws(x.transpose(0, 1).contiguous().transpose(0, 1),
                                k1, dt, 1.0, *operands)
    with pytest.raises(ValueError):  # dt on the host
        ck.dopri5_attempt_draws(x, k1, dt.cpu(), 1.0, *operands)
    with pytest.raises(TypeError):   # float64 states
        ck.dopri5_attempt_draws(x.double(), k1.double(), dt, 1.0, *operands)
    with pytest.raises(ValueError, match="direction"):
        ck.dopri5_attempt_draws(x, k1, dt, 0.5, *operands)
    assert ck.LAUNCHES == before


def test_a_refused_shape_captures_the_plain_attempt(cuda, monkeypatch):
    """Din = D = 17, which the draws kernel refuses: the captured attempt is
    the plain one (no draws kernel launched) and equals the eager plain solve
    bit for bit."""
    from gpode_tpu_torch.models import flow

    params, draws, x, _ = _draws_inputs(cuda, 4, 2, 17, 16, 32, 33)
    solve = _predict_solver(monkeypatch, params, x, torch.linspace(
        0.0, 0.5, 6, device=cuda))
    want, wst, _ = solve(draws, "plain")
    got, st, launches = solve(draws, "captured")
    assert torch.equal(got, want) and st == wst
    (attempt,) = flow._ATTEMPTS.values()
    assert attempt is not None and not attempt.fused
    assert launches["dopri5_attempt_draws"] == 0


# the commit's shapes on the card: (draws, rows, D), 120 output times
COMMIT_SHAPES = {"validation": (32, 2, 5), "test_eval": (128, 2, 5)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["random", "h_zero", "at_end", "at_start",
                                  "no_point", "whole_span", "decreasing",
                                  "rejected", "nan", "ratio_one"])
@pytest.mark.parametrize("shape", list(COMMIT_SHAPES))
def test_draws_commit_matches_plain(cuda, shape, case, seed):
    """The commit kernel against `draws_commit_plain` on the card (the
    host's `_hermite` tensor ops and hand-over copies, as the solve makes
    them without the kernel), bit for bit, at 120 output times: random
    intervals and the edges of `tests/test_torch_commit.py`, a rejected or
    NaN ratio writing nothing; two launches bit-identical, each counted."""
    from test_torch_commit import _commit_inputs, _states

    dims = COMMIT_SHAPES[shape]
    taus, _, _, ratio, scalars, dense = _commit_inputs(case, seed, dims)
    taus = torch.from_numpy(taus).to(cuda)
    ratio, scalars, dense = ratio.to(cuda), scalars.to(cuda), dense.to(cuda)
    x, k1, x_new, k7 = (t.to(cuda) for t in _states(seed, dims))
    want = (dense.clone(), x.clone(), k1.clone())
    ck.draws_commit_plain(ratio, scalars, taus, *want, x_new, k7)
    runs = []
    for _ in range(2):
        got = (dense.clone(), x.clone(), k1.clone())
        before = ck.LAUNCHES["draws_commit"]
        ck.draws_commit(ratio, scalars, taus, *got, x_new, k7)
        assert ck.LAUNCHES["draws_commit"] == before + 1
        runs.append(got)
    torch.cuda.synchronize()
    for got in runs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_draws_commit_raises_instead_of_falling_back(cuda):
    x = torch.zeros(2, 3, 5, device=cuda)
    ratio, scalars = torch.zeros((), device=cuda), torch.zeros(3, device=cuda)
    taus, dense = torch.zeros(4, device=cuda), torch.zeros(4, 2, 3, 5,
                                                          device=cuda)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match="draws_commit"):   # out of 3 times
        ck.draws_commit(ratio, scalars, taus[:3], dense, x, x.clone(), x, x)
    with pytest.raises(ValueError, match="contiguous"):
        ck.draws_commit(ratio, scalars, taus, dense, x.transpose(1, 2),
                        x.clone(), x, x)
    with pytest.raises(TypeError):   # float64 states
        ck.draws_commit(ratio, scalars, taus, dense.double(), x.double(),
                        x.double(), x.double(), x.double())
    assert ck.LAUNCHES == before


def test_draws_commit_compiles_without_spills(cuda):
    from gpode_tpu_torch.ops import cuda_build

    found = {k: v for k, v in cuda_build.kernel_resources("dopri5_draws").items()
             if "draws_commit_kernel" in k}
    assert len(found) == 1
    (rec,) = found.values()
    assert rec["spill_stores"] == 0 and rec["spill_loads"] == 0


@pytest.mark.parametrize("case", ["cell", "rejects", "max_steps"])
def test_the_device_commit_equals_the_host_dense_output(cuda, monkeypatch,
                                                        case):
    """At the validation request's shape (32 draws x 2 rows, 120 output
    times) the captured solve that commits on the device returns the solve
    whose host launches the same `dopri5_attempt_draws` eagerly, forms the
    dense output with `_hermite` and takes the hand-over, bit for bit,
    states and `ODEStats`: with Hairer's start, from the whole span
    (rejects) and out of `max_steps` (the uncovered tail). One commit
    launch a replayed attempt; the counter reads the device's points on one
    side and the host's on the other. Under `kernels=False` the solve is
    eager: no draws kernel and no commit launched, one attempt cached (the
    committing one), and the eager plain solve's result bit for bit."""
    from gpode_tpu_torch.models import flow, gp
    from gpode_tpu_torch.ops import ode

    gp_params, draws, x0, grid = _predict_problem(cuda, 32, 2)
    monkeypatch.setattr(flow, "_ATTEMPTS", type(flow._ATTEMPTS)())
    first_step, max_steps = {"cell": (None, 512), "rejects": (-1.0, 512),
                             "max_steps": (None, 20)}[case]
    cfg = flow.SolverConfig(solver="dopri5", max_steps=max_steps,
                            first_step=first_step)
    d = draws(41)
    kern = gp_params.kernel
    operands = (gp_params.z, kern.lengthscales, kern.variance, d.omega,
                d.phase, gp.kernel_rff_weights(d.weights), d.nu)

    def field(t, x):
        del t  # time-invariant ODE
        return gp.eval_draws(gp_params, d, x, False)

    def host_attempt(tau, x, k1, dt, tau_end):
        del tau, tau_end
        return ck.dopri5_attempt_draws(
            x.contiguous(), k1.contiguous(),
            torch.tensor(dt, dtype=torch.float32, device=cuda), 1.0,
            *operands, cfg.rtol, cfg.atol)

    def run(mode):
        before, points = dict(ck.LAUNCHES), dict(ode.DENSE_POINTS)
        with torch.no_grad():
            if mode == "host":
                xs, st = ode.odeint_dopri5(
                    field, x0, grid, rtol=cfg.rtol, atol=cfg.atol,
                    max_steps=max_steps, first_step=first_step,
                    norm=ode.max_rms_over_axis0, attempt=host_attempt)
                xs = torch.movedim(xs, 0, 2)
            else:
                xs, st = flow.flow_forward_batched(
                    gp_params, d, x0, grid, dataclasses.replace(
                        cfg, kernels=False if mode == "off" else None))
        torch.cuda.synchronize()
        return xs, st, {k: ck.LAUNCHES[k] - before[k] for k in before}, {
            k: ode.DENSE_POINTS[k] - points[k] for k in points}

    for _ in range(2):  # capture, then replay
        got, st, launches, dev = run("captured")
    want, wst, _, host = run("host")
    assert torch.equal(got, want) and st == wst
    formed = wst.num_covered - 1
    assert launches["draws_commit"] == st.num_attempted
    assert dev == {"host": 0, "device": formed}
    assert host == {"host": formed, "device": 0}
    for _ in range(2):
        off, off_st, off_launches, off_points = run("off")
    monkeypatch.setattr(flow, "_capture_route", lambda *a: None)
    plain, plain_st, _, _ = run("eager")
    assert torch.equal(off, plain) and off_st == plain_st
    assert off_launches["dopri5_attempt_draws"] == 0
    assert off_launches["draws_commit"] == 0
    assert off_points == {"host": off_st.num_covered - 1, "device": 0}
    assert len(flow._ATTEMPTS) == 1
    if case == "rejects":
        assert st.num_attempted > st.num_accepted
    if case == "max_steps":
        assert st.num_covered < grid.shape[0]


# the posterior draw's own-factor solves (`cuda_kernels.draw_solve`):
# (factors, M, right-hand columns a factor): the train step's D=5 factors of
# M=100 at one draw, at 32 and at the most columns M=100 takes (126), the
# largest M of the square layout; past it the packed layout: its smallest
# M, one between, the `scale` step's M=256 at one draw and at the most
# columns M=256 takes (32)
DRAW_SOLVE_SHAPES = {"main_R1": (DIM, M, 1), "main_R32": (DIM, M, 32),
                     "main_R126": (2, M, 126), "m128_R1": (DIM, 128, 1),
                     "m128_R32": (2, 128, 32), "m129_R1": (DIM, 129, 1),
                     "m200_R5": (DIM, 200, 5), "m256_R1": (DIM, 256, 1),
                     "m256_R32": (2, 256, 32)}


def _draw_solve_operands(cuda, b, m, r, seed=0):
    """K(Z, Z) of an initialised dimwise GP with b output dims and Z in
    5-D, u, v and a cotangent (b, r, m)."""
    from gpode_tpu_torch.models import gp
    from gpode_tpu_torch.ops.kernels import rbf_K

    gen = torch.Generator().manual_seed(seed)
    params = gp.init_svgp(gen, DIM, b, m).to(cuda)
    k3 = rbf_K(params.kernel, params.z).detach()
    u, v, g = (torch.randn(b, r, m, generator=gen).to(cuda) for _ in range(3))
    return k3, u, v, g


def _draw_solve_chain(k3, u, v):
    """`draw_solve_plain` (the library chain) on the kernels' layout: factor
    b's columns (B, R, M) are dim b of R draws."""
    from gpode_tpu_torch.models import gp

    return gp.draw_solve_plain(k3, u.permute(1, 2, 0),
                               v.permute(1, 2, 0)).transpose(0, 1)


@pytest.mark.parametrize("shape", list(DRAW_SOLVE_SHAPES))
def test_draw_solve_kernels_match_plain(cuda, shape):
    """The forward and the backward (one launch each: `draw_solve_fwd` and
    `draw_solve_bwd` up to M=128, `draw_solve_fwd_packed` and the three
    launches of `draw_solve_bwd_slabs` past it) against the plain versions:
    nu and its cotangents in K, u and v within 2e-3 of the float64 library
    chain's largest entry, as the float32 chain is (up to 7.6e-4 at M=128;
    past M=128 the float32 chain itself reads up to 3e-3 on some operands,
    so only the kernels are held to 2e-3 there: 9.7e-4 against the chain's
    6.1e-4 at M=256, R=1); the kernels' backward against
    `draw_solve_bwd_plain` on the kernels' own factor (by slabs on the
    packed layout); a rerun bit-identical; the shape recorded in
    `DRAW_SOLVE_SHAPES`."""
    b, m, r = DRAW_SOLVE_SHAPES[shape]
    packed = m > ck.DRAW_SOLVE_SQUARE_MAX_M
    fwd_key, bwd_key = (("draw_solve_fwd_packed", "draw_solve_bwd_slabs")
                        if packed else ("draw_solve_fwd", "draw_solve_bwd"))
    k3, u, v, g = _draw_solve_operands(cuda, b, m, r)

    def run(fn, dtype):
        args = [t.to(dtype).requires_grad_() for t in (k3, u, v)]
        nu = fn(*args)
        return (nu.detach(),) + torch.autograd.grad(nu, args, g.to(dtype))

    def kernels(k, uu, vv):
        return ck._DrawSolveFn.apply(k, uu, vv, 1e-5)

    before = dict(ck.LAUNCHES)
    ck.DRAW_SOLVE_SHAPES.clear()
    got = run(kernels, torch.float32)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[fwd_key] - before[fwd_key] == 1
    assert ck.LAUNCHES[bwd_key] - before[bwd_key] == 1
    assert ck.DRAW_SOLVE_SHAPES == {(b, m, r)}
    assert all(torch.equal(a, b) for a, b in zip(got, run(kernels,
                                                          torch.float32)))
    plain = run(_draw_solve_chain, torch.float32)
    exact = run(_draw_solve_chain, torch.float64)
    for name, kern, chain, ref in zip(("nu", "g_K", "g_u", "g_v"), got, plain,
                                      exact):
        scale = float(ref.abs().max())
        err = float((kern.double() - ref).abs().max()) / scale
        chain_err = float((chain.double() - ref).abs().max()) / scale
        if packed:
            assert err <= 2e-3, (name, err, chain_err)
        else:
            assert err <= 2e-3 and chain_err <= 2e-3, (name, err, chain_err)
    L, a, _ = ck._draw_solve_fwd(k3, u, v, 1e-5)
    want = ck.draw_solve_bwd_plain(
        L, a, v, g, slab=ck._DRAW_SOLVE_SLAB_COLS if packed else None)
    for name, kern, ref in zip(("g_K", "g_u", "g_v"), got[1:], want):
        _assert_close(kern, ref, f"draw_solve_bwd {name}", fwd=False)


def test_draw_solve_compiles_without_spills(cuda):
    """Every kernel free of spills and of local memory: the square layout's
    two at M=100 (R=1) and M=128 (R=32), the packed layout's four at M=256
    (R=1 and R=32)."""
    from gpode_tpu_torch.ops import cuda_build

    found = cuda_build.kernel_resources("draw_solve")
    assert len(found) == len(ck.DRAW_SOLVE_KERNELS)
    for rec in found.values():
        assert rec["spill_stores"] == 0 and rec["spill_loads"] == 0
    cases = [(d, m, r) for d in ("fwd", "bwd") for m, r in ((M, 1), (128, 32))]
    cases += [(d, 256, r) for d in ("fwd", "bwd_cols", "bwd_rows", "bwd_sym")
              for r in (1, 32)]
    for direction, m, r in cases:
        report = ck.draw_solve_occupancy(direction, m, r)
        assert report["local_bytes"] == 0 and report["blocks_per_sm"] >= 1


def test_draw_solve_raises_instead_of_falling_back(cuda):
    """On the card the wrapper launches or raises: M=257, float64 and a
    wrong K shape raise before any launch."""
    before = dict(ck.LAUNCHES)
    u = torch.zeros(3, 257, DIM, device=cuda)
    with pytest.raises(ValueError, match="M <= 256"):
        ck.draw_solve(torch.eye(257, device=cuda).expand(DIM, -1, -1), u, u)
    u = torch.zeros(M, DIM, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ck.draw_solve(torch.eye(M, device=cuda, dtype=torch.float64), u, u)
    u = torch.zeros(M, DIM, device=cuda)
    with pytest.raises(ValueError, match="kzz must be"):
        ck.draw_solve(torch.eye(M + 1, device=cuda), u, u)
    assert ck.LAUNCHES == before


def test_captured_step_draws_through_the_kernels_bit_equal_to_eager(cuda):
    """The official captured step against the eager step, 10 steps from one
    start and noise: one `draw_solve_fwd` and one `draw_solve_bwd` a step
    in both runs, every draw counted "device", and losses and parameters
    bit for bit."""
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.graph_step import make_captured_train_step
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(preset_model_args("official"),
                                               device=cuda)
    runs = []
    for make in (make_train_step, make_captured_train_step):
        p = copy.deepcopy(params)
        step = make(shooting_loss_fn(args), p, default_optimizer(p, 5e-3))
        gen = torch.Generator(cuda).manual_seed(5)
        launches, draws = dict(ck.LAUNCHES), dict(ck.DRAW_SOLVES)
        losses = torch.stack([step(sample_step_noise(
            p, args.num_features, args.num_samples, gen), ys, ts).loss.detach()
            for _ in range(10)])
        torch.cuda.synchronize()
        for k in ("draw_solve_fwd", "draw_solve_bwd"):
            assert ck.LAUNCHES[k] - launches[k] == 10, k
        assert ck.DRAW_SOLVES == {"device": draws["device"] + 10,
                                  "library": draws["library"]}
        runs.append((losses, p))
    (le, pe), (lc, pc) = runs
    assert torch.equal(lc, le)
    for a, b in zip(pc.parameters(), pe.parameters()):
        assert torch.equal(a.detach(), b.detach())


def test_prediction_and_refused_draws_keep_the_library_solves(cuda):
    """`gpode.predict` hands the draw its factor: no `draw_solve` launch, the
    draw counted "library"; a draw at M=257 (refused) and one at the main
    path's shape under kernels=False the same."""
    from gpode_tpu_torch.models import flow, gp, gpode
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)

    _, params, _, ts = build_bench_problem(preset_model_args("official"),
                                           device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    noise = gpode.sample_draw_noise(params.gp, 256, 4, gen)
    x0 = params.states.mean.detach().reshape(-1, DIM)[:2]
    launches, draws = dict(ck.LAUNCHES), dict(ck.DRAW_SOLVES)
    with torch.no_grad():
        gpode.predict(params, noise, ts[:5], flow.SolverConfig(solver="dopri5"),
                      x0=x0)
        big = gp.init_svgp(torch.Generator().manual_seed(0), DIM, DIM,
                           257).to(cuda)
        big_noise = gpode.sample_draw_noise(big, 16, 2, gen)
        gp.draw_posterior(big, big_noise.rff_weights, big_noise.rff_freq,
                          big_noise.rff_phase, big_noise.inducing)
        gp.draw_posterior(params.gp, noise.rff_weights[0], noise.rff_freq[0],
                          noise.rff_phase[0], noise.inducing[0], kernels=False)
    torch.cuda.synchronize()
    for k in ("draw_solve_fwd", "draw_solve_bwd", "draw_solve_fwd_packed",
              "draw_solve_bwd_slabs"):
        assert ck.LAUNCHES[k] == launches[k], k
    assert ck.DRAW_SOLVES == {"device": draws["device"],
                              "library": draws["library"] + 3}


def test_captured_scale_step_draws_through_the_packed_kernels(cuda):
    """The `scale` preset's step (M=256, 32 state draws, 19,200 segment
    rows, remat) captured against its eager step, 5 steps from one start
    and noise (2 eager, the capture, 2 replays): one `draw_solve_fwd_packed`
    and one `draw_solve_bwd_slabs` a step in both runs, every draw counted
    "device" at (5, 256, 1), and losses and parameters bit for bit."""
    from gpode_tpu_torch.models.shooting import sample_step_noise
    from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                                   preset_model_args)
    from gpode_tpu_torch.train.builders import shooting_loss_fn
    from gpode_tpu_torch.train.graph_step import make_captured_train_step
    from gpode_tpu_torch.train.trainer import default_optimizer, make_train_step

    args, params, ys, ts = build_bench_problem(preset_model_args("scale"),
                                               device=cuda)
    runs = []
    for make in (make_train_step, make_captured_train_step):
        p = copy.deepcopy(params)
        step = make(shooting_loss_fn(args), p, default_optimizer(p, 5e-3))
        gen = torch.Generator(cuda).manual_seed(7)
        launches, draws = dict(ck.LAUNCHES), dict(ck.DRAW_SOLVES)
        ck.DRAW_SOLVE_SHAPES.clear()
        losses = torch.stack([step(sample_step_noise(
            p, args.num_features, args.num_samples, gen), ys, ts).loss.detach()
            for _ in range(5)])
        torch.cuda.synchronize()
        for k in ("draw_solve_fwd_packed", "draw_solve_bwd_slabs"):
            assert ck.LAUNCHES[k] - launches[k] == 5, k
        for k in ("draw_solve_fwd", "draw_solve_bwd"):
            assert ck.LAUNCHES[k] == launches[k], k
        assert ck.DRAW_SOLVES == {"device": draws["device"] + 5,
                                  "library": draws["library"]}
        assert ck.DRAW_SOLVE_SHAPES == {(DIM, 256, 1)}
        runs.append((losses, p))
    (le, pe), (lc, pc) = runs
    assert torch.isfinite(le).all()
    assert torch.equal(lc, le)
    for a, b in zip(pc.parameters(), pe.parameters()):
        assert torch.equal(a.detach(), b.detach())
