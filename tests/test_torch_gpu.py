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


def _grads(out, inputs, g):
    return torch.autograd.grad(out, inputs, g)


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
