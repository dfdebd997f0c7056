"""The port's wide-layout rhs (`gpode_tpu_torch/ops/wide_rhs.py`) against
the JAX package's prototype `scripts/proto_wide_rhs.py`, on the CPU.

The prototype is loaded from its file; its Pallas kernels run in interpret
mode (seconds at N=77, Din=D=4, M=24, S=64). The port runs its plain
versions here (CPU tensors). Inputs are made with numpy from a seed.

Tolerances: packed operands rtol 1e-6; forward rtol 1e-4 with atol
1e-5 * max|ref|; cotangents atol 1e-4 * max|g| (the norm-expansion Gram
cancels large terms, and the frameworks sum in different orders).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpode_tpu.ops.pallas_kernels import _rhs_reference_jnp

from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import wide_rhs as wr
from gpode_tpu_torch.scripts import proto_wide_rhs as entry

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, M, S = 77, 4, 24, 64
NAMES = ("dx", "dz", "dls", "dvar", "domega", "dphase", "dw", "dnu")


@pytest.fixture(scope="module")
def proto():
    """scripts/proto_wide_rhs.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "_jax_proto_wide_rhs", os.path.join(ROOT, "scripts", "proto_wide_rhs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n=N, din=DIM, d=DIM, m=M, s=S, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(n, din)).astype(f32),
            rng.normal(size=(m, din)).astype(f32),
            (1.0 + rng.uniform(size=(d, din))).astype(f32),
            (0.5 + rng.uniform(size=(d,))).astype(f32),
            rng.normal(size=(din, s, d)).astype(f32),
            (6.28 * rng.uniform(size=(1, s, d))).astype(f32),
            rng.normal(size=(s, d)).astype(f32),
            rng.normal(size=(d, m)).astype(f32))


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _plain_at_pad(variant, args, pad):
    """The plain wide forward over operands packed at `pad`."""
    x, params = args[0], args[1:]
    d = params[6].shape[0]
    *packed, wblk, sp, mp = wr.wide_pack(*params, params[5].shape[0], pad=pad)
    if variant == "wide":
        return wr.wide_fwd_packed_plain(x, *packed, wblk, d, sp, mp)
    return wr.wide2_fwd_packed_plain(
        x, *packed, wr.wide_flat_weights(wblk, d, sp, mp), d, sp, mp)


def _close_fwd(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=msg)


def _close_cot(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0.0,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=msg)


def test_wide_pack_at_pad_128_matches_jax_operand_by_operand(proto):
    args = _inputs()
    want = proto.wide_pack(*_j(args[1:]), S)
    got = wr.wide_pack(*_t(args[1:]), S, pad=128)
    assert (got[5], got[6]) == (want[5], want[6]) == (128, 128)
    for name, a, b in zip(("b", "phase_w", "zn_w", "invls2_t", "wblk"), got,
                          want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)
    flat = wr.wide_flat_weights(got[4], DIM, 128, 128)
    wsc_w, nv_w = flat[:, :DIM * 128], flat[:, DIM * 128:]
    idx = np.arange(DIM)
    wblk = np.asarray(want[4])
    np.testing.assert_array_equal(
        wsc_w, wblk[:DIM * 128].reshape(DIM, 128, DIM)[idx, :, idx].reshape(1, -1))
    np.testing.assert_array_equal(
        nv_w, wblk[DIM * 128:].reshape(DIM, 128, DIM)[idx, :, idx].reshape(1, -1))


@pytest.mark.parametrize("pad", [128, 32, 1])
@pytest.mark.parametrize("variant", ["wide", "wide2"])
def test_wide_forward_plain_matches_jax_interpret_and_reference(proto, variant,
                                                                pad):
    args = _inputs()
    j_fn = {"wide": proto.fused_rhs_wide, "wide2": proto.fused_rhs_wide2}[variant]
    got = _plain_at_pad(variant, _t(args), pad)
    assert got.shape == (N, DIM)
    _close_fwd(got, j_fn(*_j(args), interpret=True), "interpret")
    _close_fwd(got, _rhs_reference_jnp(*_j(args)), "reference")
    _close_fwd(got, ck.fused_rhs_plain(*_t(args)), "port per-dim plain")


def test_public_wide_functions_take_the_plain_versions_on_cpu_tensors():
    args = _t(_inputs())
    before = dict(ck.LAUNCHES)
    torch.testing.assert_close(wr.fused_rhs_wide(*args),
                               wr.fused_rhs_wide_plain(*args))
    torch.testing.assert_close(wr.fused_rhs_wide2(*args),
                               wr.fused_rhs_wide2_plain(*args))
    g = torch.ones(N, DIM)
    for a, b in zip(wr.fused_rhs_wide_bwd(*args, g),
                    wr.fused_rhs_wide_bwd_plain(*args, g)):
        torch.testing.assert_close(a, b)
    assert ck.LAUNCHES == before               # no kernel on CPU tensors
    args[1].requires_grad_()
    for fn in (wr.fused_rhs_wide, wr.fused_rhs_wide2):
        with pytest.raises(RuntimeError, match="forward only"):
            fn(*args)
    with pytest.raises(RuntimeError, match="forward only"):
        wr.fused_rhs_wide_bwd(*args, g)
    with torch.no_grad():
        assert wr.fused_rhs_wide(*args).shape == (N, DIM)


@pytest.fixture(scope="module")
def cotangents(proto):
    """The eight cotangents from the port's plain wide backward, from the
    prototype's backward in interpret mode, and from autograd of the port's
    per-dim plain rhs."""
    args = _inputs(seed=1)
    g = np.random.default_rng(42).normal(size=(N, DIM)).astype(np.float32)
    got = wr.fused_rhs_wide_bwd_plain(*_t(args), torch.tensor(g))
    want_jax = proto.fused_rhs_wide_bwd(*_j(args), jnp.asarray(g),
                                        interpret=True)
    leaves = [a.requires_grad_() for a in _t(args)]
    want_auto = torch.autograd.grad(ck.fused_rhs_plain(*leaves), leaves,
                                    torch.tensor(g))
    return got, want_jax, want_auto, args


@pytest.mark.parametrize("i", range(8), ids=NAMES)
def test_wide_backward_plain_matches_jax_interpret_and_autograd(cotangents, i):
    got, want_jax, want_auto, args = cotangents
    assert tuple(got[i].shape) == args[i].shape
    _close_cot(got[i], want_jax[i], f"{NAMES[i]} vs interpret")
    _close_cot(got[i], want_auto[i], f"{NAMES[i]} vs autograd")


def test_wide_unpack_cotangents_matches_jax(proto):
    args = _inputs(seed=2)
    z, ls, var, _, _, weights, nu = args[1:]
    sp, mp = 128, 128
    w = DIM * (sp + mp)
    rng = np.random.default_rng(3)
    packed = [rng.normal(size=shape).astype(np.float32) for shape in
              ((DIM, w), (w, DIM), (1, DIM * sp), (1, DIM * mp), (DIM, DIM))]
    want = proto.wide_unpack_cotangents(*_j(packed), *_j((z, ls, var, weights, nu)),
                                        S, sp, mp)
    got = wr.wide_unpack_cotangents(*_t(packed), *_t((z, ls, var, weights, nu)),
                                    S, sp, mp)
    for name, a, b in zip(NAMES[1:], got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("pad", [32, 128])
def test_padded_columns_contribute_exactly_zero(pad):
    """M and S are not multiples of the pad (and N of no tile): the padded
    activation-times-weight terms and their cotangents are exactly 0."""
    args = _t(_inputs(n=77, m=24 + 3, s=64 + 5))
    x, params = args[0], args[1:]
    s, m = params[5].shape[0], params[0].shape[0]
    b, phase_w, zn_w, invls2_t, wblk, sp, mp = wr.wide_pack(*params, s, pad=pad)
    assert sp > s and mp > m and sp % pad == 0 and mp % pad == 0
    rff_pad = torch.zeros(DIM, sp, dtype=torch.bool)
    rff_pad[:, s:] = True
    gram_pad = torch.zeros(DIM, mp, dtype=torch.bool)
    gram_pad[:, m:] = True
    pad_cols = torch.cat([rff_pad.reshape(-1), gram_pad.reshape(-1)])
    to, e = wr._wide_act(x, b, phase_w, zn_w, invls2_t, DIM, sp, mp)
    act = torch.cat([torch.cos(to), e], dim=1)
    assert torch.all(e[:, gram_pad.reshape(-1)] == 0.0)       # exp(-5e29)
    assert torch.all(wblk[pad_cols] == 0.0)
    assert torch.all(act[:, pad_cols, None] * wblk[None, pad_cols] == 0.0)
    g = torch.randn(77, DIM, generator=torch.Generator().manual_seed(0))
    _, db, dwblk, dphase_w, dzn_w, _ = wr.wide_bwd_packed_plain(
        x, g, b, phase_w, zn_w, invls2_t, wblk, DIM, sp, mp)
    assert torch.all(db[:, pad_cols] == 0.0)
    assert torch.all(dphase_w[0, rff_pad.reshape(-1)] == 0.0)
    assert torch.all(dzn_w[0, gram_pad.reshape(-1)] == 0.0)
    # and the padded layout computes the unpadded function
    _close_fwd(_plain_at_pad("wide", args, pad), _plain_at_pad("wide", args, 1))
    _close_fwd(_plain_at_pad("wide2", args, pad), ck.fused_rhs_plain(*args))


def test_entry_point_runs_on_the_cpu_when_asked(capsys, monkeypatch):
    assert entry.main(["--device", "cpu", "--rows", "77", "--m", "24",
                       "--s", "64", "--d", "4"]) == 0
    out = capsys.readouterr().out
    assert "wide vs per-dim reference" in out and "wide2 vs" in out
    assert all(f"bwd {n}:" in out for n in NAMES) and "MISMATCH" not in out
    assert "us/eval" not in out                 # no timing off the card
    monkeypatch.setattr(entry, "MISMATCH", 0.0)  # every error now a mismatch
    assert entry.main(["--device", "cpu", "--rows", "77", "--m", "24",
                       "--s", "64", "--d", "4"]) == 1
    assert "<-- MISMATCH" in capsys.readouterr().out
