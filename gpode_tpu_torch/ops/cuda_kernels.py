"""Hand-written Hopper kernels for the hot GPODE ops, with their plain
PyTorch versions and autograd rules.

Counterpart of `gpode_tpu/ops/pallas_kernels.py` for the two kernels on the
official shooting train step:

  * :func:`fused_rhs` — the decoupled-sampling ODE right-hand side
    f(x) = cos(x Omega + phase) * sqrt(2 var / S) @ w + nu^T K(Z, x), forward
    and VJP (`csrc/fused_rhs.cu`);
  * :func:`fused_dopri5_attempt` — one whole-span Dormand-Prince step for a
    batch of rows, forward and the reverse sweep of its 5th-order chain
    (`csrc/fused_dopri5.cu`).

Each public function takes the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. `LAUNCHES` counts kernel launches
per wrapper (the launch of the kernel itself; the fixed-order reduction pass
that follows a backward kernel belongs to the same count).

Operands enter in the JAX package's layouts — lengthscales (D, Din) and
variance (D,) CONSTRAINED, omega (Din, S, D), phase (1, S, D), weights
(S, D), nu (D, M) — and the wrappers make the kernels' D-major layout
(1/lengthscale, omega (D, Din, S), phase/w (D, S)).
"""

from __future__ import annotations

import ctypes
import math

import torch

from gpode_tpu_torch.ops import cuda_build
from gpode_tpu_torch.ops.ode import _DP_A, _DP_B4, _DP_B5

LAUNCHES = {"fused_rhs_fwd": 0, "fused_rhs_bwd": 0,
            "fused_dopri5_attempt_fwd": 0, "fused_dopri5_attempt_bwd": 0}

# Kernel limits (csrc/rhs_tile.cuh): Din unrolled up to 16 in registers;
# 32 * D threads per backward block; 227 KB of shared memory per block.
MAX_DIN = 16
MAX_D = 32
MAX_SMEM_BYTES = 232448


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def fused_rhs_plain(x, z, lengthscales, variance, omega, phase, weights, nu):
    """The rhs as plain tensor ops; mirrors `_rhs_reference_jnp`."""
    s = weights.shape[0]
    xo = torch.einsum("nd,dfk->nfk", x, omega)
    phi = torch.cos(xo + phase) * torch.sqrt(2.0 * variance / s)
    f_prior = torch.einsum("nfk,fk->nk", phi, weights)
    xd = x[None, :, :] / lengthscales[:, None, :]
    zd = z[None, :, :] / lengthscales[:, None, :]
    sq = (torch.sum(xd * xd, -1)[:, :, None] + torch.sum(zd * zd, -1)[:, None, :]
          - 2.0 * torch.einsum("dnk,dmk->dnm", xd, zd))
    gram = variance[:, None, None] * torch.exp(-0.5 * sq)
    f_update = torch.einsum("dm,dnm->nd", nu, gram)
    return f_prior + f_update


def dopri5_attempt_plain(x0, dt, z, lengthscales, variance, omega, phase,
                         weights, nu, rtol=1e-6, atol=1e-6):
    """One whole-span Dormand-Prince step as plain tensor ops (the stage code
    of `_dp_stage_inputs` / `_fused_dp_attempt_kernel`).

    Returns (x5, err_scaled, xs): the 5th-order endpoint, the embedded error
    divided by atol + rtol * max(|x0|, |x5|) (detached: the controller is
    non-differentiable), and the six stage inputs (6, N, Din).
    """
    def f(xx):
        return fused_rhs_plain(xx, z, lengthscales, variance, omega, phase,
                               weights, nu)

    ks = [f(x0)]
    xs = [x0]
    for i in range(1, 6):
        xi = x0 + dt * sum(a * k for a, k in zip(_DP_A[i], ks))
        xs.append(xi)
        ks.append(f(xi))
    x5 = x0 + dt * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)
    ks.append(f(x5))
    err = dt * sum((b5 - b4) * k for b5, b4, k in zip(_DP_B5, _DP_B4, ks))
    scale = atol + rtol * torch.maximum(torch.abs(x0), torch.abs(x5))
    return x5, (err / scale).detach(), torch.stack(xs)


# ---------------------------------------------------------------------------
# Operand checks and layout
# ---------------------------------------------------------------------------

def _check(x, z, lengthscales, variance, omega, phase, weights, nu,
           x_name="x", x_rank=2):
    tensors = dict(z=z, lengthscales=lengthscales, variance=variance,
                   omega=omega, phase=phase, weights=weights, nu=nu)
    tensors[x_name] = x
    dev = x.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {x_name} on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    if x.ndim != x_rank or not x.is_contiguous():
        raise ValueError(f"{x_name} must be a contiguous rank-{x_rank} tensor, "
                         f"got shape {tuple(x.shape)}")
    din = x.shape[-1]
    d, m = nu.shape
    s = weights.shape[0]
    expect = dict(z=(m, din), lengthscales=(d, din), variance=(d,),
                  omega=(din, s, d), phase=(1, s, d), weights=(s, d))
    for name, shape in expect.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if not 1 <= din <= MAX_DIN or not 1 <= d <= MAX_D:
        raise ValueError(f"kernel supports 1 <= Din <= {MAX_DIN}, "
                         f"1 <= D <= {MAX_D}; got Din={din}, D={d}")
    return din, d, m, s


def _kernel_operands(z, lengthscales, variance, omega, phase, weights, nu):
    """The kernels' D-major layout, as contiguous tensors."""
    return (z.contiguous(), (1.0 / lengthscales).contiguous(),
            variance.contiguous(), omega.permute(2, 0, 1).contiguous(),
            phase[0].T.contiguous(), weights.T.contiguous(), nu.contiguous())


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/*.cu: tensor pointers, then sizes, then the stream.
_SIGNATURES = {
    "fused_rhs": {"gpode_fused_rhs_fwd": [_P] * 9 + [_I] * 7 + [_P],
                  "gpode_fused_rhs_bwd": [_P] * 14 + [_I] * 6 + [_P]},
    "fused_dopri5": {
        "gpode_dp_attempt_fwd": [_P] * 3 + [_F] * 2 + [_P] * 10 + [_I] * 7 + [_P],
        "gpode_dp_attempt_bwd": [_P] * 16 + [_I] * 6 + [_P]},
}
_TYPED: set = set()


def _lib(name):
    """The library `name` (built at first use) with every C function typed."""
    lib = cuda_build.load(name)
    if name not in _TYPED:
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _TYPED.add(name)
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _fwd_tiling(d):
    """Forward blocks: G groups of D warps, 2 rows per group."""
    groups = max(1, min(4, 32 // d))
    return 2 * groups, groups


def _bwd_rows_per_block(n, dev):
    """Backward tile: about three blocks per SM, so the card fills while the
    per-block partials (and the reduction that reads them) stay small."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, math.ceil(n / (3 * sms)))


def _acc_floats(din, m, s):
    return din * s + 2 * s + m + m * din


def _main_slab(din, m, s):
    return din * s + 2 * s + m + din + 1


def _check_smem(nbytes, what):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory per "
                         f"block, over the {MAX_SMEM_BYTES}-byte limit")


def _unpack_param_cotangents(out_main, out_dz, din, d, m, s):
    """(D, main_slab) + (M*Din) -> cotangents in the public layouts."""
    o = 0
    domega = out_main[:, o:o + din * s].reshape(d, din, s); o += din * s
    dphase = out_main[:, o:o + s]; o += s
    dw = out_main[:, o:o + s]; o += s
    dnu = out_main[:, o:o + m]; o += m
    dls = out_main[:, o:o + din]; o += din
    dvar = out_main[:, o]
    return (out_dz.reshape(m, din), dls.contiguous(), dvar.contiguous(),
            domega.permute(1, 2, 0).contiguous(), dphase.T[None].contiguous(),
            dw.T.contiguous(), dnu.contiguous())


def _bwd_scratch(n_blocks, din, d, m, s, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    qm = _main_slab(din, m, s)
    return (torch.empty(n_blocks * d * qm, **f32),
            torch.empty(n_blocks * d * m * din, **f32),
            torch.empty(d, qm, **f32), torch.empty(m * din, **f32))


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# fused_rhs
# ---------------------------------------------------------------------------

def _launch_rhs_fwd(x, ops, din, d, m, s):
    dev = x.device
    n = x.shape[0]
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    rows, groups = _fwd_tiling(d)
    lib = _lib("fused_rhs")
    LAUNCHES["fused_rhs_fwd"] += 1
    rc = lib.gpode_fused_rhs_fwd(
        _ptr(x), *map(_ptr, ops), _ptr(out), n, din, d, m, s, rows, groups,
        _stream(dev))
    _raise_on(rc, "fused_rhs forward")
    return out


def _launch_rhs_bwd(x, g, ops, din, d, m, s):
    dev = x.device
    n = x.shape[0]
    rows = _bwd_rows_per_block(n, dev)
    _check_smem(4 * (d * _acc_floats(din, m, s) + rows * (din + d + d * din)),
                "fused_rhs backward")
    n_blocks = math.ceil(n / rows)
    dx = torch.empty_like(x)
    part_main, part_dz, out_main, out_dz = _bwd_scratch(n_blocks, din, d, m,
                                                        s, dev)
    lib = _lib("fused_rhs")
    LAUNCHES["fused_rhs_bwd"] += 1
    rc = lib.gpode_fused_rhs_bwd(
        _ptr(x), _ptr(g), *map(_ptr, ops), _ptr(dx), _ptr(part_main),
        _ptr(part_dz), _ptr(out_main), _ptr(out_dz), n, din, d, m, s, rows,
        _stream(dev))
    _raise_on(rc, "fused_rhs backward")
    return (dx,) + _unpack_param_cotangents(out_main, out_dz, din, d, m, s)


class _FusedRhsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, z, lengthscales, variance, omega, phase, weights, nu):
        dims = _check(x, z, lengthscales, variance, omega, phase, weights, nu)
        ops = _kernel_operands(z, lengthscales, variance, omega, phase,
                               weights, nu)
        ctx.save_for_backward(x, *ops)
        ctx.dims = dims
        return _launch_rhs_fwd(x, ops, *dims)

    @staticmethod
    def backward(ctx, g):
        x, *ops = ctx.saved_tensors
        if x.shape[0] == 0:
            return (None,) * 8
        return _launch_rhs_bwd(x, g.contiguous(), ops, *ctx.dims)


def fused_rhs(x, z, lengthscales, variance, omega, phase, weights, nu):
    """Fused dimwise ODE right-hand side: (N, Din) -> (N, D).

    Differentiable in every operand; on CUDA both directions are kernels.
    """
    if x.device.type == "cpu":
        return fused_rhs_plain(x, z, lengthscales, variance, omega, phase,
                               weights, nu)
    return _FusedRhsFn.apply(x, z, lengthscales, variance, omega, phase,
                             weights, nu)


# ---------------------------------------------------------------------------
# fused_dopri5_attempt
# ---------------------------------------------------------------------------

_DP_COEF: dict = {}


def _dp_coefficients(dev):
    """A (7x7, row-major) | b5 (7) | b5 - b4 (7), from ops/ode.py's tableau,
    cached per device; b5 - b4 is formed in double and rounded once, as the
    JAX stage code does with its Python-float coefficients."""
    if dev not in _DP_COEF:
        a = [[0.0] * 7 for _ in range(7)]
        for i, row in enumerate(_DP_A):
            a[i][:len(row)] = row
        flat = ([v for row in a for v in row] + list(_DP_B5)
                + [b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4)])
        _DP_COEF[dev] = torch.tensor(flat, dtype=torch.float32, device=dev)
    return _DP_COEF[dev]


def _check_dt(dt, dev):
    if dt.device != dev or dt.dtype != torch.float32 or dt.numel() != 1:
        raise ValueError("dt must be a one-element float32 tensor on the "
                         "device of x0")
    return dt.reshape(1).contiguous()


def _launch_dp_fwd(x0, dt, rtol, atol, ops, din, d, m, s):
    dev = x0.device
    n = x0.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    x5, err = torch.empty(n, d, **f32), torch.empty(n, d, **f32)
    xs = torch.empty(6, n, din, **f32)
    if n == 0:
        return x5, err, xs
    rows, groups = _fwd_tiling(d)
    lib = _lib("fused_dopri5")
    LAUNCHES["fused_dopri5_attempt_fwd"] += 1
    rc = lib.gpode_dp_attempt_fwd(
        _ptr(x0), _ptr(dt), _ptr(_dp_coefficients(dev)),
        ctypes.c_float(rtol), ctypes.c_float(atol), *map(_ptr, ops),
        _ptr(x5), _ptr(err), _ptr(xs), n, din, d, m, s, rows, groups,
        _stream(dev))
    _raise_on(rc, "fused_dopri5_attempt forward")
    return x5, err, xs


def _launch_dp_bwd(xs, g, dt, ops, din, d, m, s):
    dev = xs.device
    n = xs.shape[1]
    rows = _bwd_rows_per_block(n, dev)
    _check_smem(4 * (d * _acc_floats(din, m, s)
                     + rows * (7 * din + 6 * d + d * din)),
                "fused_dopri5_attempt backward")
    n_blocks = math.ceil(n / rows)
    dx = torch.empty(n, din, dtype=torch.float32, device=dev)
    part_main, part_dz, out_main, out_dz = _bwd_scratch(n_blocks, din, d, m,
                                                        s, dev)
    lib = _lib("fused_dopri5")
    LAUNCHES["fused_dopri5_attempt_bwd"] += 1
    rc = lib.gpode_dp_attempt_bwd(
        _ptr(xs), _ptr(g), _ptr(dt), _ptr(_dp_coefficients(dev)),
        *map(_ptr, ops), _ptr(dx), _ptr(part_main), _ptr(part_dz),
        _ptr(out_main), _ptr(out_dz), n, din, d, m, s, rows, _stream(dev))
    _raise_on(rc, "fused_dopri5_attempt backward")
    return (dx,) + _unpack_param_cotangents(out_main, out_dz, din, d, m, s)


class _FusedDopri5AttemptFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, dt, z, lengthscales, variance, omega, phase, weights,
                nu, rtol, atol):
        dims = _check(x0, z, lengthscales, variance, omega, phase, weights,
                      nu, x_name="x0")
        if dims[0] != dims[1]:
            raise ValueError(f"the dopri5 attempt needs Din == D, got "
                             f"{dims[0]} and {dims[1]}")
        dt = _check_dt(dt, x0.device)
        ops = _kernel_operands(z, lengthscales, variance, omega, phase,
                               weights, nu)
        x5, err, xs = _launch_dp_fwd(x0, dt, float(rtol), float(atol), ops,
                                     *dims)
        ctx.save_for_backward(xs, dt, *ops)
        ctx.dims = dims
        ctx.mark_non_differentiable(err)
        return x5, err

    @staticmethod
    def backward(ctx, g_x5, _g_err):
        xs, dt, *ops = ctx.saved_tensors
        if g_x5 is None or xs.shape[1] == 0:
            return (None,) * 11
        grads = _launch_dp_bwd(xs, g_x5.contiguous(), dt, ops, *ctx.dims)
        return (grads[0], None) + grads[1:] + (None, None)


def fused_dopri5_attempt(x0, dt, z, lengthscales, variance, omega, phase,
                         weights, nu, rtol=1e-6, atol=1e-6):
    """One whole-span Dormand-Prince attempt: returns (x5 (N, D),
    err_scaled (N, D)). err_scaled is the embedded error already divided by
    the tolerance scale and carries no gradient; dt (a one-element tensor)
    is non-differentiable. On CUDA the forward and the backward are each
    one kernel (plus the backward's fixed-order reduction)."""
    if x0.device.type == "cpu":
        x5, err, _ = dopri5_attempt_plain(x0, dt, z, lengthscales, variance,
                                          omega, phase, weights, nu, rtol,
                                          atol)
        return x5, err
    return _FusedDopri5AttemptFn.apply(x0, dt, z, lengthscales, variance,
                                       omega, phase, weights, nu, rtol, atol)
