"""Hand-written Hopper kernels for the hot GPODE ops, with their plain
PyTorch versions and autograd rules.

Counterpart of `gpode_tpu/ops/pallas_kernels.py`:

  * :func:`fused_rhs` — the decoupled-sampling ODE right-hand side
    f(x) = cos(x Omega + phase) * sqrt(2 var / S) @ w + nu^T K(Z, x), forward
    and VJP (`csrc/fused_rhs.cu`);
  * :func:`fused_dopri5_attempt` — one whole-span Dormand-Prince step for a
    batch of rows, forward and the reverse sweep of its 5th-order chain
    (`csrc/fused_dopri5.cu`; the official recipe);
  * :func:`fused_rk4_segment` — `substeps` rk4 steps over one shooting
    interval for a batch of rows, forward and the reverse sweep of the stage
    chain (`csrc/fused_rk4.cu`; the `fast` recipe);
  * :func:`rbf_gram` — the dimwise RBF cross-Gram K(x, Z) (D, N, M), forward
    only (`csrc/rbf_gram.cu`; the vector-field posterior `gp.conditional`).

The wide-layout rhs kernels (`csrc/fused_rhs_wide.cu`) are bound in
`ops/wide_rhs.py` and share this module's counters and helpers.
:func:`segment_bwd_geometry` is the launch geometry of the two segment
backward kernels, pure arithmetic that the CPU tests reach.

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
import dataclasses
import math

import torch

from gpode_tpu_torch.ops import cuda_build
from gpode_tpu_torch.ops.ode import _DP_A, _DP_B4, _DP_B5

LAUNCHES = {"fused_rhs_fwd": 0, "fused_rhs_bwd": 0,
            "fused_dopri5_attempt_fwd": 0, "fused_dopri5_attempt_bwd": 0,
            "fused_rk4_segment_fwd": 0, "fused_rk4_segment_bwd": 0,
            "rbf_gram": 0, "fused_rhs_wide_fwd": 0, "fused_rhs_wide2_fwd": 0,
            "fused_rhs_wide_bwd": 0}

# Kernel limits (csrc/rhs_tile.cuh): Din unrolled up to 16 in registers;
# 32 * D threads per `fused_rhs` backward block; 227 KB of shared memory per
# block.
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


def rbf_gram_plain(x, z, lengthscales, variance):
    """The dimwise Gram K (D, N, M) as plain tensor ops: the Din outer
    differences of the pre-scaled inputs, summed in k order
    (`_sqdist_tile` / `_rbf_gram_kernel`)."""
    inv_ls = 1.0 / lengthscales                                  # (D, Din)
    acc = x.new_zeros(lengthscales.shape[0], x.shape[0], z.shape[0])
    for k in range(x.shape[1]):
        xk = x[None, :, k, None] * inv_ls[:, k, None, None]      # (D, N, 1)
        zk = z[None, None, :, k] * inv_ls[:, k, None, None]      # (D, 1, M)
        diff = xk - zk
        acc = acc + diff * diff
    return variance[:, None, None] * torch.exp(-0.5 * acc)


def rk4_segment_plain(x0, dt, z, lengthscales, variance, omega, phase,
                      weights, nu, substeps=1):
    """`substeps` rk4 steps of size h = dt / substeps (float32, from the
    full-span dt) as plain tensor ops (`_rk4_stages` / `_fused_rk4_kernel`).

    Returns (x1, xs): the state after the interval and the 4 * substeps
    stage inputs (4 * substeps, N, Din), step by step (x, x2, x3, x4).
    """
    def f(xx):
        return fused_rhs_plain(xx, z, lengthscales, variance, omega, phase,
                               weights, nu)

    h = dt / substeps
    x, xs = x0, []
    for _ in range(substeps):
        k1 = f(x)
        x2 = x + 0.5 * h * k1
        k2 = f(x2)
        x3 = x + 0.5 * h * k2
        k3 = f(x3)
        x4 = x + h * k3
        k4 = f(x4)
        xs += [x, x2, x3, x4]
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x, torch.stack(xs)


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
                  "gpode_fused_rhs_bwd": [_P] * 14 + [_I] * 6 + [_P],
                  "gpode_fused_rhs_bwd_occupancy": [_I] * 5 + [_P]},
    "fused_dopri5": {
        "gpode_dp_attempt_fwd": [_P] * 3 + [_F] * 2 + [_P] * 10 + [_I] * 7 + [_P],
        "gpode_dp_attempt_bwd": [_P] * 16 + [_I] * 10 + [_P],
        "gpode_dp_attempt_bwd_occupancy": [_I] * 8 + [_P]},
    "fused_rk4": {"gpode_rk4_fwd": [_P] * 11 + [_I] * 8 + [_P],
                  "gpode_rk4_bwd": [_P] * 15 + [_I] * 11 + [_P],
                  "gpode_rk4_bwd_occupancy": [_I] * 8 + [_P]},
    "rbf_gram": {"gpode_rbf_gram": [_P] * 5 + [_I] * 6 + [_P]},
    "fused_rhs_wide": {"gpode_wide_fwd": [_P] * 7 + [_I] * 8 + [_P],
                       "gpode_wide_bwd": [_P] * 10 + [_I] * 7 + [_P],
                       "gpode_wide_bwd_occupancy": [_I] * 5 + [_P]},
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


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _bwd_rows_per_block(n, dev):
    """`fused_rhs` backward tile: about three blocks per SM, so the card
    fills while the per-block partials (and the reduction that reads them)
    stay small."""
    return max(1, math.ceil(n / (3 * _sms(dev))))


def _acc_floats(din, m, s):
    return din * s + 2 * s + m + m * din


def _main_slab(din, m, s):
    return din * s + 2 * s + m + din + 1


def _check_smem(nbytes, what):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory per "
                         f"block, over the {MAX_SMEM_BYTES}-byte limit")


# Segment backward blocks (csrc/rhs_tile.cuh `rhs_vjp_tile`): about
# _SEG_BWD_WARPS warps, G groups of D, over tiles of RT rows; at most
# _SEG_BWD_BLOCKS_PER_SM blocks per SM, so one slab per block stays cheap.
# Measured on an H100 at N=2970, Din=D=5 (the sweep is in PERF.md): two
# resident 10-warp blocks of 12 rows beat one 20-warp block and 8-row blocks.
_SEG_BWD_WARPS = 10
_SEG_BWD_BLOCKS_PER_SM = 2
# (dp, rt, maxt) of the instantiated kernel variants by stages, smallest dp
# first; a shape takes the first with Din <= dp. The dopri5 attempt (6) has
# registers for 6-row tiles at Din = 5, the rk4 segment (4) would spill there.
_SEG_BWD_VARIANTS = {
    6: ((4, 4, 640), (5, 6, 640), (8, 4, 512), (16, 1, 512)),
    4: ((4, 4, 640), (5, 4, 640), (8, 4, 512), (16, 1, 512)),
}


@dataclasses.dataclass(frozen=True)
class SegmentBwdGeometry:
    """Launch geometry of a segment backward kernel (dopri5 attempt: 6
    stages in shared memory; rk4 segment: 4)."""
    dp: int               # the kernel variant's bound of its loops over Din
    rt: int               # rows per tile; rt * dp <= 32, the dx fold's width
    groups: int           # G: the block is G groups of D warps
    maxt: int             # the variant's thread bound (registers: 65536 / maxt)
    threads: int
    rows_per_block: int   # a multiple of rt
    blocks: int
    smem_bytes: int
    part_main_floats: int  # scratch: (blocks, D, main_slab)
    part_dz_floats: int    # scratch: (blocks, D, M * Din)


def _align4(floats):
    return (floats + 3) & ~3


def segment_bwd_geometry(n, din, d, m, s, stages, sms):
    """Geometry of the dopri5-attempt (`stages=6`) or rk4-segment
    (`stages=4`) backward for N rows on a card of `sms` multiprocessors;
    raises ValueError on a shape the kernels do not take. Pure arithmetic:
    no device is touched."""
    if stages not in (4, 6):
        raise ValueError(f"stages must be 4 (rk4) or 6 (dopri5), got {stages}")
    if din != d:
        raise ValueError(f"the segment kernels need Din == D, got {din} and {d}")
    if not 1 <= din <= MAX_DIN or m < 1 or s < 1 or n < 1:
        raise ValueError(f"segment backward supports 1 <= Din = D <= {MAX_DIN} "
                         f"and N, M, S >= 1; got N={n}, Din={din}, M={m}, S={s}")
    dp, rt, maxt = next(v for v in _SEG_BWD_VARIANTS[stages] if din <= v[0])
    units = math.ceil(s / 32) + math.ceil(m / 32)     # 32-column units per dim
    groups = max(1, min(units, min(_SEG_BWD_WARPS, maxt // 32) // d))
    warps = d * groups
    tiles = math.ceil(n / rt)
    rows_per_block = rt * math.ceil(tiles / (_SEG_BWD_BLOCKS_PER_SM * sms))
    blocks = math.ceil(n / rows_per_block)
    # csrc/rhs_tile.cuh TileSmem: xt (stages, rt, stride) | planes of rt * dp
    # floats (dopri5: gk x 6, gxt; rk4: gx x 4, gt, cot) | il (dp, dp) |
    # accumulators | dls (warps, dp, 32) | dxw (warps, 32)
    planes = 7 if stages == 6 else 6
    smem = 4 * (stages * rt * _align4(dp) + planes * _align4(rt * dp) + dp * dp
                + _align4(d * _acc_floats(din, m, s)) + 32 * dp * warps
                + 32 * warps)
    _check_smem(smem, "segment backward")
    return SegmentBwdGeometry(
        dp=dp, rt=rt, groups=groups, maxt=maxt, threads=32 * warps,
        rows_per_block=rows_per_block, blocks=blocks, smem_bytes=smem,
        part_main_floats=blocks * d * _main_slab(din, m, s),
        part_dz_floats=blocks * d * m * din)


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


def _segment_bwd_buffers(geo, n, din, d, m, s, dev):
    """dx and the scratch of a segment backward at geometry `geo`: one slab
    per (block, dim), and the two reduced outputs."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(n, din, **f32),
            torch.empty(geo.part_main_floats, **f32),
            torch.empty(geo.part_dz_floats, **f32),
            torch.empty(d, _main_slab(din, m, s), **f32),
            torch.empty(m * din, **f32))


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def require_no_grad(what, *tensors):
    """The forward-only kernels have no autograd rule: refuse operands that
    would need one (grad mode on and a tensor that requires grad)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward only (no gradient is defined): call it under "
            f"torch.no_grad() or with detached operands")


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


def _launch_rhs_bwd_packed(x, g, ops, din, d, m, s):
    """The backward kernel and its fixed-order reduction: (dx, out_main
    (D, main_slab), out_dz (M*Din)), the parameter cotangents still packed."""
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
    return dx, out_main, out_dz


def _launch_rhs_bwd(x, g, ops, din, d, m, s):
    dx, out_main, out_dz = _launch_rhs_bwd_packed(x, g, ops, din, d, m, s)
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


def _check_segment(x0, dt, z, lengthscales, variance, omega, phase, weights,
                   nu, what):
    """Operand checks of the ODE-step kernels, which add k (N, D) to x
    (N, Din): the rhs checks, Din == D, and a one-element dt."""
    dims = _check(x0, z, lengthscales, variance, omega, phase, weights, nu,
                  x_name="x0")
    if dims[0] != dims[1]:
        raise ValueError(f"{what} needs Din == D, got {dims[0]} and {dims[1]}")
    return dims, _check_dt(dt, x0.device)


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
    geo = segment_bwd_geometry(n, din, d, m, s, 6, _sms(dev))
    dx, part_main, part_dz, out_main, out_dz = _segment_bwd_buffers(
        geo, n, din, d, m, s, dev)
    lib = _lib("fused_dopri5")
    LAUNCHES["fused_dopri5_attempt_bwd"] += 1
    rc = lib.gpode_dp_attempt_bwd(
        _ptr(xs), _ptr(g), _ptr(dt), _ptr(_dp_coefficients(dev)),
        *map(_ptr, ops), _ptr(dx), _ptr(part_main), _ptr(part_dz),
        _ptr(out_main), _ptr(out_dz), n, din, d, m, s, geo.rows_per_block,
        geo.dp, geo.rt, geo.groups, geo.maxt, _stream(dev))
    _raise_on(rc, "fused_dopri5_attempt backward")
    return (dx,) + _unpack_param_cotangents(out_main, out_dz, din, d, m, s)


class _FusedDopri5AttemptFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, dt, z, lengthscales, variance, omega, phase, weights,
                nu, rtol, atol):
        dims, dt = _check_segment(x0, dt, z, lengthscales, variance, omega,
                                  phase, weights, nu, "the dopri5 attempt")
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


# ---------------------------------------------------------------------------
# fused_rk4_segment
# ---------------------------------------------------------------------------

def _launch_rk4_fwd(x0, dt, substeps, ops, din, d, m, s):
    dev = x0.device
    n = x0.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    x1, xs = torch.empty(n, d, **f32), torch.empty(4 * substeps, n, din, **f32)
    if n == 0:
        return x1, xs
    rows, groups = _fwd_tiling(d)
    lib = _lib("fused_rk4")
    LAUNCHES["fused_rk4_segment_fwd"] += 1
    rc = lib.gpode_rk4_fwd(
        _ptr(x0), _ptr(dt), *map(_ptr, ops), _ptr(x1), _ptr(xs), n, din, d,
        m, s, substeps, rows, groups, _stream(dev))
    _raise_on(rc, "fused_rk4_segment forward")
    return x1, xs


def _launch_rk4_bwd(xs, g, dt, substeps, ops, din, d, m, s):
    dev = xs.device
    n = xs.shape[1]
    geo = segment_bwd_geometry(n, din, d, m, s, 4, _sms(dev))
    dx, part_main, part_dz, out_main, out_dz = _segment_bwd_buffers(
        geo, n, din, d, m, s, dev)
    lib = _lib("fused_rk4")
    LAUNCHES["fused_rk4_segment_bwd"] += 1
    rc = lib.gpode_rk4_bwd(
        _ptr(xs), _ptr(g), _ptr(dt), *map(_ptr, ops), _ptr(dx),
        _ptr(part_main), _ptr(part_dz), _ptr(out_main), _ptr(out_dz), n, din,
        d, m, s, substeps, geo.rows_per_block, geo.dp, geo.rt, geo.groups,
        geo.maxt, _stream(dev))
    _raise_on(rc, "fused_rk4_segment backward")
    return (dx,) + _unpack_param_cotangents(out_main, out_dz, din, d, m, s)


class _FusedRk4SegmentFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, dt, z, lengthscales, variance, omega, phase, weights,
                nu, substeps):
        dims, dt = _check_segment(x0, dt, z, lengthscales, variance, omega,
                                  phase, weights, nu, "the rk4 segment")
        ops = _kernel_operands(z, lengthscales, variance, omega, phase,
                               weights, nu)
        x1, xs = _launch_rk4_fwd(x0, dt, substeps, ops, *dims)
        ctx.save_for_backward(xs, dt, *ops)
        ctx.dims, ctx.substeps = dims, substeps
        return x1

    @staticmethod
    def backward(ctx, g):
        xs, dt, *ops = ctx.saved_tensors
        if xs.shape[1] == 0:
            return (None,) * 10
        grads = _launch_rk4_bwd(xs, g.contiguous(), dt, ctx.substeps, ops,
                                *ctx.dims)
        return (grads[0], None) + grads[1:] + (None,)


def fused_rk4_segment(x0, dt, z, lengthscales, variance, omega, phase,
                      weights, nu, substeps: int = 1):
    """Integrate one shooting interval with `substeps` rk4 steps:
    x0 (N, Din) -> x(t0 + dt) (N, D), Din == D. dt (a one-element tensor) is
    non-differentiable (observation grids are data); every other operand
    gets its cotangent from the reverse sweep of the stage chain. On CUDA the
    forward and the backward are each one kernel (plus the backward's
    fixed-order reduction)."""
    if not isinstance(substeps, int) or substeps < 1:
        raise ValueError(f"substeps must be a positive int, got {substeps!r}")
    if x0.device.type == "cpu":
        return rk4_segment_plain(x0, dt.detach(), z, lengthscales, variance,
                                 omega, phase, weights, nu, substeps)[0]
    return _FusedRk4SegmentFn.apply(x0, dt, z, lengthscales, variance, omega,
                                    phase, weights, nu, substeps)


# ---------------------------------------------------------------------------
# What a backward kernel holds on the card
# ---------------------------------------------------------------------------

def kernel_occupancy(lib_name, c_function, entry_key, *int_args):
    """One backward kernel's resources at a launch geometry: the occupancy
    query of `c_function` (csrc: resident blocks per SM, block threads,
    dynamic shared bytes, registers, local bytes) and the registers and spill
    bytes that ptxas reported for the entry whose mangled name contains
    `entry_key`."""
    out = (ctypes.c_int * 5)()
    rc = getattr(_lib(lib_name), c_function)(
        *int_args, ctypes.cast(out, ctypes.c_void_p))
    _raise_on(rc, f"{c_function} query")
    resident, threads, smem, registers, local = out
    found = [v for k, v in cuda_build.kernel_resources(lib_name).items()
             if entry_key in k]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} ptxas records match {entry_key!r} in "
                           f"{lib_name}")
    return dict(entry=entry_key, threads=threads, smem_bytes=smem,
                blocks_per_sm=resident, warps_per_sm=resident * threads // 32,
                registers=registers, local_bytes=local,
                ptxas_registers=found[0]["registers"],
                spill_stores=found[0]["spill_stores"],
                spill_loads=found[0]["spill_loads"])


def segment_bwd_occupancy(stages, din, d, m, s, geo):
    """`kernel_occupancy` of the dopri5-attempt (`stages=6`) or rk4-segment
    (`stages=4`) backward at geometry `geo`."""
    lib_name, fn, kernel = {
        6: ("fused_dopri5", "gpode_dp_attempt_bwd_occupancy",
            "dp_attempt_bwd_kernel"),
        4: ("fused_rk4", "gpode_rk4_bwd_occupancy", "rk4_bwd_kernel")}[stages]
    key = f"{kernel}ILi{geo.dp}ELi{geo.rt}ELi{geo.maxt}EE"
    report = kernel_occupancy(lib_name, fn, key, din, d, m, s, geo.dp, geo.rt,
                              geo.groups, geo.maxt)
    if report["smem_bytes"] != geo.smem_bytes:
        raise RuntimeError(f"{kernel} takes {report['smem_bytes']} bytes of "
                           f"shared memory, the geometry says {geo.smem_bytes}")
    return report


def rhs_bwd_occupancy(n, din, d, m, s, dev):
    """`kernel_occupancy` of the `fused_rhs` backward for N rows."""
    return kernel_occupancy("fused_rhs", "gpode_fused_rhs_bwd_occupancy",
                            "fused_rhs_bwd_kernel", din, d, m, s,
                            _bwd_rows_per_block(n, dev))


# ---------------------------------------------------------------------------
# rbf_gram
# ---------------------------------------------------------------------------

_GRAM_ROWS, _GRAM_THREADS = 32, 256


def _launch_rbf_gram(x, z, inv_ls, variance):
    """One launch on contiguous CUDA operands; inv_ls (D, Din) = 1 / ls."""
    dev = x.device
    (n, din), m, d = x.shape, z.shape[0], inv_ls.shape[0]
    out = torch.empty(d, n, m, dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out
    lib = _lib("rbf_gram")
    LAUNCHES["rbf_gram"] += 1
    rc = lib.gpode_rbf_gram(_ptr(x), _ptr(z), _ptr(inv_ls), _ptr(variance),
                            _ptr(out), n, din, d, m, _GRAM_ROWS,
                            _GRAM_THREADS, _stream(dev))
    _raise_on(rc, "rbf_gram")
    return out


def rbf_gram(x, z, lengthscales, variance):
    """Dimwise RBF cross-Gram K(x, z): x (N, Din), z (M, Din), lengthscales
    (D, Din) and variance (D,) constrained -> (D, N, M) float32.

    Forward only, as the TPU kernel it replaces: with grad mode on and an
    operand that requires grad it raises. A CUDA tensor launches the kernel
    or raises; a CPU tensor takes :func:`rbf_gram_plain`."""
    require_no_grad("rbf_gram", x, z, lengthscales, variance)
    if x.device.type == "cpu":
        return rbf_gram_plain(x, z, lengthscales, variance)
    dev = x.device
    tensors = dict(x=x, z=z, lengthscales=lengthscales, variance=variance)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.ndim != 2 or z.ndim != 2 or lengthscales.ndim != 2:
        raise ValueError("rbf_gram takes x (N, Din), z (M, Din) and dimwise "
                         "lengthscales (D, Din)")
    din, d = x.shape[1], lengthscales.shape[0]
    if (z.shape[1] != din or lengthscales.shape[1] != din
            or tuple(variance.shape) != (d,)):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, z {tuple(z.shape)}, "
            f"lengthscales {tuple(lengthscales.shape)}, variance "
            f"{tuple(variance.shape)}")
    if not 1 <= d <= 65535:
        raise ValueError(f"rbf_gram supports 1 <= D <= 65535, got {d}")
    _check_smem(4 * (z.shape[0] + _GRAM_ROWS) * din, "rbf_gram")
    with torch.no_grad():
        return _launch_rbf_gram(x.contiguous(), z.contiguous(),
                                (1.0 / lengthscales).contiguous(),
                                variance.contiguous())
