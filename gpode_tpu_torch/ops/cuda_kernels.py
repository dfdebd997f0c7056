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
    only (`csrc/rbf_gram.cu`; the vector-field posterior `gp.conditional`);
  * :func:`dopri5_attempt_draws` — one adaptive dopri5 attempt of S field
    draws at once with its max-over-draws error norm, forward only
    (`csrc/dopri5_draws.cu`; the batched prediction solve's captured
    attempt, `models/flow.CapturedAttempt`). It replaces no Pallas kernel;
  * :func:`draws_commit` — an accepted attempt's commit on the device: the
    cubic Hermite dense output of `ops/ode.odeint_dopri5` at the step's
    output times and the hand-over of its state (`csrc/dopri5_draws.cu`;
    the captured attempt's last node). It replaces no Pallas kernel either;
  * :func:`draw_solve` — a posterior draw's update coefficients on its own
    factor, nu = L^{-T}(v - L^{-1} u) with L = chol(K(Z,Z) + jitter I), and
    their VJP in K, u and v (`csrc/draw_solve.cu`; `gp.draw_posterior`), at
    M <= 256: a square factor a block up to M = 128, a packed triangle past
    it. It replaces no Pallas kernel: XLA's Cholesky and triangular solves;
  * :func:`state_entropy` — the shooting states' entropies, 0.5 (D (1 +
    log 2 pi) + log det(L L^T + jitter I)) of every packed scale L at
    D <= 8, and their VJP, bit for bit autograd's through the unrolled
    chain (`csrc/state_entropy.cu`; `states.shooting_entropy`). It replaces
    no Pallas kernel: XLA fuses the unrolled Cholesky of
    `ops/math.cholesky_small`.

The wide-layout rhs kernels (`csrc/fused_rhs_wide.cu`) are bound in
`ops/wide_rhs.py` and share this module's counters and helpers.

`fused_rhs` and the two segment kernels run on one row tile
(`csrc/rhs_tile.cuh`). Their launch geometries — :func:`rhs_fwd_geometry`,
:func:`rhs_bwd_geometry`, :func:`segment_fwd_geometry` and
:func:`segment_bwd_geometry` — are pure arithmetic that the CPU tests reach;
each raises ValueError on a shape its kernel does not take, and
:func:`kernel_refusal` asks both directions of a kernel at once (the
models' dispatch rule). A differentiable call checks its backward's geometry
before the forward launches, so a refused shape raises before any launch.

Each public function takes the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. The backward kernels are first
order only: their autograd rules are `first_order_only`, so a double
backward through a kernel raises instead of returning wrong second
derivatives (the implicit BDF solver, which needs one, runs on the plain
rhs). `LAUNCHES` counts kernel launches per wrapper (the launch of the
kernel itself; the fixed-order reduction pass that follows a backward
kernel belongs to the same count).

Operands enter in the JAX package's layouts — lengthscales (D, Din) and
variance (D,) CONSTRAINED, omega (Din, S, D), phase (1, S, D), weights
(S, D), nu (D, M) — and the wrappers make the kernels' D-major layout
(1/lengthscale, omega (D, Din, S), phase/w (D, S)).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from gpode_tpu_torch.ops import cuda_build
from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.kernels import _sqdist
from gpode_tpu_torch.ops.ode import (_DP_A, _DP_B4, _DP_B5, _hermite,
                                     dopri5_attempt, max_rms_over_axis0)

LAUNCHES = {"fused_rhs_fwd": 0, "fused_rhs_bwd": 0,
            "fused_dopri5_attempt_fwd": 0, "fused_dopri5_attempt_bwd": 0,
            "fused_rk4_segment_fwd": 0, "fused_rk4_segment_bwd": 0,
            "rbf_gram": 0, "fused_rhs_wide_fwd": 0, "fused_rhs_wide2_fwd": 0,
            "fused_rhs_wide_bwd": 0, "dopri5_attempt_draws": 0,
            "draws_commit": 0, "draw_solve_fwd": 0, "draw_solve_bwd": 0,
            "draw_solve_fwd_packed": 0, "draw_solve_bwd_slabs": 0,
            "state_entropy_fwd": 0, "state_entropy_bwd": 0}
# Posterior draws (`gp.draw_posterior`) by where their update coefficients
# were solved: "device", the `draw_solve` kernels on the draw's own factor
# of K(Z, Z); "library", the library's factorisation and triangular solves
# (a draw handed a factor, `kernels=False`, a shape or dtype the kernels
# refuse, the CPU). One count a draw; its keys are none of `LAUNCHES`', and
# a captured graph's replay counts its capture's (`ops/capture.py`).
DRAW_SOLVES = {"device": 0, "library": 0}
# Shooting-state entropies (`states.shooting_entropy`) by route:
# "state_device", the `state_entropy` kernels; "state_unrolled", the
# unrolled Cholesky chain (`kernels=False`, the CPU, float64, D > 8). One
# count a call; keys none of `LAUNCHES`' or `DRAW_SOLVES`', and a replay
# counts its capture's (`ops/capture.py`).
STATE_ENTROPIES = {"state_device": 0, "state_unrolled": 0}
# (draws, N, Din, D, M, S) of every `dopri5_attempt_draws` launch (a captured
# graph's replays repeat its capture's shape)
DRAWS_ATTEMPT_SHAPES: set = set()
# (B factors, M, R columns a factor) of every `draw_solve` forward launch
# (and so of its backward; a captured graph's replays repeat its capture's)
DRAW_SOLVE_SHAPES: set = set()

# Kernel limits (csrc/rhs_tile.cuh): Din unrolled up to 16 in registers; a
# block holds at least one warp per output dim, so D is bounded by the
# variant's threads (1024 / 32 at most; the geometries say per variant);
# 227 KB of shared memory per block.
MAX_DIN = 16
MAX_D = 32
MAX_SMEM_BYTES = 232448


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DRAWS_ATTEMPT_SHAPES.clear()
    DRAW_SOLVE_SHAPES.clear()


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


def draws_field_plain(x, z, lengthscales, variance, omega, phase, weights,
                      nu):
    """S dimwise field draws at x (S, N, Din) -> (S, N, D) as plain tensor
    ops: the operations of `gp.eval_draws`'s batched plain evaluation, in
    its order, so that on the same operands both give the same bits (the
    draws' leaves carry the leading draw axis: omega (S, Din, Sf, D), phase
    (S, 1, Sf, D), weights (S, Sf, D), nu (S, D, M))."""
    scale = torch.sqrt(2.0 * variance / weights.shape[-2])
    xo = torch.einsum("...nd,...dfk->...nfk", x, omega)
    phi = torch.cos(xo + phase) * scale
    f_prior = torch.einsum("...nfk,...fk->...nk", phi, weights)
    sq = _sqdist(z[None, :, :] / lengthscales[:, None, :],
                 x[..., None, :, :] / lengthscales[:, None, :])
    kuf = variance[:, None, None] * torch.exp(-0.5 * sq)   # (S, D, M, N)
    return f_prior + torch.einsum("...dm,...dmn->...nd", nu, kuf)


def dopri5_attempt_draws_plain(x, k1, dt, direction, z, lengthscales,
                               variance, omega, phase, weights, nu,
                               rtol=1e-6, atol=1e-6):
    """One adaptive dopri5 attempt of S draws as plain tensor ops: the
    `ops/ode.dopri5_attempt` of the batched solve on the field `direction *
    draws_field_plain` with the max-over-draws error norm
    (`max_rms_over_axis0`). Returns (x_new, ratio, k7): the 5th-order step
    (S, N, D), the 0-d error norm, which accepts the step at <= 1, and the
    last stage's derivative, k1 of the next step (FSAL)."""
    def field(t, xx):
        del t  # time-invariant ODE
        return direction * draws_field_plain(xx, z, lengthscales, variance,
                                             omega, phase, weights, nu)

    return dopri5_attempt(field, rtol=rtol, atol=atol,
                          norm=max_rms_over_axis0)(None, x, k1, dt)


def draws_commit_plain(ratio, scalars, taus, out, x, k1, x_new, k7):
    """An accepted attempt's commit, in place, as `odeint_dopri5` makes it
    on the host: where the 0-d `ratio` accepts (<= 1), each output time
    tau < taus[j] <= tau_end (scalars = [dt, tau, tau_end]) gets the cubic
    Hermite point `ops/ode._hermite` into out[j], then x <- x_new and
    k1 <- k7; a reject (or NaN) changes nothing."""
    if not float(ratio) <= 1.0:
        return
    _, tau, tau_end = scalars.cpu().numpy()
    for j, tau_j in enumerate(taus.cpu().numpy()):
        if tau < tau_j <= tau_end:
            out[j].copy_(_hermite(tau_j, tau, tau_end, x, k1, x_new, k7))
    x.copy_(x_new)
    k1.copy_(k7)


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
    "fused_rhs": {"gpode_fused_rhs_fwd": [_P] * 9 + [_I] * 9 + [_P],
                  "gpode_fused_rhs_fwd_occupancy": [_I] * 8 + [_P],
                  "gpode_fused_rhs_bwd": [_P] * 14 + [_I] * 10 + [_P],
                  "gpode_fused_rhs_bwd_occupancy": [_I] * 8 + [_P]},
    "fused_dopri5": {
        "gpode_dp_attempt_fwd": [_P] * 3 + [_F] * 2 + [_P] * 10 + [_I] * 9 + [_P],
        "gpode_dp_attempt_fwd_occupancy": [_I] * 8 + [_P],
        "gpode_dp_attempt_bwd": [_P] * 16 + [_I] * 10 + [_P],
        "gpode_dp_attempt_bwd_occupancy": [_I] * 8 + [_P]},
    "fused_rk4": {"gpode_rk4_fwd": [_P] * 11 + [_I] * 10 + [_P],
                  "gpode_rk4_fwd_occupancy": [_I] * 8 + [_P],
                  "gpode_rk4_bwd": [_P] * 15 + [_I] * 11 + [_P],
                  "gpode_rk4_bwd_occupancy": [_I] * 8 + [_P]},
    "rbf_gram": {"gpode_rbf_gram": [_P] * 5 + [_I] * 8 + [_P],
                 "gpode_rbf_gram_occupancy": [_I] * 7 + [_P]},
    "fused_rhs_wide": {"gpode_wide_fwd": [_P] * 7 + [_I] * 10 + [_P],
                       "gpode_wide_fwd_occupancy": [_I] * 9 + [_P],
                       "gpode_wide_bwd": [_P] * 11 + [_I] * 10 + [_P],
                       "gpode_wide_bwd_occupancy": [_I] * 8 + [_P]},
    "dopri5_draws": {
        "gpode_dp_draws_attempt": [_P] * 4 + [_F] * 3 + [_P] * 11 + [_I] * 10 + [_P],
        "gpode_dp_draws_attempt_occupancy": [_I] * 8 + [_P],
        "gpode_dp_draws_commit": [_P] * 8 + [_I] * 2 + [_P]},
    "draw_solve": {"gpode_draw_solve_fwd": [_P] * 3 + [_F] + [_P] * 3 + [_I] * 3 + [_P],
                   "gpode_draw_solve_bwd": [_P] * 7 + [_I] * 3 + [_P],
                   "gpode_draw_solve_bwd_slabs": [_P] * 8 + [_I] * 3 + [_P],
                   "gpode_draw_solve_occupancy": [_I] * 3 + [_P]},
    "state_entropy": {"gpode_state_entropy_fwd": [_P] + [_F] * 2 + [_P] + [_I] * 2 + [_P],
                      "gpode_state_entropy_bwd": [_P] * 2 + [_F] + [_P] + [_I] * 2 + [_P],
                      "gpode_state_entropy_occupancy": [_I] * 2 + [_P]},
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


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _acc_floats(din, m, s):
    return din * s + 2 * s + m + m * din


def _main_slab(din, m, s):
    return din * s + 2 * s + m + din + 1


def _check_smem(nbytes, what):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory per "
                         f"block, over the {MAX_SMEM_BYTES}-byte limit")


# `fused_rhs` blocks (csrc/fused_rhs.cu): G groups of D warps, about
# _RHS_*_WARPS warps. The forward takes one tile of RT rows per block; the
# backward walks tiles of RT rows, at most _RHS_BWD_BLOCKS_PER_SM blocks per
# SM, so that the slabs (one per block) and the pass that adds them stay
# small against one VJP per row. Measured on an H100 at N=3000, Din=D=5
# (the sweep is in PERF.md): 10-warp forward blocks beat 5 and 20;
# one 20-warp backward block per SM beats 5 and 10 warps and 2-4 blocks per
# SM. (dp, rt, maxt) of the instantiated variants, smallest dp first (csrc
# RHS_FWD_VARIANTS, RHS_BWD_VARIANTS); a shape takes the first with
# Din <= dp, and D may be at most maxt / 32.
_RHS_FWD_WARPS = 10
_RHS_FWD_VARIANTS = ((4, 8, 1024), (5, 8, 1024), (8, 8, 1024), (16, 4, 512))
_RHS_BWD_WARPS = 20
_RHS_BWD_BLOCKS_PER_SM = 1
_RHS_BWD_VARIANTS = ((4, 4, 640), (5, 6, 640), (8, 4, 512), (16, 1, 512))
# Segment forward blocks (csrc/rhs_tile.cuh `rhs_tile`): one tile of RT rows
# per block, about _SEG_FWD_WARPS warps, G groups of D. Measured on an H100
# at N=3000, Din=D=5 (PERF.md): 8-row tiles in 10-warp blocks capped at 64
# registers (three resident per SM) beat 4-, 6- and 16-row tiles, 5- and
# 20-warp blocks and the 96-register cap.
_SEG_FWD_WARPS = 10
# (dp, rt, maxt) of the instantiated forward variants by stages, smallest dp
# first, the same for both kernels (csrc DP_FWD_VARIANTS, RK4_FWD_VARIANTS);
# a shape takes the first with Din <= dp.
_SEG_FWD_VARIANTS = dict.fromkeys(
    (6, 4), ((4, 8, 1024), (5, 8, 1024), (8, 4, 384), (16, 4, 512)))
# Segment backward blocks (csrc/rhs_tile.cuh `rhs_vjp_tile`): about
# _SEG_BWD_WARPS warps, G groups of D, over tiles of RT rows; at most
# _SEG_BWD_BLOCKS_PER_SM blocks per SM, so one slab per block stays cheap.
# Measured on an H100 at N=2970, Din=D=5 (the sweep is in PERF.md): two
# resident 10-warp blocks of 12 rows beat one 20-warp block and 8-row blocks.
_SEG_BWD_WARPS = 10
_SEG_BWD_BLOCKS_PER_SM = 2
# (dp, rt, maxt) of the instantiated backward variants by stages, smallest dp
# first. The dopri5 attempt (6) has registers for 6-row tiles at Din = 5,
# the rk4 segment (4) would spill there.
_SEG_BWD_VARIANTS = {
    6: ((4, 4, 640), (5, 6, 640), (8, 4, 512), (16, 1, 512)),
    4: ((4, 4, 640), (5, 4, 640), (8, 4, 512), (16, 1, 512)),
}


def _align4(floats):
    return (floats + 3) & ~3


def _tile_variant(n, din, d, m, s, variants, warps, what):
    """The (dp, rt, maxt) a row-tile kernel takes for this shape from its
    `variants`, and G, the groups of D warps of its block: about `warps`
    warps within the variant's thread bound, at most one group per 32-column
    unit of a dim. Raises ValueError on a shape the kernel does not take."""
    if not 1 <= din <= MAX_DIN or min(n, d, m, s) < 1:
        raise ValueError(f"{what} supports 1 <= Din <= {MAX_DIN} and N, D, M, "
                         f"S >= 1; got N={n}, Din={din}, D={d}, M={m}, S={s}")
    dp, rt, maxt = next(v for v in variants if din <= v[0])
    if 32 * d > maxt:
        raise ValueError(f"{what} takes D <= {maxt // 32} at Din={din} (a "
                         f"warp per dim, {maxt} threads per block); got D={d}")
    units = math.ceil(s / 32) + math.ceil(m / 32)     # 32-column units per dim
    return dp, rt, maxt, max(1, min(units, min(warps, maxt // 32) // d))


def _segment_variant(n, din, d, m, s, stages, variants, warps, what):
    """`_tile_variant` of a segment kernel, which needs Din == D <= 16, from
    its `variants` by stages."""
    if stages not in (4, 6):
        raise ValueError(f"stages must be 4 (rk4) or 6 (dopri5), got {stages}")
    if din != d:
        raise ValueError(f"the segment kernels need Din == D, got {din} and {d}")
    if not 1 <= din <= MAX_DIN or m < 1 or s < 1 or n < 1:
        raise ValueError(f"segment {what} supports 1 <= Din = D <= {MAX_DIN} "
                         f"and N, M, S >= 1; got N={n}, Din={din}, M={m}, S={s}")
    return _tile_variant(n, din, d, m, s, variants[stages], warps,
                         f"segment {what}")


@dataclasses.dataclass(frozen=True)
class TileFwdGeometry:
    """Launch geometry of a row-tile forward kernel (`fused_rhs`: one
    evaluation per row; dopri5 attempt: 7; rk4 segment: 4 per substep): one
    tile per block."""
    dp: int               # the kernel variant's bound of its loops over Din
    rt: int               # rows per tile and block; 2 * rt <= 32, the fold's width
    groups: int           # G: the block is G groups of D warps
    maxt: int             # the variant's thread bound (registers: 65536 / maxt)
    threads: int
    blocks: int
    smem_bytes: int


@dataclasses.dataclass(frozen=True)
class TileBwdGeometry:
    """Launch geometry of a row-tile backward kernel (`fused_rhs`: one VJP
    per row; dopri5 attempt: 6 stages in shared memory; rk4 segment: 4)."""
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


def _fwd_geometry(n, dp, rt, maxt, groups, d, smem, what):
    _check_smem(smem, what)
    return TileFwdGeometry(dp=dp, rt=rt, groups=groups, maxt=maxt,
                           threads=32 * d * groups, blocks=math.ceil(n / rt),
                           smem_bytes=smem)


def _bwd_geometry(n, din, d, m, s, dp, rt, maxt, groups, max_blocks, smem,
                  what):
    """Whole tiles per block, at most `max_blocks` blocks."""
    _check_smem(smem, what)
    rows_per_block = rt * math.ceil(math.ceil(n / rt) / max_blocks)
    blocks = math.ceil(n / rows_per_block)
    return TileBwdGeometry(
        dp=dp, rt=rt, groups=groups, maxt=maxt, threads=32 * d * groups,
        rows_per_block=rows_per_block, blocks=blocks, smem_bytes=smem,
        part_main_floats=blocks * d * _main_slab(din, m, s),
        part_dz_floats=blocks * d * m * din)


def rhs_fwd_geometry(n, din, d, m, s):
    """Geometry of the `fused_rhs` forward for N rows (Din may differ from
    D); raises ValueError on a shape the kernel does not take. Pure
    arithmetic: no device is touched."""
    dp, rt, maxt, groups = _tile_variant(n, din, d, m, s, _RHS_FWD_VARIANTS,
                                         _RHS_FWD_WARPS, "fused_rhs forward")
    # csrc/fused_rhs.cu rhs_fwd_smem_floats: xt (rt, stride) | il (d, dp) |
    # red (warps, 32)
    smem = 4 * (rt * _align4(dp) + _align4(d * dp) + 32 * d * groups)
    return _fwd_geometry(n, dp, rt, maxt, groups, d, smem, "fused_rhs forward")


def rhs_bwd_geometry(n, din, d, m, s, sms):
    """Geometry of the `fused_rhs` backward for N rows on a card of `sms`
    multiprocessors (Din may differ from D); raises ValueError on a shape the
    kernel does not take. Pure arithmetic: no device is touched."""
    dp, rt, maxt, groups = _tile_variant(n, din, d, m, s, _RHS_BWD_VARIANTS,
                                         _RHS_BWD_WARPS, "fused_rhs backward")
    warps = d * groups
    # csrc/fused_rhs.cu rhs_bwd_smem_floats: xt (rt, stride) | gt (rt, d) |
    # il (d, dp) | accumulators | dls (warps, dp, 32) | dxw (warps, 32)
    smem = 4 * (rt * _align4(dp) + _align4(rt * d) + _align4(d * dp)
                + _align4(d * _acc_floats(din, m, s)) + 32 * dp * warps
                + 32 * warps)
    return _bwd_geometry(n, din, d, m, s, dp, rt, maxt, groups,
                         _RHS_BWD_BLOCKS_PER_SM * sms, smem,
                         "fused_rhs backward")


def segment_fwd_geometry(n, din, d, m, s, stages):
    """Geometry of the dopri5-attempt (`stages=6`, the stage inputs it saves)
    or rk4-segment (`stages=4`) forward for N rows; raises ValueError on a
    shape the kernels do not take. Pure arithmetic: no device is touched."""
    dp, rt, maxt, groups = _segment_variant(
        n, din, d, m, s, stages, _SEG_FWD_VARIANTS, _SEG_FWD_WARPS, "forward")
    warps = d * groups
    # csrc/rhs_tile.cuh FwdSmem: xb, xi (rt, stride) | stage derivatives
    # (7 or 4 planes of rt * dp) | il (dp, dp) | red (warps, 32)
    derivs = 7 if stages == 6 else 4
    smem = 4 * (2 * rt * _align4(dp) + derivs * _align4(rt * dp) + dp * dp
                + 32 * warps)
    return _fwd_geometry(n, dp, rt, maxt, groups, d, smem, "segment forward")


def segment_bwd_geometry(n, din, d, m, s, stages, sms):
    """Geometry of the dopri5-attempt (`stages=6`) or rk4-segment
    (`stages=4`) backward for N rows on a card of `sms` multiprocessors;
    raises ValueError on a shape the kernels do not take. Pure arithmetic:
    no device is touched."""
    dp, rt, maxt, groups = _segment_variant(
        n, din, d, m, s, stages, _SEG_BWD_VARIANTS, _SEG_BWD_WARPS, "backward")
    warps = d * groups
    # csrc/rhs_tile.cuh TileSmem: xt (stages, rt, stride) | planes of rt * dp
    # floats (dopri5: gk x 6, gxt; rk4: gx x 4, gt, cot) | il (dp, dp) |
    # accumulators | dls (warps, dp, 32) | dxw (warps, 32)
    planes = 7 if stages == 6 else 6
    smem = 4 * (stages * rt * _align4(dp) + planes * _align4(rt * dp) + dp * dp
                + _align4(d * _acc_floats(din, m, s)) + 32 * dp * warps
                + 32 * warps)
    return _bwd_geometry(n, din, d, m, s, dp, rt, maxt, groups,
                         _SEG_BWD_BLOCKS_PER_SM * sms, smem, "segment backward")


# `dopri5_attempt_draws` blocks (csrc/dopri5_draws.cu): one tile of RT rows
# of one draw per block, G groups of D warps, about _DRAWS_WARPS warps. A
# stage's latency is its warps' column units walked one after another, so
# the block takes as many warps as its variant allows. Measured on an H100
# at 32 draws x 2 rows, D=5, M=100, S=256: 30 warps 0.0331 ms, 20 0.0333,
# 10 0.0398, 5 0.0557. (dp, rt, maxt) of the instantiated variants, smallest
# dp first (csrc DRAWS_VARIANTS): the segment forward's; a shape takes the
# first with Din <= dp.
_DRAWS_WARPS = 32
_DRAWS_VARIANTS = _SEG_FWD_VARIANTS[6]
# grid limit: the draws' tiles are one flat grid
_MAX_BLOCKS = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class DrawsAttemptGeometry:
    """Launch geometry of `dopri5_attempt_draws`: `tiles` blocks of `rt`
    rows per draw, draw-major, and one reduction block."""
    dp: int               # the kernel variant's bound of its loops over Din
    rt: int               # rows per tile and block
    groups: int           # G: the block is G groups of D warps
    maxt: int             # the variant's thread bound
    threads: int
    tiles: int            # blocks per draw
    blocks: int           # draws * tiles
    smem_bytes: int


def draws_attempt_geometry(draws, n, din, d, m, s):
    """Geometry of `dopri5_attempt_draws` for `draws` draws of N rows each;
    raises ValueError on a shape the kernel does not take (Din != D, Din
    past 16, more blocks than a grid holds, a block past the shared-memory
    limit). Pure arithmetic: no device is touched."""
    what = "dopri5_attempt_draws"
    if din != d:
        raise ValueError(f"{what} needs Din == D, got {din} and {d}")
    if draws < 1:
        raise ValueError(f"{what} needs at least one draw, got {draws}")
    dp, rt, maxt, groups = _tile_variant(n, din, d, m, s, _DRAWS_VARIANTS,
                                         _DRAWS_WARPS, what)
    tiles = math.ceil(n / rt)
    if draws * tiles > _MAX_BLOCKS:
        raise ValueError(f"{what} takes at most {_MAX_BLOCKS} tiles of {rt} "
                         f"rows; got {draws} draws x {tiles}")
    warps = d * groups
    # csrc FwdSmem<DP, RT, 7> and sq: xb, xi (rt, stride) | k1..k7 (7 planes
    # of rt * dp) | il (dp, dp) | red (warps, 32) | sq (rt * dp)
    smem = 4 * (2 * rt * _align4(dp) + 7 * _align4(rt * dp) + dp * dp
                + 32 * warps + _align4(rt * dp))
    _check_smem(smem, what)
    return DrawsAttemptGeometry(dp=dp, rt=rt, groups=groups, maxt=maxt,
                                threads=32 * warps, tiles=tiles,
                                blocks=draws * tiles, smem_bytes=smem)


# the kernels that `kernel_refusal` asks, and the stages of the segment ones
KERNEL_STAGES = {"fused_rhs": None, "rk4_segment": 4, "dopri5_attempt": 6}


def kernel_refusal(kernel, n, din, d, m, s, draws=1):
    """Why `kernel` (a key of KERNEL_STAGES, or "dopri5_attempt_draws" for
    `draws` draws of N rows) would refuse N rows of this shape in either
    direction — its forward's or its backward's geometry's ValueError
    message — or None when both take them (the forward-only draws attempt:
    its one geometry). Pure arithmetic; one multiprocessor stands in for the
    card, since the SM count sets only the backward's rows per block, never
    whether a shape is taken."""
    try:
        if kernel == "dopri5_attempt_draws":
            draws_attempt_geometry(draws, n, din, d, m, s)
            return None
        stages = KERNEL_STAGES[kernel]
        if stages is None:
            rhs_fwd_geometry(n, din, d, m, s)
            rhs_bwd_geometry(n, din, d, m, s, 1)
        else:
            segment_fwd_geometry(n, din, d, m, s, stages)
            segment_bwd_geometry(n, din, d, m, s, stages, 1)
    except ValueError as exc:
        return str(exc)
    return None


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


def _bwd_buffers(geo, n, din, d, m, s, dev):
    """dx and the scratch of a row-tile backward at geometry `geo`: one slab
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


def _will_backward(*tensors):
    """Will autograd take a VJP of this call (grad mode on and an operand
    that requires grad)? Then the backward's geometry is asked before the
    forward launches."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def first_order_only(backward):
    """Mark an autograd rule first order: a backward taken with
    `create_graph` (grad mode on inside the backward) raises at once.
    `torch.autograd.function.once_differentiable` raises only when the
    incoming cotangent itself needs a gradient; under unit cotangents (a
    Newton Jacobian's) it would let the kernel's cotangents enter the
    second derivative as constants, silently wrong. Past this check grad
    mode is off, where `once_differentiable` adds nothing."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "a double backward through a kernel: its autograd rule is "
                "first order only (take the plain path, kernels=False)")
        return backward(ctx, *grads)

    return wrapper


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
    geo = rhs_fwd_geometry(n, din, d, m, s)
    lib = _lib("fused_rhs")
    LAUNCHES["fused_rhs_fwd"] += 1
    rc = lib.gpode_fused_rhs_fwd(
        _ptr(x), *map(_ptr, ops), _ptr(out), n, din, d, m, s, geo.dp, geo.rt,
        geo.groups, geo.maxt, _stream(dev))
    _raise_on(rc, "fused_rhs forward")
    return out


def _launch_rhs_bwd_packed(x, g, ops, din, d, m, s):
    """The backward kernel and its fixed-order reduction: (dx, out_main
    (D, main_slab), out_dz (M*Din)), the parameter cotangents still packed."""
    dev = x.device
    n = x.shape[0]
    geo = rhs_bwd_geometry(n, din, d, m, s, _sms(dev))
    dx, part_main, part_dz, out_main, out_dz = _bwd_buffers(geo, n, din, d, m,
                                                            s, dev)
    lib = _lib("fused_rhs")
    LAUNCHES["fused_rhs_bwd"] += 1
    rc = lib.gpode_fused_rhs_bwd(
        _ptr(x), _ptr(g), *map(_ptr, ops), _ptr(dx), _ptr(part_main),
        _ptr(part_dz), _ptr(out_main), _ptr(out_dz), n, din, d, m, s,
        geo.rows_per_block, geo.dp, geo.rt, geo.groups, geo.maxt, _stream(dev))
    _raise_on(rc, "fused_rhs backward")
    return dx, out_main, out_dz


def _launch_rhs_bwd(x, g, ops, din, d, m, s):
    dx, out_main, out_dz = _launch_rhs_bwd_packed(x, g, ops, din, d, m, s)
    return (dx,) + _unpack_param_cotangents(out_main, out_dz, din, d, m, s)


class _FusedRhsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, z, lengthscales, variance, omega, phase, weights, nu,
                will_backward):
        dims = _check(x, z, lengthscales, variance, omega, phase, weights, nu)
        if will_backward and x.shape[0]:
            rhs_bwd_geometry(x.shape[0], *dims, _sms(x.device))
        ops = _kernel_operands(z, lengthscales, variance, omega, phase,
                               weights, nu)
        ctx.save_for_backward(x, *ops)
        ctx.dims = dims
        return _launch_rhs_fwd(x, ops, *dims)

    @staticmethod
    @first_order_only
    def backward(ctx, g):
        x, *ops = ctx.saved_tensors
        if x.shape[0] == 0:
            return (None,) * 9
        return _launch_rhs_bwd(x, g.contiguous(), ops, *ctx.dims) + (None,)


def fused_rhs(x, z, lengthscales, variance, omega, phase, weights, nu):
    """Fused dimwise ODE right-hand side: (N, Din) -> (N, D).

    Differentiable in every operand; on CUDA both directions are kernels,
    and a shape that the backward would refuse raises before the forward
    launches when a gradient will be taken.
    """
    if x.device.type == "cpu":
        return fused_rhs_plain(x, z, lengthscales, variance, omega, phase,
                               weights, nu)
    operands = (x, z, lengthscales, variance, omega, phase, weights, nu)
    return _FusedRhsFn.apply(*operands, _will_backward(*operands))


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
    geo = segment_fwd_geometry(n, din, d, m, s, 6)
    lib = _lib("fused_dopri5")
    LAUNCHES["fused_dopri5_attempt_fwd"] += 1
    rc = lib.gpode_dp_attempt_fwd(
        _ptr(x0), _ptr(dt), _ptr(_dp_coefficients(dev)),
        ctypes.c_float(rtol), ctypes.c_float(atol), *map(_ptr, ops),
        _ptr(x5), _ptr(err), _ptr(xs), n, din, d, m, s, geo.dp, geo.rt,
        geo.groups, geo.maxt, _stream(dev))
    _raise_on(rc, "fused_dopri5_attempt forward")
    return x5, err, xs


def _launch_dp_bwd(xs, g, dt, ops, din, d, m, s):
    dev = xs.device
    n = xs.shape[1]
    geo = segment_bwd_geometry(n, din, d, m, s, 6, _sms(dev))
    dx, part_main, part_dz, out_main, out_dz = _bwd_buffers(
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
                nu, rtol, atol, will_backward):
        dims, dt = _check_segment(x0, dt, z, lengthscales, variance, omega,
                                  phase, weights, nu, "the dopri5 attempt")
        if will_backward and x0.shape[0]:
            segment_bwd_geometry(x0.shape[0], *dims, 6, _sms(x0.device))
        ops = _kernel_operands(z, lengthscales, variance, omega, phase,
                               weights, nu)
        x5, err, xs = _launch_dp_fwd(x0, dt, float(rtol), float(atol), ops,
                                     *dims)
        ctx.save_for_backward(xs, dt, *ops)
        ctx.dims = dims
        ctx.mark_non_differentiable(err)
        return x5, err

    @staticmethod
    @first_order_only
    def backward(ctx, g_x5, _g_err):
        xs, dt, *ops = ctx.saved_tensors
        if g_x5 is None or xs.shape[1] == 0:
            return (None,) * 12
        grads = _launch_dp_bwd(xs, g_x5.contiguous(), dt, ops, *ctx.dims)
        return (grads[0], None) + grads[1:] + (None, None, None)


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
    return _FusedDopri5AttemptFn.apply(
        x0, dt, z, lengthscales, variance, omega, phase, weights, nu, rtol,
        atol, _will_backward(x0, z, lengthscales, variance, omega, phase,
                             weights, nu))


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
    geo = segment_fwd_geometry(n, din, d, m, s, 4)
    lib = _lib("fused_rk4")
    LAUNCHES["fused_rk4_segment_fwd"] += 1
    rc = lib.gpode_rk4_fwd(
        _ptr(x0), _ptr(dt), *map(_ptr, ops), _ptr(x1), _ptr(xs), n, din, d,
        m, s, substeps, geo.dp, geo.rt, geo.groups, geo.maxt, _stream(dev))
    _raise_on(rc, "fused_rk4_segment forward")
    return x1, xs


def _launch_rk4_bwd(xs, g, dt, substeps, ops, din, d, m, s):
    dev = xs.device
    n = xs.shape[1]
    geo = segment_bwd_geometry(n, din, d, m, s, 4, _sms(dev))
    dx, part_main, part_dz, out_main, out_dz = _bwd_buffers(
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
                nu, substeps, will_backward):
        dims, dt = _check_segment(x0, dt, z, lengthscales, variance, omega,
                                  phase, weights, nu, "the rk4 segment")
        if will_backward and x0.shape[0]:
            segment_bwd_geometry(x0.shape[0], *dims, 4, _sms(x0.device))
        ops = _kernel_operands(z, lengthscales, variance, omega, phase,
                               weights, nu)
        x1, xs = _launch_rk4_fwd(x0, dt, substeps, ops, *dims)
        ctx.save_for_backward(xs, dt, *ops)
        ctx.dims, ctx.substeps = dims, substeps
        return x1

    @staticmethod
    @first_order_only
    def backward(ctx, g):
        xs, dt, *ops = ctx.saved_tensors
        if xs.shape[1] == 0:
            return (None,) * 11
        grads = _launch_rk4_bwd(xs, g.contiguous(), dt, ctx.substeps, ops,
                                *ctx.dims)
        return (grads[0], None) + grads[1:] + (None, None)


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
    return _FusedRk4SegmentFn.apply(
        x0, dt, z, lengthscales, variance, omega, phase, weights, nu, substeps,
        _will_backward(x0, z, lengthscales, variance, omega, phase, weights,
                       nu))


# ---------------------------------------------------------------------------
# dopri5_attempt_draws
# ---------------------------------------------------------------------------

def _draws_layout(omega, phase, weights, nu):
    """The draws' leaves in the kernel's D-major layout, as contiguous
    tensors: omega (S, D, Din, Sf), phase and weights (S, D, Sf), nu
    (S, D, M). Leaves kept in that memory order (`kernel_order_draws`)
    come back as they are, with no copy."""
    return (omega.permute(0, 3, 1, 2).contiguous(),
            phase[:, 0].transpose(1, 2).contiguous(),
            weights.transpose(1, 2).contiguous(), nu.contiguous())


def kernel_order_draws(omega, phase, weights, nu):
    """Copies of a draw batch's leaves in their own shapes, stored in the
    memory order of the kernel's layout, so that `dopri5_attempt_draws`
    reads them where they are (a captured attempt's static draws)."""
    s, din, sf, d = omega.shape
    out = (omega.new_empty(s, d, din, sf).permute(0, 2, 3, 1),
           phase.new_empty(s, d, sf).transpose(1, 2)[:, None],
           weights.new_empty(s, d, sf).transpose(1, 2),
           nu.new_empty(nu.shape))
    for static, leaf in zip(out, (omega, phase, weights, nu)):
        static.copy_(leaf)
    return out


def _check_draws(x, k1, dt, z, lengthscales, variance, omega, phase, weights,
                 nu):
    """Operand checks of `dopri5_attempt_draws` on the card: float32 on the
    device of x, x and k1 contiguous (S, N, D), the draws' leaves with the
    leading draw axis S, a one-element dt; returns (draws, N, Din, D, M, S
    features) and dt as a one-element vector."""
    tensors = dict(x=x, k1=k1, z=z, lengthscales=lengthscales,
                   variance=variance, omega=omega, phase=phase,
                   weights=weights, nu=nu)
    dev = x.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (S, N, D) tensor, got shape "
                         f"{tuple(x.shape)}")
    if k1.shape != x.shape or not k1.is_contiguous():
        raise ValueError(f"k1 must be a contiguous tensor of x's shape "
                         f"{tuple(x.shape)}, got {tuple(k1.shape)}")
    draws, n, din = x.shape
    d, m = nu.shape[-2:]
    sf = weights.shape[-2]
    expect = dict(z=(m, din), lengthscales=(d, din), variance=(d,),
                  omega=(draws, din, sf, d), phase=(draws, 1, sf, d),
                  weights=(draws, sf, d), nu=(draws, d, m))
    for name, shape in expect.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    return (draws, n, din, d, m, sf), _check_dt(dt, dev)


def _launch_draws_attempt(x, k1, dt, direction, rtol, atol, shared, leaves,
                          dims):
    dev = x.device
    geo = draws_attempt_geometry(*dims)    # raises before any launch
    draws, n, din, d, m, s = dims
    f32 = dict(dtype=torch.float32, device=dev)
    x_new, k7 = torch.empty_like(x), torch.empty_like(x)
    part, ratio = torch.empty(geo.blocks, **f32), torch.empty((), **f32)
    lib = _lib("dopri5_draws")
    LAUNCHES["dopri5_attempt_draws"] += 1
    DRAWS_ATTEMPT_SHAPES.add(tuple(dims))
    rc = lib.gpode_dp_draws_attempt(
        _ptr(x), _ptr(k1), _ptr(dt), _ptr(_dp_coefficients(dev)),
        ctypes.c_float(direction), ctypes.c_float(rtol), ctypes.c_float(atol),
        *map(_ptr, shared), *map(_ptr, leaves), _ptr(x_new), _ptr(k7),
        _ptr(part), _ptr(ratio), draws, n, din, d, m, s, geo.dp, geo.rt,
        geo.groups, geo.maxt, _stream(dev))
    _raise_on(rc, "dopri5_attempt_draws")
    return x_new, ratio, k7


def dopri5_attempt_draws(x, k1, dt, direction, z, lengthscales, variance,
                         omega, phase, weights, nu, rtol=1e-6, atol=1e-6):
    """One adaptive dopri5 attempt of S field draws from x (S, N, D) with
    its FSAL k1 (S, N, D) over the step dt (a 0-d or one-element tensor,
    read on the device), on the field `direction` (+1 or -1) times the
    draws' field: z (M, Din), lengthscales (D, Din) and variance (D,)
    constrained, shared; omega (S, Din, Sf, D), phase (S, 1, Sf, D), the
    kernels' RFF weights (S, Sf, D) (`gp.kernel_rff_weights`) and nu
    (S, D, M) per draw. Returns (x_new, ratio, k7) as
    :func:`dopri5_attempt_draws_plain` does.

    Forward only: with grad mode on and an operand that requires grad it
    raises. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one launch and its fixed-order reduction) or raises."""
    require_no_grad("dopri5_attempt_draws", x, k1, z, lengthscales, variance,
                    omega, phase, weights, nu)
    if x.device.type == "cpu":
        return dopri5_attempt_draws_plain(x, k1, dt, direction, z,
                                          lengthscales, variance, omega,
                                          phase, weights, nu, rtol, atol)
    if direction not in (1.0, -1.0):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    dims, dt = _check_draws(x, k1, dt, z, lengthscales, variance, omega, phase,
                            weights, nu)
    with torch.no_grad():
        return _launch_draws_attempt(
            x, k1, dt, float(direction), float(rtol), float(atol),
            (z.contiguous(), lengthscales.contiguous(), variance.contiguous()),
            _draws_layout(omega, phase, weights, nu), dims)


def _check_commit(ratio, scalars, taus, out, x, k1, x_new, k7):
    """Operand checks of `draws_commit` on the card: float32 on one device,
    contiguous; x, k1, x_new, k7 of one shape, out (T, *x.shape), taus (T,),
    ratio one element, scalars three."""
    tensors = dict(ratio=ratio, scalars=scalars, taus=taus, out=out, x=x,
                   k1=k1, x_new=x_new, k7=k7)
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    points, n = taus.numel(), x.numel()
    if (ratio.numel() != 1 or scalars.numel() != 3 or taus.ndim != 1
            or tuple(out.shape) != (points, *x.shape)
            or any(t.shape != x.shape for t in (k1, x_new, k7))):
        raise ValueError(
            f"draws_commit: ratio {tuple(ratio.shape)}, scalars "
            f"{tuple(scalars.shape)}, taus {tuple(taus.shape)}, out "
            f"{tuple(out.shape)}, x {tuple(x.shape)}, k1 {tuple(k1.shape)}, "
            f"x_new {tuple(x_new.shape)}, k7 {tuple(k7.shape)}: expected one "
            f"ratio, three scalars, T times, out (T, *x.shape) and the states "
            f"of x's shape")
    if n >= 2 ** 31:
        raise ValueError(f"draws_commit takes fewer than 2**31 elements, got "
                         f"{n}")
    return points, n


def draws_commit(ratio, scalars, taus, out, x, k1, x_new, k7):
    """An accepted attempt's commit, in place: where the 0-d `ratio` of
    the attempt (x_new, ratio, k7) from (x, k1) accepts (<= 1), each output
    time tau < taus[j] <= tau_end gets the cubic Hermite point into out[j]
    (T, *x.shape), then x <- x_new and k1 <- k7; a reject or a NaN ratio
    changes nothing. `scalars` is [dt, tau, tau_end] and `taus` (T,),
    float32 on the device: both, like the ratio, are read there, so a
    captured graph sees each new value.

    Bit for bit :func:`draws_commit_plain`, which is `odeint_dopri5`'s host
    dense output (`ops/ode._hermite`) and hand-over. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (one launch on the
    current stream, counted in `LAUNCHES`) or raises."""
    if x.device.type == "cpu":
        return draws_commit_plain(ratio, scalars, taus, out, x, k1, x_new, k7)
    points, n = _check_commit(ratio, scalars, taus, out, x, k1, x_new, k7)
    LAUNCHES["draws_commit"] += 1
    rc = _lib("dopri5_draws").gpode_dp_draws_commit(
        *map(_ptr, (ratio, scalars, taus, out, x, k1, x_new, k7)), points, n,
        _stream(x.device))
    _raise_on(rc, "draws_commit")


# ---------------------------------------------------------------------------
# draw_solve
# ---------------------------------------------------------------------------

def draw_solve_fwd_plain(k3, u, v, jitter=om.DEFAULT_JITTER):
    """(L, a, nu) of the forward kernels as tensor ops, in their tile order
    (both layouts): the factor augmented with the rows u^T, factored
    right-looking by panels of 32 columns (the diagonal block's Cholesky,
    the rows below it against it, then the trailing lower part less the
    panel's product), so that the augmented rows end as a = L^{-1} u; then
    nu = L^{-T}(v - a). K (B, M, M) (its lower triangle is read), u and v
    (B, R, M)."""
    m = k3.shape[-1]
    eye = torch.eye(m, dtype=k3.dtype, device=k3.device)
    A = torch.cat([torch.tril(k3) + jitter * eye, u], dim=1)    # (B, M + R, M)
    for c0 in range(0, m, _DRAW_SOLVE_PANEL):
        c1 = min(c0 + _DRAW_SOLVE_PANEL, m)
        d = torch.linalg.cholesky(A[:, c0:c1, c0:c1])
        A[:, c0:c1, c0:c1] = d
        A[:, c1:, c0:c1] = torch.linalg.solve_triangular(
            d.mT, A[:, c1:, c0:c1], upper=True, left=False)
        A[:, c1:, c1:] -= A[:, c1:, c0:c1] @ A[:, c1:m, c0:c1].mT
    L, a = torch.tril(A[:, :m]), A[:, m:]
    nu = om.solve_upper_from_lower(L, (v - a).mT).mT
    return L, a, nu


def draw_solve_bwd_plain(L, a, v, g_nu, slab=None):
    """The VJP that the backward kernels compute, as tensor ops, in the
    kernels' layout: L (B, M, M) the factor, a = L^{-1} u, v and the
    cotangent g_nu (B, R, M). Returns (g_K (B, M, M), g_u, g_v (B, R, M)):

        g_c = L^{-1} g_nu,  g_v = g_c,  g_u = -L^{-T} g_c,
        P = tril(g_c a^T - c g_c^T),  c = v - a,
        g_K = sym(L^{-T} (P + tril(P, -1)^T) / 2 L^{-1}).

    P is tril(L^T g_L) for the two solves' cotangent of L, g_L =
    tril(-nu g_c^T + L^{-T} g_c a^T), since L^T nu = c; g_K is then the
    Cholesky's VJP as `torch.linalg.cholesky`'s backward forms it.

    `slab` (the packed backward's): [W | h] = L^{-T} [Phi | g_c] by slabs
    of `slab` columns into a work matrix W, then Y = W L^{-1} by slabs of
    `slab` rows, as its launches take them."""
    gc = om.solve_lower(L, g_nu.mT)                              # (B, M, R)
    c = (v - a).mT
    p = torch.tril(gc @ a - c @ gc.mT)
    phi = 0.5 * (p + torch.tril(p, -1).mT)
    if slab is None:
        gu = -om.solve_upper_from_lower(L, gc)
        w = om.solve_upper_from_lower(L, phi)
        y = torch.linalg.solve_triangular(L, w, upper=False, left=False)
        return 0.5 * (y + y.mT), gu.mT, gc.mT
    m = L.shape[-1]
    rhs = torch.cat([phi, gc], dim=-1)                           # (B, M, M + R)
    wh = torch.cat([om.solve_upper_from_lower(L, rhs[..., q:q + slab])
                    for q in range(0, rhs.shape[-1], slab)], dim=-1)
    w, gu = wh[..., :m], -wh[..., m:]
    y = torch.cat([torch.linalg.solve_triangular(L, w[:, q:q + slab],
                                                 upper=False, left=False)
                   for q in range(0, m, slab)], dim=1)
    return 0.5 * (y + y.mT), gu.mT, gc.mT


# Kernel limits (csrc/draw_solve.cu): a substitution's lane holds the rows
# lane + 32 s of its columns. Up to M = DRAW_SOLVE_SQUARE_MAX_M the factor
# is a square in one block's shared memory both ways (s < _DRAW_SOLVE_MAX_ROWS);
# past it, up to DRAW_SOLVE_MAX_M, the packed lower triangle (s <
# _DRAW_SOLVE_PACKED_ROWS): the forward in one block, the backward in three
# launches, slabs of _DRAW_SOLVE_SLAB_COLS columns, its work matrix W in
# global memory. Each block's factor, its columns and work tile lie in its
# shared memory. The forward factors by panels of _DRAW_SOLVE_PANEL columns,
# on the packed layout with a copy of each panel, rows
# _DRAW_SOLVE_PANEL_STRIDE floats apart.
_DRAW_SOLVE_MAX_ROWS = 4
_DRAW_SOLVE_PACKED_ROWS = 8
_DRAW_SOLVE_SLAB_COLS = 32
_DRAW_SOLVE_PANEL = 32
_DRAW_SOLVE_PANEL_STRIDE = 36
DRAW_SOLVE_SQUARE_MAX_M = 32 * _DRAW_SOLVE_MAX_ROWS
DRAW_SOLVE_MAX_M = 32 * _DRAW_SOLVE_PACKED_ROWS


@dataclasses.dataclass(frozen=True)
class DrawSolveGeometry:
    layout: str               # "square" (M <= 128) or "packed"
    fwd_smem_bytes: int
    bwd_smem_bytes: int       # the one-block backward's; packed: its largest


def draw_solve_geometry(b, m, r):
    """The `draw_solve` kernels' layout and shared memory for B factors of
    M x M with R right-hand columns each; ValueError on a shape they do not
    take. M <= 128: the square
    layout, 4 ((M + R)(M | 1) + M) bytes forward and 4 (2 M (M | 1) + 3 R M
    + M) backward, one block a factor. 128 < M <= 256: the packed triangle,
    forward 4 (M (M + 1) / 2 + R (M | 1) + M, rounded up to 4, + 36 (M + R))
    (the panel's copy last) and 4 (M (M + 1) / 2 + 3 R M + M) in the
    backward's column slabs: R <= 32 at M=256 (the columns kernel's a, c
    and g_c). Pure arithmetic (the C launchers lay it out so)."""
    if b < 1 or m < 1 or r < 1:
        raise ValueError(f"draw_solve takes B, M, R >= 1, got B={b}, M={m}, "
                         f"R={r}")
    if m > DRAW_SOLVE_MAX_M:
        raise ValueError(f"draw_solve takes M <= {DRAW_SOLVE_MAX_M} (a lane's "
                         f"{_DRAW_SOLVE_PACKED_ROWS} row slots of 32), got M={m}")
    ld = m | 1
    if m <= DRAW_SOLVE_SQUARE_MAX_M:
        fwd = 4 * ((m + r) * ld + m)
        bwd = 4 * (2 * m * ld + 3 * r * m + m)
        _check_smem(max(fwd, bwd), f"draw_solve at M={m}, R={r}")
        return DrawSolveGeometry("square", fwd, bwd)
    tri = m * (m + 1) // 2
    fwd = 4 * (-(-(tri + r * ld + m) // 4) * 4 + (m + r) * _DRAW_SOLVE_PANEL_STRIDE)
    bwd = 4 * (tri + 3 * r * m + m)
    _check_smem(max(fwd, bwd), f"draw_solve (packed) at M={m}, R={r}")
    return DrawSolveGeometry("packed", fwd, bwd)


def _draw_solve_dims(kzz, u_prior):
    """(B factors, M, R columns a factor) of a draw on kzz: (D, M, M), dim
    d's column of each draw on factor d, or (M, M), every draw's D columns
    on one factor."""
    m, d = u_prior.shape[-2:]
    draws = math.prod(u_prior.shape[:-2])
    if kzz.ndim == 3:
        return kzz.shape[0], m, draws
    return 1, m, draws * d


def draw_solve_refusal(kzz, u_prior):
    """Why the `draw_solve` kernels would not take a draw on kzz with prior
    values u_prior (..., M, D) — a dtype other than float32, or the
    ValueError of :func:`draw_solve_geometry` — or None when they take it."""
    for t in (kzz, u_prior):
        if t.dtype != torch.float32:
            return f"{t.dtype}: the kernels take float32"
    try:
        draw_solve_geometry(*_draw_solve_dims(kzz, u_prior))
    except ValueError as e:
        return str(e)
    return None


def _to_columns(kzz, t):
    """(..., M, D) -> the kernels' (B, R, M), contiguous."""
    m, d = t.shape[-2:]
    cols = t.reshape(-1, m, d).mT                                 # (S, D, M)
    if kzz.ndim == 3:
        return cols.transpose(0, 1).contiguous()                  # (D, S, M)
    return cols.reshape(1, -1, m).contiguous()                    # (1, S D, M)


def _from_columns(kzz, nu, lead, d):
    """The kernels' (B, R, M) -> (*lead, D, M)."""
    if kzz.ndim == 3:
        nu = nu.transpose(0, 1)
    return nu.reshape(*lead, d, nu.shape[-1])


def _check_draw_solve(kzz, u_prior, v):
    """Operand checks of `draw_solve`: float32 on one card, u_prior and v
    (..., M, D) of one shape, kzz (D, M, M) or (M, M), and a shape the
    kernels take."""
    if kzz.device.type != "cuda":
        raise ValueError(f"draw_solve runs on a card, got kzz on {kzz.device}"
                         f" (the CPU path is `gp.draw_solve_plain`)")
    for name, t in dict(u_prior=u_prior, v=v).items():
        if t.device != kzz.device:
            raise ValueError(f"{name} is on {t.device}, kzz on {kzz.device}")
        if t.dtype != torch.float32 or kzz.dtype != torch.float32:
            raise TypeError(f"draw_solve takes float32, got kzz {kzz.dtype}, "
                            f"{name} {t.dtype}")
    if u_prior.ndim < 2 or v.shape != u_prior.shape:
        raise ValueError(f"u_prior and v must be (..., M, D) of one shape, got "
                         f"{tuple(u_prior.shape)} and {tuple(v.shape)}")
    m, d = u_prior.shape[-2:]
    if tuple(kzz.shape) not in ((d, m, m), (m, m)):
        raise ValueError(f"kzz must be ({d}, {m}, {m}) or ({m}, {m}), got "
                         f"{tuple(kzz.shape)}")
    draw_solve_geometry(*_draw_solve_dims(kzz, u_prior))


def _draw_solve_fwd(k3, u, v, jitter):
    """(L, a, nu) of the forward kernel, in the kernels' layout."""
    b, m, _ = k3.shape
    L = torch.empty_like(k3)
    a, nu = torch.empty_like(u), torch.empty_like(u)
    LAUNCHES["draw_solve_fwd" if m <= DRAW_SOLVE_SQUARE_MAX_M
             else "draw_solve_fwd_packed"] += 1
    DRAW_SOLVE_SHAPES.add((b, m, u.shape[1]))
    rc = _lib("draw_solve").gpode_draw_solve_fwd(
        _ptr(k3), _ptr(u), _ptr(v), ctypes.c_float(jitter), _ptr(L), _ptr(a),
        _ptr(nu), b, m, u.shape[1], _stream(k3.device))
    _raise_on(rc, "draw_solve forward")
    return L, a, nu


def _draw_solve_bwd(L, a, v, g_nu):
    """(g_K, g_u, g_v) of the backward kernel(s), in the kernels' layout:
    one launch on the square layout, three on the packed one."""
    b, m, _ = L.shape
    g_nu = g_nu.contiguous()
    g_k = torch.empty_like(L)
    g_u, g_v = torch.empty_like(a), torch.empty_like(a)
    lib, stream = _lib("draw_solve"), _stream(L.device)
    if m <= DRAW_SOLVE_SQUARE_MAX_M:
        LAUNCHES["draw_solve_bwd"] += 1
        rc = lib.gpode_draw_solve_bwd(*map(_ptr, (L, a, v, g_nu, g_k, g_u, g_v)),
                                      b, m, a.shape[1], stream)
    else:
        LAUNCHES["draw_solve_bwd_slabs"] += 1
        work = torch.empty_like(L)
        rc = lib.gpode_draw_solve_bwd_slabs(
            *map(_ptr, (L, a, v, g_nu, work, g_k, g_u, g_v)), b, m, a.shape[1],
            stream)
    _raise_on(rc, "draw_solve backward")
    return g_k, g_u, g_v


class _DrawSolveFn(torch.autograd.Function):
    """nu (B, R, M) of K (B, M, M), u and v (B, R, M) on the card,
    differentiable in all three: both kernels."""

    @staticmethod
    def forward(ctx, k3, u, v, jitter):
        L, a, nu = _draw_solve_fwd(k3, u, v, jitter)
        ctx.save_for_backward(L, a, v)
        return nu

    @staticmethod
    @first_order_only
    def backward(ctx, g_nu):
        return _draw_solve_bwd(*ctx.saved_tensors, g_nu) + (None,)


def draw_solve(kzz, u_prior, v, jitter=om.DEFAULT_JITTER):
    """A draw's update coefficients on its own factor of kzz = K(Z, Z):
    nu = L^{-T}(v - L^{-1} u_prior), L = chol(kzz + jitter I), for kzz
    (D, M, M) (dimwise: factor d takes dim d's column of every draw) or
    (M, M) (shared: one factor takes all of them) and u_prior, v
    (..., M, D) with any leading draw axes; returns nu (..., D, M),
    differentiable in kzz, u_prior and v.

    It launches the forward kernel and, for a gradient, the backward (on
    the current stream, counted in `LAUNCHES`: `draw_solve_fwd` and
    `draw_solve_bwd` at M <= 128, `draw_solve_fwd_packed` and the three
    launches of `draw_solve_bwd_slabs` past it; the shape recorded in
    `DRAW_SOLVE_SHAPES`), or
    raises on operands the kernels do not take (`draw_solve_refusal`; CPU
    tensors: the library chain, `gp.draw_solve_plain`, is their path). A
    non-positive pivot gives non-finite entries, as `cholesky_ex` does."""
    _check_draw_solve(kzz, u_prior, v)
    k3 = (kzz if kzz.ndim == 3 else kzz[None]).contiguous()
    nu = _DrawSolveFn.apply(k3, _to_columns(kzz, u_prior), _to_columns(kzz, v),
                            float(jitter))
    return _from_columns(kzz, nu, u_prior.shape[:-2], u_prior.shape[-1])


# ---------------------------------------------------------------------------
# state_entropy
# ---------------------------------------------------------------------------

def _cholesky_adjoint(a, g):
    """The cotangent of a's lower triangle under H = 0.5 (const + 2 sum_j
    log c_jj), c = `om.cholesky_small(a)`, for H's cotangent g, as autograd
    forms it through that chain: its nodes in reverse order of creation,
    each intermediate's cotangent summed in that order (a tensor's consumers
    latest first, the stack's zero or g / c_jj first)."""
    d = a.shape[-1]
    c = [[None] * d for _ in range(d)]
    t, r = [[None] * d for _ in range(d)], [None] * d
    for j in range(d):
        s = a[..., j, j]
        for k in range(j):
            s = s - c[j][k] * c[j][k]
        c[j][j] = torch.sqrt(s)
        r[j] = torch.reciprocal(c[j][j])
        for i in range(j + 1, d):
            u = a[..., i, j]
            for k in range(j):
                u = u - c[i][k] * c[j][k]
            t[i][j], c[i][j] = u, u * r[j]
    gc = [[g / c[i][i] if i == j else torch.zeros_like(g) for j in range(d)]
          for i in range(d)]
    ga = torch.zeros_like(a)
    for j in reversed(range(d)):
        g_inv = None
        for i in reversed(range(j + 1, d)):
            gt, gi = gc[i][j] * r[j], gc[i][j] * t[i][j]
            g_inv = gi if g_inv is None else g_inv + gi
            for k in reversed(range(j)):
                gc[i][k] = gc[i][k] + (-gt) * c[j][k]
                gc[j][k] = gc[j][k] + (-gt) * c[i][k]
            ga[..., i, j] = gt
        if g_inv is not None:
            gc[j][j] = gc[j][j] + (-g_inv) * (r[j] * r[j])
        gs = gc[j][j] / (2 * c[j][j])
        for k in reversed(range(j)):
            p = (-gs) * c[j][k]
            gc[j][k] = gc[j][k] + p + p
        ga[..., j, j] = gs
    return ga


def state_entropy_bwd_plain(tril_packed, g, d, jitter=om.DEFAULT_JITTER):
    """The VJP that the backward kernel computes, as tensor ops: for packed
    scales tril_packed (..., d(d+1)/2) and the entropies' cotangent g
    (...), the cotangent of tril_packed through the unrolled chain (L L^T +
    jitter I, `om.cholesky_small`, the sum of logs), operation for
    operation as autograd forms it: G = the Cholesky's adjoint
    (`_cholesky_adjoint`), then G L + (L^T G)^T. Mathematically g A^{-1} L,
    A = L L^T + jitter I."""
    L = om.fill_tril(tril_packed, d)
    G = _cholesky_adjoint(om.add_jitter(torch.matmul(L, L.mT), jitter), g)
    return om.pack_tril(torch.matmul(G, L) + torch.matmul(L.mT, G).mT)


def _check_state_entropy(tril_packed, d):
    if tril_packed.device.type != "cuda":
        raise ValueError(f"state_entropy runs on a card, got {tril_packed.device}"
                         f" (the CPU path is the unrolled chain, "
                         f"`states.shooting_entropy`)")
    if tril_packed.dtype != torch.float32:
        raise TypeError(f"state_entropy takes float32, got {tril_packed.dtype}")
    if not 1 <= d <= om.SMALL_CHOL_MAX_DIM:
        raise ValueError(f"state_entropy takes 1 <= D <= {om.SMALL_CHOL_MAX_DIM}"
                         f", got D={d}")
    if tril_packed.ndim < 1 or tril_packed.shape[-1] != d * (d + 1) // 2:
        raise ValueError(f"tril_packed must be (..., {d * (d + 1) // 2}) at "
                         f"D={d}, got {tuple(tril_packed.shape)}")
    if tril_packed.numel() > 2 ** 31 - 1:
        raise ValueError(f"state_entropy takes at most 2**31 - 1 floats, got "
                         f"{tril_packed.numel()}")


def _state_entropy_fwd(tril, d, jitter):
    out = tril.new_empty(tril.shape[:-1])
    LAUNCHES["state_entropy_fwd"] += 1
    rc = _lib("state_entropy").gpode_state_entropy_fwd(
        _ptr(tril), ctypes.c_float(jitter),
        ctypes.c_float(d * (1.0 + math.log(2.0 * math.pi))), _ptr(out),
        out.numel(), d, _stream(tril.device))
    _raise_on(rc, "state_entropy forward")
    return out


def _state_entropy_bwd(tril, g, d, jitter):
    g = g.contiguous()
    grad = torch.empty_like(tril)
    LAUNCHES["state_entropy_bwd"] += 1
    rc = _lib("state_entropy").gpode_state_entropy_bwd(
        _ptr(tril), _ptr(g), ctypes.c_float(jitter), _ptr(grad), g.numel(), d,
        _stream(tril.device))
    _raise_on(rc, "state_entropy backward")
    return grad


class _StateEntropyFn(torch.autograd.Function):
    """The entropies (...) of packed scales (..., d(d+1)/2) on the card,
    differentiable in the scales: both kernels (the backward recomputes
    the factor; only the scales are saved)."""

    @staticmethod
    def forward(ctx, tril, d, jitter):
        ctx.save_for_backward(tril)
        ctx.d, ctx.jitter = d, jitter
        return _state_entropy_fwd(tril, d, jitter)

    @staticmethod
    @first_order_only
    def backward(ctx, g):
        (tril,) = ctx.saved_tensors
        return _state_entropy_bwd(tril, g, ctx.d, ctx.jitter), None, None


def state_entropy(tril_packed, d, jitter=om.DEFAULT_JITTER):
    """Entropies of N(., L L^T + jitter I) for the packed lower-triangular
    scales tril_packed (..., d(d+1)/2): 0.5 (d (1 + log 2 pi) + log det),
    shape (...), differentiable in tril_packed. Both kernels repeat the
    unrolled chain's operations (L L^T as the GEMM sums it,
    `ops/math.cholesky_small`, the logs), each rounded on its own: the
    gradient is autograd's through the chain bit for bit
    (`state_entropy_bwd_plain`), the entropy within the order of the sum
    of logs; a non-positive pivot gives a non-finite entropy, as there.

    It launches the forward kernel and, for a gradient, the backward (on
    the current stream, counted in `LAUNCHES` as `state_entropy_fwd` and
    `state_entropy_bwd`), or raises on operands the kernels do not take
    (float32 on a card, 1 <= d <= SMALL_CHOL_MAX_DIM, a template each in
    `csrc/state_entropy.cu`; CPU tensors: the unrolled chain in
    `states.shooting_entropy` is their path)."""
    _check_state_entropy(tril_packed, d)
    return _StateEntropyFn.apply(tril_packed.contiguous(), d, float(jitter))


# ---------------------------------------------------------------------------
# What a kernel holds on the card
# ---------------------------------------------------------------------------

def kernel_occupancy(lib_name, c_function, entry_key, *int_args):
    """One kernel's resources at a launch geometry: the occupancy query of
    `c_function` (csrc: resident blocks per SM, block threads, dynamic shared
    bytes, registers, local bytes) and the registers and spill bytes that
    ptxas reported for the entry whose mangled name contains `entry_key`."""
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


# (library, kernel, occupancy query) of the row-tile kernels: `fused_rhs`
# by direction, the segment kernels by (direction, stages); a kernel
# variant's mangled name holds `variant_key(kernel, dp, rt, maxt)`
RHS_KERNELS = {
    "fwd": ("fused_rhs", "rhs_fwd_kernel", "gpode_fused_rhs_fwd_occupancy"),
    "bwd": ("fused_rhs", "rhs_bwd_kernel", "gpode_fused_rhs_bwd_occupancy"),
}
SEGMENT_KERNELS = {
    ("fwd", 6): ("fused_dopri5", "dp_attempt_fwd_kernel",
                 "gpode_dp_attempt_fwd_occupancy"),
    ("bwd", 6): ("fused_dopri5", "dp_attempt_bwd_kernel",
                 "gpode_dp_attempt_bwd_occupancy"),
    ("fwd", 4): ("fused_rk4", "rk4_fwd_kernel", "gpode_rk4_fwd_occupancy"),
    ("bwd", 4): ("fused_rk4", "rk4_bwd_kernel", "gpode_rk4_bwd_occupancy"),
}
# (library, kernel, occupancy query) of `dopri5_attempt_draws`; variant
# (dp, rt, maxt)'s mangled name holds `variant_key(kernel, dp, rt, maxt)`
DRAWS_KERNEL = ("dopri5_draws", "draws_attempt_kernel",
                "gpode_dp_draws_attempt_occupancy")
# (library, occupancy query) of the `draw_solve` kernels, and each kernel's
# (name, index in the query) by layout and direction
DRAW_SOLVE_KERNEL = ("draw_solve", "gpode_draw_solve_occupancy")
DRAW_SOLVE_KERNELS = {
    ("square", "fwd"): ("draw_solve_fwd_kernel", 0),
    ("square", "bwd"): ("draw_solve_bwd_kernel", 1),
    ("packed", "fwd"): ("draw_solve_fwd_packed_kernel", 0),
    ("packed", "bwd_cols"): ("draw_solve_bwd_cols_kernel", 2),
    ("packed", "bwd_rows"): ("draw_solve_bwd_rows_kernel", 3),
    ("packed", "bwd_sym"): ("draw_solve_bwd_sym_kernel", 4),
}
# the (dp, rt, maxt) variants each kernel instantiates
RHS_VARIANTS = {"fwd": _RHS_FWD_VARIANTS, "bwd": _RHS_BWD_VARIANTS}
SEGMENT_VARIANTS = {("fwd", st): _SEG_FWD_VARIANTS[st] for st in (6, 4)}
SEGMENT_VARIANTS.update({("bwd", st): _SEG_BWD_VARIANTS[st] for st in (6, 4)})


def variant_key(kernel, dp, rt, maxt, suffix=""):
    """What the mangled name of variant (dp, rt, maxt) of `kernel` holds;
    `suffix`: the mangled template arguments after the three ints."""
    return f"{kernel}ILi{dp}ELi{rt}ELi{maxt}E{suffix}E"


def _tile_occupancy(lib_name, kernel, fn, din, d, m, s, geo):
    key = variant_key(kernel, geo.dp, geo.rt, geo.maxt)
    report = kernel_occupancy(lib_name, fn, key, din, d, m, s, geo.dp, geo.rt,
                              geo.groups, geo.maxt)
    if report["smem_bytes"] != geo.smem_bytes:
        raise RuntimeError(f"{kernel} takes {report['smem_bytes']} bytes of "
                           f"shared memory, the geometry says {geo.smem_bytes}")
    return report


def rhs_occupancy(direction, din, d, m, s, geo):
    """`kernel_occupancy` of the `fused_rhs` forward (`direction="fwd"`) or
    backward ("bwd") at geometry `geo`."""
    return _tile_occupancy(*RHS_KERNELS[direction], din, d, m, s, geo)


def draws_attempt_occupancy(din, d, m, s, geo):
    """`kernel_occupancy` of the `dopri5_attempt_draws` kernel at geometry
    `geo`."""
    return _tile_occupancy(*DRAWS_KERNEL, din, d, m, s, geo)


def draw_solve_occupancy(direction, m, r):
    """`kernel_occupancy` of a `draw_solve` kernel at M and R columns a
    factor: `direction` "fwd" (the square or packed forward, by M), "bwd"
    (the one-block backward, M <= 128), or past M = 128 "bwd_cols",
    "bwd_rows", "bwd_sym" (the packed backward's three kernels)."""
    geo = draw_solve_geometry(1, m, r)
    key = (geo.layout, direction)
    if key not in DRAW_SOLVE_KERNELS:
        raise ValueError(f"draw_solve has no {direction!r} kernel on the "
                         f"{geo.layout} layout (M={m})")
    name, index = DRAW_SOLVE_KERNELS[key]
    report = kernel_occupancy(*DRAW_SOLVE_KERNEL, name, index, m, r)
    want = {"fwd": geo.fwd_smem_bytes, "bwd": geo.bwd_smem_bytes,
            "bwd_cols": geo.bwd_smem_bytes,
            "bwd_rows": 4 * (m * (m + 1) // 2 + m), "bwd_sym": 0}[direction]
    if report["smem_bytes"] != want:
        raise RuntimeError(f"{name} takes {report['smem_bytes']} bytes of "
                           f"shared memory, the geometry says {want}")
    return report


def state_entropy_occupancy(direction, d):
    """`kernel_occupancy` of the `state_entropy` kernel of `direction`
    ("fwd" or "bwd") at dimension d: a template per D, whose mangled name
    holds `state_entropy_<direction>_kernelILi<D>E`."""
    return kernel_occupancy("state_entropy", "gpode_state_entropy_occupancy",
                            f"state_entropy_{direction}_kernelILi{d}E",
                            ("fwd", "bwd").index(direction), d)


def segment_occupancy(direction, stages, din, d, m, s, geo):
    """`kernel_occupancy` of the dopri5-attempt (`stages=6`) or rk4-segment
    (`stages=4`) kernel, forward (`direction="fwd"`) or backward ("bwd"),
    at geometry `geo`."""
    return _tile_occupancy(*SEGMENT_KERNELS[direction, stages], din, d, m, s,
                           geo)


# ---------------------------------------------------------------------------
# rbf_gram
# ---------------------------------------------------------------------------

# `rbf_gram` blocks (csrc/rbf_gram.cu): a thread takes a group of
# _GRAM_GROUP adjacent columns of one dim and the rows lane, lane + L, ... of
# its block's tile; a block is L row lanes times up to _GRAM_BLOCK_GROUPS
# column groups (M is split into balanced column chunks of at most 64
# columns). DP of the instantiated variants (csrc GRAM_VARIANTS): a shape
# takes the narrowest with Din <= DP, and a wider Din the variant
# GRAM_ANY_DIN, which keeps its chunk's scaled z rows in shared memory.
# Measured on an H100 at N=3000, Din=D=5 (the sweep is in PERF.md): blocks
# of 13-16 groups and 128-256 threads whose lanes walk 4-8 rows beat one
# block row of all M columns and beat more, smaller blocks.
GRAM_ANY_DIN = 0
GRAM_VARIANTS = (1, 2, 3, 4, 5, 6, 8, 16, GRAM_ANY_DIN)
_GRAM_GROUP = 4
_GRAM_BLOCK_GROUPS = 16
_GRAM_THREADS = 256
_GRAM_MAX_ROWS_PER_LANE = 8
_GRAM_BLOCKS_PER_SM = 2
_GRID_YZ_MAX = 65535
# the widest Din the kernel takes: one row and one group in shared memory
GRAM_MAX_DIN = MAX_SMEM_BYTES // (4 * (1 + _GRAM_GROUP))


@dataclasses.dataclass(frozen=True)
class GramGeometry:
    """Launch geometry of `rbf_gram`: a (row_blocks, col_chunks, D) grid of
    blocks of `lanes` row lanes times `groups_per_block` column groups."""
    dp: int                # the variant's bound of its loops over Din (0: Din)
    groups_per_block: int  # column groups of _GRAM_GROUP columns per block
    col_chunks: int        # blocks along the columns: ceil(groups / that)
    lanes: int             # row lanes; threads = lanes * groups_per_block
    rows_per_block: int    # a multiple of lanes
    row_blocks: int
    threads: int
    blocks: int            # row_blocks * col_chunks * D
    smem_bytes: int        # gram_smem_bytes of the block
    vec: bool              # M % 4 == 0: each row's group is one 16-byte store


def gram_smem_bytes(din, dp, rows_per_block, groups_per_block):
    """Dynamic shared memory of an `rbf_gram` block (csrc `gram_smem_bytes`):
    the tile's scaled x rows (rows_per_block, DP), and for GRAM_ANY_DIN the
    tile's (rows_per_block, Din) and its chunk's scaled z rows."""
    if dp:
        return 4 * rows_per_block * dp
    return 4 * din * (rows_per_block + _GRAM_GROUP * groups_per_block)


def gram_geometry(n, din, d, m, sms):
    """Geometry of `rbf_gram` for K (D, N, M) from x (N, Din) on a card of
    `sms` multiprocessors; raises ValueError on a shape the kernel does not
    take. The row lanes of a block are the largest power of two that keeps
    it within _GRAM_THREADS threads; a lane walks up to
    _GRAM_MAX_ROWS_PER_LANE rows, fewer until the grid holds
    _GRAM_BLOCKS_PER_SM blocks per SM, and below one row the block loses
    lanes, so that a small N still spreads over the card. A block over the
    shared-memory limit (only GRAM_ANY_DIN's can be) loses rows, then
    lanes, then column groups. Pure arithmetic: no device is touched."""
    if (not 1 <= din <= GRAM_MAX_DIN or not 1 <= d <= _GRID_YZ_MAX
            or n < 1 or m < 1):
        raise ValueError(f"rbf_gram supports 1 <= Din <= {GRAM_MAX_DIN}, "
                         f"1 <= D <= {_GRID_YZ_MAX} and N, M >= 1; got N={n}, "
                         f"Din={din}, D={d}, M={m}")
    dp = next((v for v in GRAM_VARIANTS if din <= v), GRAM_ANY_DIN)
    groups = math.ceil(m / _GRAM_GROUP)
    chunks = math.ceil(groups / _GRAM_BLOCK_GROUPS)
    per_block = math.ceil(groups / chunks)
    target = _GRAM_BLOCKS_PER_SM * sms

    def blocks(rows_per_block):
        return math.ceil(n / rows_per_block) * chunks * d

    lanes = 1 << ((_GRAM_THREADS // per_block).bit_length() - 1)
    per_lane = _GRAM_MAX_ROWS_PER_LANE
    while blocks(lanes * per_lane) < target and lanes * per_lane > 1:
        if per_lane > 1:
            per_lane //= 2
        else:
            lanes //= 2
    # at Din <= 16 at most 2048 rows of 16 floats: 128 KB, within the limit;
    # at GRAM_MAX_DIN one row and one group fit
    while gram_smem_bytes(din, dp, lanes * per_lane, per_block) > MAX_SMEM_BYTES:
        if per_lane > 1:
            per_lane //= 2
        elif lanes > 1:
            lanes //= 2
        else:
            per_block = math.ceil(per_block / 2)
            chunks = math.ceil(groups / per_block)
    if chunks > _GRID_YZ_MAX:
        raise ValueError(f"rbf_gram supports M <= "
                         f"{_GRID_YZ_MAX * per_block * _GRAM_GROUP} at Din="
                         f"{din}; got M={m}")
    rows = lanes * per_lane
    return GramGeometry(dp=dp, groups_per_block=per_block, col_chunks=chunks,
                        lanes=lanes, rows_per_block=rows,
                        row_blocks=math.ceil(n / rows),
                        threads=lanes * per_block, blocks=blocks(rows),
                        smem_bytes=gram_smem_bytes(din, dp, rows, per_block),
                        vec=m % _GRAM_GROUP == 0)


# (library, kernel, occupancy query) of `rbf_gram`; variant DP's mangled
# name holds `gram_variant_key(dp)`
GRAM_KERNEL = ("rbf_gram", "rbf_gram_kernel", "gpode_rbf_gram_occupancy")


def gram_variant_key(dp):
    return f"{GRAM_KERNEL[1]}ILi{dp}EE"


def gram_occupancy(din, d, m, geo):
    """`kernel_occupancy` of `rbf_gram` at geometry `geo`."""
    lib_name, _, fn = GRAM_KERNEL
    report = kernel_occupancy(lib_name, fn, gram_variant_key(geo.dp), din, d, m,
                              geo.dp, geo.rows_per_block, geo.lanes,
                              geo.groups_per_block)
    if report["smem_bytes"] != geo.smem_bytes:
        raise RuntimeError(f"rbf_gram takes {report['smem_bytes']} bytes of "
                           f"shared memory, the geometry says {geo.smem_bytes}")
    return report


def _launch_rbf_gram(x, z, inv_ls, variance):
    """One launch on contiguous CUDA operands; inv_ls (D, Din) = 1 / ls."""
    dev = x.device
    (n, din), m, d = x.shape, z.shape[0], inv_ls.shape[0]
    if n == 0 or m == 0:
        return torch.empty(d, n, m, dtype=torch.float32, device=dev)
    geo = gram_geometry(n, din, d, m, _sms(dev))   # raises before any launch
    out = torch.empty(d, n, m, dtype=torch.float32, device=dev)
    lib = _lib("rbf_gram")
    LAUNCHES["rbf_gram"] += 1
    rc = lib.gpode_rbf_gram(_ptr(x), _ptr(z), _ptr(inv_ls), _ptr(variance),
                            _ptr(out), n, din, d, m, geo.dp, geo.rows_per_block,
                            geo.lanes, geo.groups_per_block, _stream(dev))
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
    with torch.no_grad():
        return _launch_rbf_gram(x.contiguous(), z.contiguous(),
                                (1.0 / lengthscales).contiguous(),
                                variance.contiguous())
