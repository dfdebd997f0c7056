"""The wide-layout rhs: the sampled vector field of `fused_rhs` computed over
packed operands that lay all D output dims side by side along one column
axis of W = D * (Sp + Mp) columns.

Counterpart of `scripts/proto_wide_rhs.py` (the A/B prototype of the JAX
package): `wide_pack` / `wide_unpack_cotangents` are small-tensor glue in
plain torch; `fused_rhs_wide`, `fused_rhs_wide2` and `fused_rhs_wide_bwd`
run hand-written kernels (`csrc/fused_rhs_wide.cu`) on CUDA tensors and
their plain versions (`*_plain`, the same packed-operand arithmetic as
tensor ops) on CPU tensors:

    t   = x @ B                  B = [omega_wide | z / ls^2 wide]   (Din, W)
    xn  = x^2 @ invls2           invls2 = (1 / ls^2)^T              (Din, D)
    act = [cos(t_rff + phase) | exp(t_gram - (xn + zn) / 2)]        (N, W)
    f   = act @ Wblk             Wblk block-diagonal, scales folded (W, D)

The Gram exponent is the norm expansion |xd - zd|^2 = xn + zn - 2 xd.zd, a
difference of large terms: everything is float32 FMA arithmetic, never TF32.

All three functions are forward computations without an autograd rule (as
in the JAX prototype, where the backward is a separate function): called
with grad mode on and an operand that requires grad they raise.

Public layouts as for `fused_rhs`: z (M, Din), lengthscales (D, Din) and
variance (D,) constrained, omega (Din, S, D), phase (1, S, D), weights
(S, D), nu (D, M).
"""

from __future__ import annotations

import math

import torch

from gpode_tpu_torch.ops import cuda_kernels as ck

ZN_PAD = 1e30      # padded Gram columns: exp(-0.5 * ZN_PAD) == 0
KERNEL_PAD = 32    # the CUDA kernels' column-block multiple (one warp)
MAX_DIM = 16       # csrc/fused_rhs_wide.cu: Din, D <= 16
_FWD_WARPS, _BWD_WARPS, _ROWS = 8, 8, 4   # block shapes; _ROWS == WIDE_R


def _ceil_to(v: int, multiple: int) -> int:
    return -(-v // multiple) * multiple


def wide_pack(z, lengthscales, variance, omega, phase, weights, nu, s_real,
              pad: int = 128):
    """Build the wide operands (small tensors, plain torch):
    (b (Din, W), phase_w (1, D*Sp), zn_w (1, D*Mp), invls2_t (Din, D),
    wblk (W, D), sp, mp), with Sp and Mp the feature and inducing counts
    rounded up to a multiple of `pad` (128 is the JAX prototype's lane
    layout; the CUDA kernels use 32). Padded rff columns are all-zero and
    padded Gram columns carry zn = ZN_PAD, so both contribute exactly 0."""
    m, din = z.shape
    d = nu.shape[0]
    s = omega.shape[1]
    sp, mp = _ceil_to(s, pad), _ceil_to(m, pad)
    inv_ls2 = 1.0 / lengthscales ** 2                              # (D, Din)
    padf = torch.nn.functional.pad

    om_p = padf(omega.movedim(2, 1), (0, sp - s))                  # (Din, D, Sp)
    zs_p = padf(inv_ls2[:, :, None] * z.T[None], (0, mp - m))      # (D, Din, Mp)
    b = torch.cat([om_p.reshape(din, d * sp),
                   zs_p.movedim(0, 1).reshape(din, d * mp)], dim=1)

    phase_w = padf(phase.movedim(2, 0)[:, 0, :], (0, sp - s)).reshape(1, d * sp)
    zn = torch.einsum("mk,dk->dm", z * z, inv_ls2)                 # (D, M)
    zn_w = padf(zn, (0, mp - m), value=ZN_PAD).reshape(1, d * mp)

    scale = torch.sqrt(2.0 * variance / s_real)                    # (D,)
    wsc = padf(weights * scale[None, :], (0, 0, 0, sp - s))        # (Sp, D)
    eye = torch.eye(d, dtype=z.dtype, device=z.device)
    blk_rff = torch.einsum("sd,de->dse", wsc, eye).reshape(d * sp, d)
    nuvar = padf(nu * variance[:, None], (0, mp - m))              # (D, Mp)
    blk_gram = torch.einsum("dm,de->dme", nuvar, eye).reshape(d * mp, d)
    wblk = torch.cat([blk_rff, blk_gram], dim=0)                   # (W, D)
    return b, phase_w, zn_w, inv_ls2.T, wblk, sp, mp


def wide_flat_weights(wblk, d: int, sp: int, mp: int):
    """The per-column weights of `fused_rhs_wide2`, (1, W): the block
    matrix's diagonal blocks as one flat row [wsc (D*Sp) | nuvar (D*Mp)]."""
    idx = torch.arange(d, device=wblk.device)
    wsc_w = wblk[:d * sp].reshape(d, sp, d)[idx, :, idx].reshape(1, d * sp)
    nv_w = wblk[d * sp:].reshape(d, mp, d)[idx, :, idx].reshape(1, d * mp)
    return torch.cat([wsc_w, nv_w], dim=1)


def wide_unpack_cotangents(db, dwblk, dphase_w, dzn_w, dinvls2_xn, z,
                           lengthscales, variance, weights, nu, s, sp, mp):
    """Chain the packed wide cotangents back to the public parameter layout
    (small tensors; the cotangents of structural pad and off-diagonal
    entries are dropped): (dz, dls, dvar, domega, dphase, dweights, dnu)."""
    m, din = z.shape
    d = nu.shape[0]
    inv_ls2 = 1.0 / lengthscales ** 2                              # (D, Din)
    idx = torch.arange(d, device=z.device)

    domega = db[:, :d * sp].reshape(din, d, sp)[:, :, :s].movedim(1, 2)
    db_g = db[:, d * sp:].reshape(din, d, mp)[:, :, :m]            # (Din, D, M)
    dz = torch.einsum("kdm,dk->mk", db_g, inv_ls2)
    dinvls2 = torch.einsum("kdm,mk->dk", db_g, z)

    dwsc = dwblk[:d * sp].reshape(d, sp, d)[idx, :, idx][:, :s]    # (D, S)
    scale = torch.sqrt(2.0 * variance / s)
    dweights = dwsc.T * scale[None, :]                             # (S, D)
    dscale = torch.sum(dwsc.T * weights, dim=0)                    # (D,)
    dvar = dscale * scale / (2.0 * variance)
    dnv = dwblk[d * sp:].reshape(d, mp, d)[idx, :, idx][:, :m]     # (D, M)
    dnu = dnv * variance[:, None]
    dvar = dvar + torch.sum(dnv * nu, dim=1)

    dphase = dphase_w.reshape(d, sp)[:, :s][:, None, :].movedim(0, 2)
    # zn chains: zn[d, m] = sum_k z[m, k]^2 inv_ls2[d, k]
    dzn = dzn_w.reshape(d, mp)[:, :m]                              # (D, M)
    dz = dz + 2.0 * z * torch.einsum("dm,dk->mk", dzn, inv_ls2)
    dinvls2 = dinvls2 + torch.einsum("dm,mk->dk", dzn, z * z)
    dinvls2 = dinvls2 + dinvls2_xn.T                               # xn chain
    dls = -2.0 * dinvls2 / lengthscales ** 3
    return dz, dls, dvar, domega, dphase, dweights, dnu


# ---------------------------------------------------------------------------
# Plain versions: the packed-operand arithmetic as tensor ops
# ---------------------------------------------------------------------------

def _wide_act(x, b, phase_w, zn_w, invls2_t, d, sp, mp):
    """t, xn and the two activation halves: (to (N, D*Sp), e (N, D*Mp))."""
    t = x @ b
    xn = (x * x) @ invls2_t                                        # (N, D)
    ds = d * sp
    to = t[:, :ds] + phase_w
    e = torch.exp(t[:, ds:] - 0.5 * (xn.repeat_interleave(mp, dim=1) + zn_w))
    return to, e


def wide_fwd_packed_plain(x, b, phase_w, zn_w, invls2_t, wblk, d, sp, mp):
    """The wide forward over packed operands: t = x @ B, act, act @ Wblk."""
    to, e = _wide_act(x, b, phase_w, zn_w, invls2_t, d, sp, mp)
    return torch.cat([torch.cos(to), e], dim=1) @ wblk


def wide2_fwd_packed_plain(x, b, phase_w, zn_w, invls2_t, flat, d, sp, mp):
    """The wide2 forward over packed operands: the one fat product, then
    per-dim multiply-reduces with the flat weight row (1, W)."""
    flat = flat.reshape(-1)
    to, e = _wide_act(x, b, phase_w, zn_w, invls2_t, d, sp, mp)
    prior = (torch.cos(to) * flat[:d * sp]).reshape(-1, d, sp).sum(dim=2)
    update = (e * flat[d * sp:]).reshape(-1, d, mp).sum(dim=2)
    return prior + update


def fused_rhs_wide_plain(x, z, lengthscales, variance, omega, phase, weights,
                         nu):
    """`fused_rhs_wide` as tensor ops: t = x @ B, act, f = act @ Wblk."""
    b, phase_w, zn_w, invls2_t, wblk, sp, mp = wide_pack(
        z, lengthscales, variance, omega, phase, weights, nu,
        weights.shape[0], KERNEL_PAD)
    return wide_fwd_packed_plain(x, b, phase_w, zn_w, invls2_t, wblk,
                                 nu.shape[0], sp, mp)


def fused_rhs_wide2_plain(x, z, lengthscales, variance, omega, phase, weights,
                          nu):
    """`fused_rhs_wide2` as tensor ops: the one fat product, then per-dim
    multiply-reduces with the flat weight rows."""
    d = nu.shape[0]
    b, phase_w, zn_w, invls2_t, wblk, sp, mp = wide_pack(
        z, lengthscales, variance, omega, phase, weights, nu,
        weights.shape[0], KERNEL_PAD)
    return wide2_fwd_packed_plain(x, b, phase_w, zn_w, invls2_t,
                                  wide_flat_weights(wblk, d, sp, mp), d, sp,
                                  mp)


def wide_bwd_packed_plain(x, g, b, phase_w, zn_w, invls2_t, wblk, d, sp, mp):
    """The wide VJP over packed operands as tensor ops: recompute t/act,
    then the four contractions. Returns (dx, db, dwblk, dphase_w, dzn_w,
    dinvls2_xn)."""
    to, e = _wide_act(x, b, phase_w, zn_w, invls2_t, d, sp, mp)
    act = torch.cat([torch.cos(to), e], dim=1)                     # (N, W)
    ds = d * sp
    dact = g @ wblk.T                                              # (N, W)
    dto = -torch.sin(to) * dact[:, :ds]
    dte = e * dact[:, ds:]
    dt = torch.cat([dto, dte], dim=1)
    dxn = -0.5 * dte.reshape(-1, d, mp).sum(dim=2)                 # (N, D)
    dx = dt @ b.T + 2.0 * x * (dxn @ invls2_t.T)
    db = x.T @ dt                                                  # (Din, W)
    dwblk = act.T @ g                                              # (W, D)
    dphase_w = dto.sum(dim=0, keepdim=True)                        # (1, D*Sp)
    dzn_w = -0.5 * dte.sum(dim=0, keepdim=True)                    # (1, D*Mp)
    dinvls2_xn = (x * x).T @ dxn                                   # (Din, D)
    return dx, db, dwblk, dphase_w, dzn_w, dinvls2_xn


def fused_rhs_wide_bwd_plain(x, z, lengthscales, variance, omega, phase,
                             weights, nu, g):
    """`fused_rhs_wide_bwd` as tensor ops: (dx, dz, dls, dvar, domega,
    dphase, dweights, dnu)."""
    s = weights.shape[0]
    b, phase_w, zn_w, invls2_t, wblk, sp, mp = wide_pack(
        z, lengthscales, variance, omega, phase, weights, nu,
        weights.shape[0], KERNEL_PAD)
    dx, *packed = wide_bwd_packed_plain(x, g, b, phase_w, zn_w, invls2_t,
                                        wblk, nu.shape[0], sp, mp)
    return (dx,) + wide_unpack_cotangents(*packed, z, lengthscales, variance,
                                          weights, nu, s, sp, mp)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check_wide(x, operands, g=None):
    """Operand checks shared with `fused_rhs` and the wide kernels' own
    limits. Returns (din, d, m, s)."""
    din, d, m, s = ck._check(x, *operands)
    if din > MAX_DIM or d > MAX_DIM:
        raise ValueError(f"the wide kernels support Din, D <= {MAX_DIM}; got "
                         f"Din={din}, D={d}")
    if g is not None and (g.shape != (x.shape[0], d) or g.device != x.device
                          or g.dtype != torch.float32):
        raise ValueError(f"g must be a float32 ({x.shape[0]}, {d}) tensor on "
                         f"{x.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    return din, d, m, s


def _fwd_rows_per_block(n, dev):
    """Forward tile: whole passes of _ROWS rows, about six blocks per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _ROWS * max(1, math.ceil(n / (_ROWS * 6 * sms)))


def _bwd_rows_per_block(n, dev):
    """Backward tile: whole passes of _ROWS rows, about three blocks per SM,
    so the card fills while the per-block slabs (and the reduction that
    reads them) stay small."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _ROWS * max(1, math.ceil(n / (_ROWS * 3 * sms)))


def launch_wide_fwd(x, b, phase_w, zn_w, invls2_t, wts, d, sp, mp, dense):
    """One forward launch over packed operands: `wts` is Wblk (W, D) when
    `dense`, else the flat weight row (1, W). Returns f (N, D)."""
    dev = x.device
    n, din = x.shape
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = ck._lib("fused_rhs_wide")
    ck.LAUNCHES["fused_rhs_wide_fwd" if dense else "fused_rhs_wide2_fwd"] += 1
    rc = lib.gpode_wide_fwd(
        *map(ck._ptr, (x, b, phase_w, zn_w, invls2_t, wts, out)), n, din, d,
        sp, mp, int(dense), _fwd_rows_per_block(n, dev), _FWD_WARPS,
        ck._stream(dev))
    ck._raise_on(rc, "fused_rhs_wide forward" if dense
                 else "fused_rhs_wide2 forward")
    return out


def launch_wide_bwd(x, g, b, phase_w, zn_w, invls2_t, wblk, d, sp, mp):
    """One backward launch (plus its fixed-order slab reduction) over packed
    operands: (dx, db, dwblk, dphase_w, dzn_w, dinvls2_xn)."""
    dev = x.device
    n, din = x.shape
    w = d * (sp + mp)
    slab = w * (din + d + 1) + din * d
    rows = _bwd_rows_per_block(n, dev)
    ck._check_smem(4 * (slab + _ROWS * (din + 3 * d)
                        + _BWD_WARPS * _ROWS * (din + d)),
                   "fused_rhs_wide backward")
    n_blocks = math.ceil(n / rows)
    dx = torch.empty(n, din, dtype=torch.float32, device=dev)
    part = torch.empty(n_blocks * slab, dtype=torch.float32, device=dev)
    out = torch.empty(slab, dtype=torch.float32, device=dev)
    lib = ck._lib("fused_rhs_wide")
    ck.LAUNCHES["fused_rhs_wide_bwd"] += 1
    rc = lib.gpode_wide_bwd(
        *map(ck._ptr, (x, g, b, phase_w, zn_w, invls2_t, wblk, dx, part, out)),
        n, din, d, sp, mp, rows, _BWD_WARPS, ck._stream(dev))
    ck._raise_on(rc, "fused_rhs_wide backward")
    o = 0
    db = out[o:o + din * w].reshape(din, w); o += din * w
    dwblk = out[o:o + w * d].reshape(w, d); o += w * d
    dphase_w = out[o:o + d * sp].reshape(1, d * sp); o += d * sp
    dzn_w = out[o:o + d * mp].reshape(1, d * mp); o += d * mp
    dinvls2_xn = out[o:o + din * d].reshape(din, d)
    return dx, db, dwblk, dphase_w, dzn_w, dinvls2_xn


def wide_bwd_occupancy(din, d, sp, mp):
    """`cuda_kernels.kernel_occupancy` of the wide backward."""
    width = 8 if din <= 8 and d <= 8 else 16
    return ck.kernel_occupancy("fused_rhs_wide", "gpode_wide_bwd_occupancy",
                               f"wide_bwd_kernelILi{width}EE", din, d, sp, mp,
                               _BWD_WARPS)


def kernel_pack(z, lengthscales, variance, omega, phase, weights, nu):
    """`wide_pack` at the kernels' pad, every operand contiguous."""
    *packed, sp, mp = wide_pack(z, lengthscales, variance, omega, phase,
                                weights, nu, weights.shape[0], KERNEL_PAD)
    return tuple(t.contiguous() for t in packed) + (sp, mp)


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

def fused_rhs_wide(x, z, lengthscales, variance, omega, phase, weights, nu):
    """The rhs (N, Din) -> (N, D) in the wide layout: both contractions are
    GEMM-shaped over the packed operands. Forward only."""
    operands = (z, lengthscales, variance, omega, phase, weights, nu)
    ck.require_no_grad("fused_rhs_wide", x, *operands)
    if x.device.type == "cpu":
        return fused_rhs_wide_plain(x, *operands)
    _, d, _, _ = _check_wide(x, operands)
    with torch.no_grad():
        b, phase_w, zn_w, invls2_t, wblk, sp, mp = kernel_pack(*operands)
        return launch_wide_fwd(x, b, phase_w, zn_w, invls2_t, wblk, d, sp,
                               mp, dense=True)


def fused_rhs_wide2(x, z, lengthscales, variance, omega, phase, weights, nu):
    """Wide variant 2: the one fat product t = x @ B, then per-dim
    multiply-reduces with flat weight rows (no product with the block
    matrix). Forward only."""
    operands = (z, lengthscales, variance, omega, phase, weights, nu)
    ck.require_no_grad("fused_rhs_wide2", x, *operands)
    if x.device.type == "cpu":
        return fused_rhs_wide2_plain(x, *operands)
    _, d, _, _ = _check_wide(x, operands)
    with torch.no_grad():
        b, phase_w, zn_w, invls2_t, wblk, sp, mp = kernel_pack(*operands)
        return launch_wide_fwd(x, b, phase_w, zn_w, invls2_t,
                               wide_flat_weights(wblk, d, sp, mp), d, sp, mp,
                               dense=False)


def fused_rhs_wide_bwd(x, z, lengthscales, variance, omega, phase, weights,
                       nu, g):
    """The rhs VJP in the wide layout for the cotangent g (N, D): (dx, dz,
    dls, dvar, domega, dphase, dweights, dnu). One kernel recomputes t/act
    and forms dx and the five packed parameter cotangents;
    `wide_unpack_cotangents` chains them to the public layout."""
    operands = (z, lengthscales, variance, omega, phase, weights, nu)
    ck.require_no_grad("fused_rhs_wide_bwd", x, *operands, g)
    if x.device.type == "cpu":
        return fused_rhs_wide_bwd_plain(x, *operands, g)
    _, d, _, s = _check_wide(x, operands, g)
    with torch.no_grad():
        b, phase_w, zn_w, invls2_t, wblk, sp, mp = kernel_pack(*operands)
        dx, *packed = launch_wide_bwd(x, g.contiguous(), b, phase_w, zn_w,
                                      invls2_t, wblk, d, sp, mp)
        return (dx,) + wide_unpack_cotangents(
            *packed, z, lengthscales, variance, weights, nu, s, sp, mp)
