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

The kernels' launch geometries, :func:`wide_fwd_geometry` and
:func:`wide_bwd_geometry`, are pure arithmetic that the CPU tests reach;
each raises ValueError on a shape its kernel does not take, and the public
functions ask them before anything is packed or launched.

Public layouts as for `fused_rhs`: z (M, Din), lengthscales (D, Din) and
variance (D,) constrained, omega (Din, S, D), phase (1, S, D), weights
(S, D), nu (D, M).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpode_tpu_torch.ops import cuda_kernels as ck

ZN_PAD = 1e30      # padded Gram columns: exp(-0.5 * ZN_PAD) == 0
KERNEL_PAD = 32    # the CUDA kernels' column-block multiple (one warp)
MAX_DIM = 16       # csrc/fused_rhs_wide.cu: max(Din, D) <= 16, the widest variant


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
# Launch geometry (pure arithmetic) and CUDA launches
# ---------------------------------------------------------------------------

# Forward blocks (csrc/fused_rhs_wide.cu `wide_fwd_kernel`): one tile of RT
# rows per block, G groups of D warps, about _FWD_WARPS warps. Backward
# blocks (`wide_bwd_kernel`): one dim's columns and a block of rows,
# _BWD_WARPS warps over the dim's 32-column units, about
# _BWD_BLOCKS_PER_SM blocks per SM over all dims. Measured on an H100 at
# N=3000, Din=D=5, M=100 and 256, S=256 (the sweep is in PERF.md): 5-warp
# forward blocks (a warp takes all its dim's units) beat 10, 15 and 20 for
# the dense contraction and tie for the multiply-reduce; 4-warp backward
# blocks, five per SM (one wave of 4.5), beat 2, 3, 6 and 12 warps at 1-6
# blocks per SM.
_FWD_WARPS = 5
_BWD_WARPS = 4
_BWD_BLOCKS_PER_SM = 5
# (dp, rt, maxt) of the instantiated variants, smallest dp first (csrc
# WIDE_FWD_VARIANTS, WIDE_BWD_VARIANTS); a shape takes the first with
# max(Din, D) <= dp. Both forward instantiations (dense and multiply-reduce)
# share the forward table.
WIDE_FWD_VARIANTS = ((4, 8, 640), (5, 6, 640), (8, 4, 640), (16, 2, 512))
WIDE_BWD_VARIANTS = ((4, 6, 640), (5, 5, 640), (8, 3, 512), (16, 1, 512))


@dataclasses.dataclass(frozen=True)
class WideFwdGeometry:
    """Launch geometry of the wide forward (both instantiations): one tile
    per block."""
    dp: int           # the variant's bound of its loops over Din and D
    rt: int           # rows per tile and block; rt * dp <= 32, the fold's width
    groups: int       # G: the block is G groups of D warps
    maxt: int         # the variant's thread bound (registers: 65536 / maxt)
    threads: int
    blocks: int
    smem_bytes: int


@dataclasses.dataclass(frozen=True)
class WideBwdGeometry:
    """Launch geometry of the wide backward: a (row_blocks, D) grid, block
    (rb, d) taking dim d's columns over rows_per_block rows."""
    dp: int              # the variant's bound of its loops over Din and D
    rt: int              # rows per tile; rt * (dp + 1) <= 32, the fold's width
    warps: int           # warps per block, sharing the dim's 32-column units
    maxt: int            # the variant's thread bound (registers: 65536 / maxt)
    threads: int
    rows_per_block: int  # a multiple of rt
    row_blocks: int
    blocks: int          # row_blocks * D
    smem_bytes: int
    slab_floats: int     # one (row block, dim) slab
    part_floats: int     # scratch: (row_blocks, D, slab)
    dx_part_floats: int  # scratch: the dims' dx shares (D, N, Din)


def _wide_variant(n, din, d, sp, mp, variants, what):
    """The (dp, rt, maxt) a wide kernel takes from its `variants` for this
    shape; raises ValueError on a shape it does not take."""
    if not (1 <= din <= MAX_DIM and 1 <= d <= MAX_DIM):
        raise ValueError(f"{what} supports Din, D <= {MAX_DIM}; got Din={din}, "
                         f"D={d}")
    if n < 1 or min(sp, mp) < KERNEL_PAD or sp % KERNEL_PAD or mp % KERNEL_PAD:
        raise ValueError(f"{what} needs N >= 1 and Sp, Mp positive multiples "
                         f"of {KERNEL_PAD}; got N={n}, Sp={sp}, Mp={mp}")
    return next(v for v in variants if max(din, d) <= v[0])


def wide_fwd_geometry(n, din, d, sp, mp):
    """Geometry of the wide forward (dense and multiply-reduce) for N rows
    over Sp features and Mp inducing points per dim, both padded to
    KERNEL_PAD; raises ValueError on a shape the kernel does not take. Pure
    arithmetic: no device is touched."""
    what = "fused_rhs_wide forward"
    dp, rt, maxt = _wide_variant(n, din, d, sp, mp, WIDE_FWD_VARIANTS, what)
    units = (sp + mp) // KERNEL_PAD                 # 32-column units per dim
    groups = max(1, min(units, min(_FWD_WARPS, maxt // 32) // d))
    # csrc wide_fwd_smem_floats: xt (rt, stride) | xn (rt, d) | red (warps, 32)
    smem = 4 * (rt * ck._align4(dp) + ck._align4(rt * d) + 32 * d * groups)
    ck._check_smem(smem, what)
    return WideFwdGeometry(dp=dp, rt=rt, groups=groups, maxt=maxt,
                           threads=32 * d * groups, blocks=math.ceil(n / rt),
                           smem_bytes=smem)


def wide_slab_floats(din, d, sp, mp):
    """Floats of one (row block, dim) slab of the wide backward (csrc
    wide_slab_floats): db (Din, cols) | dwblk (cols, D) | dphase, dzn (cols)
    | dinvls2 (Din), cols = Sp + Mp."""
    return (din + d + 1) * (sp + mp) + din


def wide_bwd_geometry(n, din, d, sp, mp, sms):
    """Geometry of the wide backward for N rows on a card of `sms`
    multiprocessors; raises ValueError on a shape the kernel does not take.
    Pure arithmetic: no device is touched."""
    what = "fused_rhs_wide backward"
    dp, rt, maxt = _wide_variant(n, din, d, sp, mp, WIDE_BWD_VARIANTS, what)
    cols = sp + mp
    warps = max(1, min(cols // KERNEL_PAD, _BWD_WARPS, maxt // 32))
    # csrc wide_bwd_smem_floats: xt, gt (rt, stride) | xn (rt) | red (warps,
    # 32) | the dim's accumulators (Din + D + 1, cols)
    smem = 4 * (2 * rt * ck._align4(dp) + ck._align4(rt) + 32 * warps
                + (din + d + 1) * cols)
    ck._check_smem(smem, what)
    row_blocks_max = max(1, math.ceil(_BWD_BLOCKS_PER_SM * sms / d))
    rows_per_block = rt * math.ceil(math.ceil(n / rt) / row_blocks_max)
    row_blocks = math.ceil(n / rows_per_block)
    slab = wide_slab_floats(din, d, sp, mp)
    return WideBwdGeometry(
        dp=dp, rt=rt, warps=warps, maxt=maxt, threads=32 * warps,
        rows_per_block=rows_per_block, row_blocks=row_blocks,
        blocks=row_blocks * d, smem_bytes=smem, slab_floats=slab,
        part_floats=row_blocks * d * slab, dx_part_floats=d * n * din)


def _check_wide(x, operands, g=None):
    """Operand checks shared with `fused_rhs`, the cotangent's, and the wide
    kernels' geometry in both directions, so a refused shape raises before
    anything is packed or launched. Returns (din, d, m, s)."""
    din, d, m, s = ck._check(x, *operands)
    if g is not None and (g.shape != (x.shape[0], d) or g.device != x.device
                          or g.dtype != torch.float32):
        raise ValueError(f"g must be a float32 ({x.shape[0]}, {d}) tensor on "
                         f"{x.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    n, sp, mp = x.shape[0], _ceil_to(s, KERNEL_PAD), _ceil_to(m, KERNEL_PAD)
    if g is None and n:
        wide_fwd_geometry(n, din, d, sp, mp)
    elif g is not None:
        wide_bwd_geometry(n, din, d, sp, mp, ck._sms(x.device))
    return din, d, m, s


def launch_wide_fwd(x, b, phase_w, zn_w, invls2_t, wts, d, sp, mp, dense):
    """One forward launch over packed operands: `wts` is Wblk (W, D) when
    `dense`, else the flat weight row (1, W). Returns f (N, D)."""
    dev = x.device
    n, din = x.shape
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    geo = wide_fwd_geometry(n, din, d, sp, mp)
    lib = ck._lib("fused_rhs_wide")
    ck.LAUNCHES["fused_rhs_wide_fwd" if dense else "fused_rhs_wide2_fwd"] += 1
    rc = lib.gpode_wide_fwd(
        *map(ck._ptr, (x, b, phase_w, zn_w, invls2_t, wts, out)), n, din, d,
        sp, mp, int(dense), geo.dp, geo.rt, geo.groups, geo.maxt,
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
    geo = wide_bwd_geometry(n, din, d, sp, mp, ck._sms(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(n, din, **f32)
    dx_part = torch.empty(geo.dx_part_floats, **f32)
    part = torch.empty(geo.part_floats, **f32)
    out = torch.empty(w * (din + d + 1) + din * d, **f32)
    lib = ck._lib("fused_rhs_wide")
    ck.LAUNCHES["fused_rhs_wide_bwd"] += 1
    rc = lib.gpode_wide_bwd(
        *map(ck._ptr, (x, g, b, phase_w, zn_w, invls2_t, wblk, dx, dx_part,
                       part, out)),
        n, din, d, sp, mp, geo.rows_per_block, geo.dp, geo.rt, geo.warps,
        geo.maxt, ck._stream(dev))
    ck._raise_on(rc, "fused_rhs_wide backward")
    o = 0
    db = out[o:o + din * w].reshape(din, w); o += din * w
    dwblk = out[o:o + w * d].reshape(w, d); o += w * d
    dphase_w = out[o:o + d * sp].reshape(1, d * sp); o += d * sp
    dzn_w = out[o:o + d * mp].reshape(1, d * mp); o += d * mp
    dinvls2_xn = out[o:o + din * d].reshape(din, d)
    return dx, db, dwblk, dphase_w, dzn_w, dinvls2_xn


# The three wide kernels by launch counter: (direction, the mangled
# template argument after (dp, rt, maxt): the forward's DENSE flag); variant
# (dp, rt, maxt) of kernel K mangles to a name that holds
# `ck.variant_key(K, dp, rt, maxt, suffix)`.
WIDE_KERNELS = {"fused_rhs_wide_fwd": ("fwd", "Lb1E"),
                "fused_rhs_wide2_fwd": ("fwd", "Lb0E"),
                "fused_rhs_wide_bwd": ("bwd", "")}
WIDE_KERNEL_NAMES = {"fwd": "wide_fwd_kernel", "bwd": "wide_bwd_kernel"}
WIDE_VARIANTS = {"fwd": WIDE_FWD_VARIANTS, "bwd": WIDE_BWD_VARIANTS}


def wide_occupancy(name, n, din, d, sp, mp, sms):
    """`cuda_kernels.kernel_occupancy` of wide kernel `name` (a key of
    WIDE_KERNELS) at its geometry for this shape, and that geometry."""
    direction, suffix = WIDE_KERNELS[name]
    if direction == "fwd":
        geo = wide_fwd_geometry(n, din, d, sp, mp)
        args = (din, d, sp, mp, int(suffix == "Lb1E"), geo.dp, geo.rt,
                geo.groups, geo.maxt)
    else:
        geo = wide_bwd_geometry(n, din, d, sp, mp, sms)
        args = (din, d, sp, mp, geo.dp, geo.rt, geo.warps, geo.maxt)
    report = ck.kernel_occupancy(
        "fused_rhs_wide", f"gpode_wide_{direction}_occupancy",
        ck.variant_key(WIDE_KERNEL_NAMES[direction], geo.dp, geo.rt, geo.maxt,
                       suffix), *args)
    if report["smem_bytes"] != geo.smem_bytes:
        raise RuntimeError(f"{name} takes {report['smem_bytes']} bytes of "
                           f"shared memory, the geometry says {geo.smem_bytes}")
    return report, geo


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
