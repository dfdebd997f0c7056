"""A/B microbench: the wide-layout fused rhs against the per-dim kernel.

Counterpart of `scripts/proto_wide_rhs.py`. The per-dim kernels
(`ops/cuda_kernels.fused_rhs`) give every (row, output dim) to one warp; the
wide layout packs all output dims side by side into fat products (see
`ops/wide_rhs.py`). This entry point checks the three wide kernels against
the per-dim reference and its autograd, then times all variants.

Run on the card:

    python -m gpode_tpu_torch.scripts.proto_wide_rhs [--rows 2995]
        [--iters 200] [--m 100] [--s 256] [--d 5]

`--device cpu` runs the plain versions and stops after the error lines. A
mismatch (relative error of 3e-5 or more) or a failed launch exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import wide_rhs as wr
from gpode_tpu_torch.utils.timing import device_ms

MISMATCH = 3e-5
CHAIN_FWD, CHAIN_BWD = 100, 50
NAMES = ("dx", "dz", "dls", "dvar", "domega", "dphase", "dw", "dnu")


def make_inputs(n, din, d, m, s, device, seed=0):
    """x, z, lengthscales, variance, omega, phase, weights, nu in the public
    layouts, from a seeded generator (drawn on the host, then moved)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen)

    def uniform(*shape):
        return torch.rand(*shape, generator=gen)

    args = (normal(n, din), normal(m, din), 1.0 + uniform(d, din),
            0.5 + uniform(d), normal(din, s, d), uniform(1, s, d) * 6.28,
            normal(s, d), normal(d, m))
    return tuple(a.to(device) for a in args)


def rel_err(got, ref):
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-9))


def chain_us(fn, x0, length, iters):
    """Device microseconds per evaluation over `iters` launches, each fed by
    the previous one's output (x <- 1e-3 * out[:, :width] + x) in chains of
    `length` from x0; host launch overhead is kept out (`device_ms`)."""
    width = x0.shape[1]

    def run(count):
        xc = x0
        for i in range(count):
            if i % length == 0:
                xc = x0
            xc = fn(xc)[:, :width] * 1e-3 + xc
        return xc

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(length)                                   # warm-up, and host pace
    host_s = (time.perf_counter() - t0) / length
    return 1e3 * device_ms(run, iters, host_s)


def bench(variants, x0, length, iters):
    """{name: us/eval}, each variant timed twice - once in the given order,
    once in reverse, so no variant always runs on a colder card - and
    averaged."""
    names = list(variants)
    first = {n: chain_us(variants[n], x0, length, iters) for n in names}
    second = {n: chain_us(variants[n], x0, length, iters)
              for n in reversed(names)}
    out = {n: 0.5 * (first[n] + second[n]) for n in names}
    for n in names:
        print(f"{n}: {out[n]:.1f} us/eval (chained; rounds {first[n]:.1f}, "
              f"{second[n]:.1f})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2995)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--s", type=int, default=256)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    cli = ap.parse_args(argv)
    dev = resolve_device(cli.device)

    n, din, d, m, s = cli.rows, cli.d, cli.d, cli.m, cli.s
    args = make_inputs(n, din, d, m, s, dev)
    x, params = args[0], args[1:]
    failed = []

    with torch.no_grad():
        ref = ck.fused_rhs_plain(*args)
        e_wide = rel_err(wr.fused_rhs_wide(*args), ref)
        e_wide2 = rel_err(wr.fused_rhs_wide2(*args), ref)
    for name, err in (("wide", e_wide), ("wide2", e_wide2)):
        flag = "" if err < MISMATCH else "  <-- MISMATCH"
        print(f"{name} vs per-dim reference: max rel err {err:.3e}{flag}")
        failed += [name] * (err >= MISMATCH)

    g = torch.randn(n, d, generator=torch.Generator().manual_seed(42)).to(dev)
    leaves = [a.clone().requires_grad_() for a in args]
    cots_ref = torch.autograd.grad(ck.fused_rhs_plain(*leaves), leaves, g)
    cots_wide = wr.fused_rhs_wide_bwd(*args, g)
    for name, a, b in zip(NAMES, cots_wide, cots_ref):
        err = rel_err(a, b)
        flag = "" if err < MISMATCH else "  <-- MISMATCH"
        print(f"  bwd {name}: max rel err {err:.3e}{flag}")
        failed += [f"bwd {name}"] * (err >= MISMATCH)
    if dev.type == "cpu":
        return 1 if failed else 0

    with torch.no_grad():
        print(f"per-dim kernel vs per-dim reference: max rel err "
              f"{rel_err(ck.fused_rhs(*args), ref):.3e}")
        print(f"timing: CUDA events around {cli.iters} data-dependent launches "
              f"(forward chains of {CHAIN_FWD}, backward chains of "
              f"{CHAIN_BWD}) queued behind a spin kernel, so device time "
              f"only; operands are laid out once outside the chain; an "
              f"evaluation is one kernel (a backward also its slab "
              f"reduction) plus the chain update; two rounds, the second in "
              f"reverse order, averaged")
        dims = (din, d, m, s)
        ops = ck._kernel_operands(*params)
        b, phase_w, zn_w, invls2_t, wblk, sp, mp = wr.kernel_pack(*params)
        flat = wr.wide_flat_weights(wblk, d, sp, mp)
        packed = (b, phase_w, zn_w, invls2_t)
        t = bench({
            "per-dim kernel": lambda xc: ck._launch_rhs_fwd(xc, ops, *dims),
            "wide kernel": lambda xc: wr.launch_wide_fwd(
                xc, *packed, wblk, d, sp, mp, dense=True),
            "wide2 kernel (multiply-reduce)": lambda xc: wr.launch_wide_fwd(
                xc, *packed, flat, d, sp, mp, dense=False),
            "plain path": lambda xc: ck.fused_rhs_plain(xc, *params),
        }, x, CHAIN_FWD, cli.iters)
        print(f"fwd speedup wide vs per-dim: "
              f"{t['per-dim kernel'] / t['wide kernel']:.2f}x; wide2 vs per-dim: "
              f"{t['per-dim kernel'] / t['wide2 kernel (multiply-reduce)']:.2f}x; "
              f"wide vs plain: {t['plain path'] / t['wide kernel']:.2f}x")
        tb = bench({
            "per-dim bwd kernel": lambda gc: ck._launch_rhs_bwd_packed(
                x, gc, ops, *dims)[0],
            "wide bwd kernel": lambda gc: wr.launch_wide_bwd(
                x, gc, *packed, wblk, d, sp, mp)[0],
        }, g, CHAIN_BWD, max(1, cli.iters // 2))
        print(f"bwd speedup wide vs per-dim: "
              f"{tb['per-dim bwd kernel'] / tb['wide bwd kernel']:.2f}x")
    if failed:
        print(f"MISMATCH in: {', '.join(failed)}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
