"""The posterior draw's own-factor solves (`cuda_kernels.draw_solve`: the
`draw_solve` kernels of `csrc/draw_solve.cu` on a card), on the CPU.

The CPU path (`gp.draw_solve_plain`) is the library chain bit for bit,
through `draw_posterior` too; the kernels' VJP written as tensor ops
(`draw_solve_bwd_plain`) against autograd through the chain, by float64
gradcheck and in float32 at the main path's shape, and the kernels' rule
first order only; the packed layout's plain versions (past M = 128: the
forward by panels, `draw_solve_fwd_plain`, and the backward by slabs)
against the float64 chain at the `scale` preset's M=256; the route
(`gp.draw_solve_on_device`): a given factor and `kernels=False` keep the
library's solves, the solver's rule reaches the draw, a refused draw is
logged once and takes the library path, each draw counted in
`cuda_kernels.DRAW_SOLVES`; the kernels' geometry and refusals, their
ctypes signatures against the C entry points, and the benchmark's reader
of the counter (`device_draw_solves_pct`).
"""

import importlib.util
import logging
import os
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gpode_tpu_torch.models import gp
from gpode_tpu_torch.ops import cuda_build
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.kernels import rbf_K

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "gpode_tpu_torch" / "csrc" / "draw_solve.cu"
D, M = 5, 100   # the main path's factors: MoCap's 5 latents, 100 inducing points


def _gp(m=M, d=D, dimwise=True, dtype=torch.float32, seed=0, din=None):
    gen = torch.Generator().manual_seed(seed)
    params = gp.init_svgp(gen, d if din is None else din, d, m,
                          dimwise=dimwise)
    with torch.no_grad():
        params.u_tril.add_(0.05 * torch.randn(params.u_tril.shape, generator=gen))
    return params.to(dtype)


def _noise(params, draws, seed=1, num_features=16):
    """draw_posterior's noise with `draws` leading draws (() for one)."""
    gen = torch.Generator().manual_seed(seed)
    din, d, m = params.z.shape[1], params.u_mean.shape[1], params.num_inducing
    dt = params.z.dtype
    if params.dimwise:
        freq, phase = (din, num_features, d), (1, num_features, d)
    else:
        freq, phase = (din, num_features), (1, num_features)
    return (torch.randn(*draws, num_features, d, generator=gen, dtype=dt),
            torch.randn(*draws, *freq, generator=gen, dtype=dt),
            torch.rand(*draws, *phase, generator=gen, dtype=dt),
            torch.randn(*draws, m, d, generator=gen, dtype=dt))


def _chain(params, noise, chol=None):
    """`draw_posterior`'s coefficients as the draw made them before the
    kernels: precompute_chol, then the two library solves."""
    weights, freq, phase_u, inducing = noise
    omega = gp.rbf_sample_freq(params.kernel, freq)
    phase = 2.0 * torch.pi * phase_u
    v = gp.sample_inducing(params, inducing)
    chol = gp.precompute_chol(params) if chol is None else chol
    u_prior = gp.rff_eval(params, omega, phase, weights, params.z)
    if params.dimwise:
        a = om.solve_lower(chol, u_prior.mT[..., None])
        return om.solve_upper_from_lower(chol, v.mT[..., None] - a)[..., 0]
    a = om.solve_lower(chol, u_prior)
    return om.solve_upper_from_lower(chol, v - a).mT


def _operands(m, b, r, dtype, seed=0):
    """K(Z, Z) of an initialised dimwise GP (b factors, Z in 5-D), u and v
    (b, r, m)."""
    params = _gp(m, b, dtype=dtype, seed=seed, din=D)
    gen = torch.Generator().manual_seed(seed + 7)
    k3 = rbf_K(params.kernel, params.z).detach()
    u = torch.randn(b, r, m, generator=gen, dtype=dtype)
    v = torch.randn(b, r, m, generator=gen, dtype=dtype)
    return k3, u, v


class _PlainVJP(torch.autograd.Function):
    """`draw_solve`'s autograd rule with the plain versions: the library's
    factor and solves forward, `draw_solve_bwd_plain` backward, in the
    kernels' layout (K (B, M, M), u and v (B, R, M))."""

    @staticmethod
    def forward(ctx, k3, u, v, jitter):
        L = om.cholesky_jittered(k3, jitter)
        a = om.solve_lower(L, u.mT)
        ctx.save_for_backward(L, a.mT, v)
        return om.solve_upper_from_lower(L, v.mT - a).mT

    @staticmethod
    def backward(ctx, g_nu):
        return ck.draw_solve_bwd_plain(*ctx.saved_tensors, g_nu) + (None,)


class _PackedPlainVJP(torch.autograd.Function):
    """The packed layout's autograd rule with its plain versions: the
    forward by panels of 32 columns (`draw_solve_fwd_plain`), the backward
    by slabs of `slab` columns and rows (`draw_solve_bwd_plain`)."""

    @staticmethod
    def forward(ctx, k3, u, v, jitter, slab):
        L, a, nu = ck.draw_solve_fwd_plain(k3, u, v, jitter)
        ctx.save_for_backward(L, a, v)
        ctx.slab = slab
        return nu

    @staticmethod
    def backward(ctx, g_nu):
        return ck.draw_solve_bwd_plain(*ctx.saved_tensors, g_nu,
                                       slab=ctx.slab) + (None, None)


def _chain_columns(k3, u, v):
    """`draw_solve_plain` on operands in the kernels' layout: factor b's
    columns (B, R, M) are dim b of R draws (R, M, B); nu back to (B, R, M)."""
    return gp.draw_solve_plain(k3, u.permute(1, 2, 0),
                               v.permute(1, 2, 0)).transpose(0, 1)


@pytest.mark.parametrize("draws", [(), (32,)], ids=["R1", "R32"])
def test_plain_forward_is_the_library_chain_bit_for_bit(draws):
    """`draw_solve_plain` (the CPU path) is the library chain, and
    `draw_posterior` without a factor still gives the chain's coefficients
    bit for bit, at the main path's D=5 factors of M=100; the kernels'
    wrapper takes no CPU tensor."""
    params = _gp()
    noise = _noise(params, draws)
    want = _chain(params, noise)
    draw = gp.draw_posterior(params, *noise)
    assert torch.equal(draw.nu, want)
    u_prior = gp.rff_eval(params, draw.omega, draw.phase, draw.weights,
                          params.z)
    v = gp.sample_inducing(params, noise[3])
    got = gp.draw_solve_plain(rbf_K(params.kernel, params.z), u_prior, v)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="runs on a card"):
        ck.draw_solve(rbf_K(params.kernel, params.z), u_prior, v)


def test_shared_kernel_draw_is_the_library_chain_bit_for_bit():
    """A shared-kernel GP: one factor, every draw's D columns on it."""
    params = _gp(m=12, d=3, dimwise=False)
    noise = _noise(params, (4,))
    assert torch.equal(gp.draw_posterior(params, *noise).nu,
                       _chain(params, noise))


@pytest.mark.parametrize("m,b,r", [(8, 2, 1), (13, 1, 3), (16, 3, 2)])
def test_hand_written_vjp_passes_gradcheck(m, b, r):
    """`draw_solve_bwd_plain`, the arithmetic of the backward kernel, is
    the derivative of the forward: float64 gradcheck of the library forward
    with that backward in K, u and v. K enters
    symmetrised, as K(Z, Z) is: the factor reads its lower triangle, and
    the VJP is the symmetric one of `torch.linalg.cholesky`."""
    k3, u, v = _operands(m, b, r, torch.float64)
    args = [t.clone().requires_grad_() for t in (k3, u, v)]
    assert torch.autograd.gradcheck(
        lambda k, uu, vv: _PlainVJP.apply(0.5 * (k + k.mT), uu, vv,
                                                1e-5), args)


@pytest.mark.parametrize("r", [1, 32])
def test_hand_written_vjp_against_autograd_in_float32(r):
    """At D=5 factors of M=100 in float32, the hand-written VJP and autograd
    through the library chain agree to 1e-5 of each cotangent's largest
    entry (they read 6e-7 apart); both lie within 2e-4 of the float64
    chain (4.5e-5 at most), the hand-written one no further than the
    chain."""
    k3, u, v = _operands(M, D, r, torch.float32)
    g = torch.randn(D, r, M, generator=torch.Generator().manual_seed(3))

    def grads(fn, dtype):
        args = [t.to(dtype).requires_grad_() for t in (k3, u, v)]
        nu = fn(*args)
        return torch.autograd.grad(nu, args, g.to(dtype))

    hand = grads(lambda k, uu, vv: _PlainVJP.apply(k, uu, vv, 1e-5),
                 torch.float32)
    auto = grads(_chain_columns, torch.float32)
    exact = grads(_chain_columns, torch.float64)
    for h, a, e in zip(hand, auto, exact):
        scale = float(a.abs().max())
        assert float((h - a).abs().max()) <= 1e-5 * scale
        err_hand = float((h.double() - e).abs().max()) / scale
        err_auto = float((a.double() - e).abs().max()) / scale
        assert err_hand <= 2e-4 and err_auto <= 2e-4
        assert err_hand <= 1.5 * err_auto + 1e-6


@pytest.mark.parametrize("m,b,r,slab", [(9, 2, 1, 4), (13, 1, 3, 5),
                                         (40, 2, 2, 32)])
def test_packed_plain_vjp_passes_gradcheck(m, b, r, slab):
    """The packed layout's plain versions (the forward by panels, the
    backward by slabs of `slab`) are the derivative of the forward: float64
    gradcheck in K, u and v, K symmetrised."""
    k3, u, v = _operands(m, b, r, torch.float64)
    args = [t.clone().requires_grad_() for t in (k3, u, v)]
    assert torch.autograd.gradcheck(
        lambda k, uu, vv: _PackedPlainVJP.apply(0.5 * (k + k.mT), uu, vv,
                                                1e-5, slab), args)


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("m", [129, 200, 256])
def test_packed_plain_against_the_float64_chain(m, r):
    """Past M = 128 (the packed layout, the `scale` preset's M=256): at D=5
    factors in float32, nu and its cotangents by the packed kernels' plain
    versions (forward by panels, backward by slabs of 32) lie within 2e-3
    of the float64 chain's largest entry and no further from it than the
    float32 chain (they read 5.5e-5 to 1.1e-3, the chain 1.3e-4 to 3.0e-3:
    past 2e-3 at M=256)."""
    k3, u, v = _operands(m, D, r, torch.float32)
    g = torch.randn(D, r, m, generator=torch.Generator().manual_seed(3))

    def run(fn, dtype):
        args = [t.to(dtype).requires_grad_() for t in (k3, u, v)]
        nu = fn(*args)
        return (nu.detach(),) + torch.autograd.grad(nu, args, g.to(dtype))

    slab = ck._DRAW_SOLVE_SLAB_COLS
    packed = run(lambda k, uu, vv: _PackedPlainVJP.apply(k, uu, vv, 1e-5, slab),
                 torch.float32)
    chain = run(_chain_columns, torch.float32)
    exact = run(_chain_columns, torch.float64)
    for name, p, c, e in zip(("nu", "g_K", "g_u", "g_v"), packed, chain, exact):
        scale = float(e.abs().max())
        err = float((p.double() - e).abs().max()) / scale
        chain_err = float((c.double() - e).abs().max()) / scale
        assert err <= 2e-3 and err <= 1.5 * chain_err + 1e-5, (name, err,
                                                              chain_err)


def test_panel_forward_is_the_factor_and_solves():
    """`draw_solve_fwd_plain` (the kernels' panel order, both layouts) in
    float64 is the library factor and solves: L, a = L^{-1} u and nu, to
    1e-12, at an M that leaves a partial last panel."""
    k3, u, v = _operands(70, 2, 3, torch.float64)
    L, a, nu = ck.draw_solve_fwd_plain(k3, u, v, 1e-5)
    want_l = om.cholesky_jittered(k3, 1e-5)
    want_a = om.solve_lower(want_l, u.mT).mT
    for got, want in ((L, want_l), (a, want_a), (nu, _chain_columns(k3, u, v))):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_hand_written_forward_layout_matches_the_chain():
    """The kernels' layout (B, R, M) is the chain on the columns: the same
    coefficients as `draw_solve_plain`."""
    k3, u, v = _operands(20, 3, 4, torch.float64)
    torch.testing.assert_close(_PlainVJP.apply(k3, u, v, 1e-5),
                               _chain_columns(k3, u, v), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dimwise", [True, False], ids=["dimwise", "shared"])
def test_layout_round_trip(dimwise):
    """The wrapper's columns: a dimwise factor d takes dim d of every draw,
    the shared factor every draw's D columns, and the coefficients return
    to (..., D, M)."""
    lead, m, d = (2, 3), 7, 4
    t = torch.arange(2 * 3 * m * d, dtype=torch.float32).reshape(*lead, m, d)
    kzz = torch.zeros(d, m, m) if dimwise else torch.zeros(m, m)
    cols = ck._to_columns(kzz, t)
    assert cols.shape == ((d, 6, m) if dimwise else (1, 6 * d, m))
    back = ck._from_columns(kzz, cols, lead, d)
    assert torch.equal(back, t.mT)
    if dimwise:
        assert torch.equal(cols[1, 4], t.reshape(6, m, d)[4, :, 1])


def test_a_given_factor_keeps_the_library_solves():
    """`draw_posterior` handed a factor (as `gpode.predict` and the
    initialiser hand theirs) solves on it with the library, counted as
    "library"; one without a factor on the CPU is counted there too."""
    params = _gp()
    noise = _noise(params, (3,))
    chol = gp.precompute_chol(params)
    before = dict(ck.DRAW_SOLVES)
    draw = gp.draw_posterior(params, *noise, chol)
    assert torch.equal(draw.nu, _chain(params, noise, chol))
    gp.draw_posterior(params, *noise)
    assert ck.DRAW_SOLVES == {"device": before["device"],
                              "library": before["library"] + 2}


def _card_like(shape, dtype=torch.float32):
    """What `draw_solve_on_device` reads of K(Z, Z), as a card's tensor."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                           ndim=len(shape), shape=shape)


def test_a_refused_draw_is_logged_once_and_takes_the_library(monkeypatch,
                                                             caplog):
    """On a card, M=257 (past the packed layout) and float64 are refused:
    each reason logged once, the draw sent to the library; M=100 and M=256
    (the `scale` preset) in float32 are taken. Off the card nothing is
    asked or logged. A refused M=257 draw is the library chain."""
    monkeypatch.setattr(gp, "_REFUSALS_LOGGED", set())
    u257 = torch.zeros(257, D)
    with caplog.at_level(logging.WARNING, logger=gp.__name__):
        for _ in range(2):
            assert not gp.draw_solve_on_device(_card_like((D, 257, 257)), u257)
            assert not gp.draw_solve_on_device(
                _card_like((D, M, M), torch.float64),
                torch.zeros(M, D, dtype=torch.float64))
        assert gp.draw_solve_on_device(_card_like((D, M, M)), torch.zeros(M, D))
        assert gp.draw_solve_on_device(_card_like((D, 256, 256)),
                                       torch.zeros(256, D))
        assert not gp.draw_solve_on_device(torch.zeros(D, M, M),
                                           torch.zeros(M, D))
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == 2
    assert "M <= 256" in messages[0] and "float64" in messages[1]
    params = _gp(m=257)
    noise = _noise(params, ())
    assert torch.equal(gp.draw_posterior(params, *noise).nu,
                       _chain(params, noise))


@pytest.mark.parametrize("case", ["float32", "kernels_off", "float64"])
def test_the_route_at_the_scale_preset(case):
    """At the `scale` preset's draw on a card (one draw on D factors of
    M=256): float32 takes the kernels (the packed layout), `kernels=False`
    and float64 the library."""
    dtype = torch.float64 if case == "float64" else torch.float32
    rule = False if case == "kernels_off" else None
    taken = gp.draw_solve_on_device(_card_like((D, 256, 256), dtype),
                                    torch.zeros(256, D, dtype=dtype), rule)
    assert taken == (case == "float32")
    if taken:
        assert ck.draw_solve_geometry(D, 256, 1).layout == "packed"


@pytest.mark.parametrize("kernels", [None, True, False],
                         ids=["auto", "on", "off"])
def test_the_kernel_rule_reaches_the_draw(monkeypatch, kernels):
    """`SolverConfig.kernels` decides the draw too: on a card a shape the
    kernels take goes to them unless the rule is False. The shooting and
    vanilla ELBOs hand their solver's rule through `draw_posterior`."""
    from gpode_tpu_torch.models import flow, gpode
    from gpode_tpu_torch.models.shooting import elbo_loss, sample_step_noise
    from gpode_tpu_torch.train.builders import (ModelArgs, build_gpode,
                                                build_shooting)

    assert gp.draw_solve_on_device(_card_like((D, M, M)), torch.zeros(M, D),
                                   kernels) == (kernels is not False)
    seen, route = [], gp.draw_solve_on_device
    monkeypatch.setattr(gp, "draw_solve_on_device", lambda kzz, u, rule: (
        seen.append(rule), route(kzz, u, rule))[1])
    args = ModelArgs(num_features=8, num_inducing=6)
    ys = torch.randn(2, 4, 2, generator=torch.Generator().manual_seed(0))
    ts = 0.1 * torch.arange(4, dtype=torch.float32)
    cfg = flow.SolverConfig(kernels=kernels)
    gen = torch.Generator().manual_seed(1)
    shoot = build_shooting(gen, args, ys.numpy(), device="cpu")
    elbo_loss(shoot, sample_step_noise(shoot, 8, 2, gen), ys, ts, cfg)
    vanilla = build_gpode(gen, args, ys.numpy(), device="cpu")
    gpode.elbo_loss(vanilla, gpode.sample_gpode_step_noise(vanilla, 8, gen),
                    ys, ts, cfg)
    assert seen == [kernels, kernels]


@pytest.mark.parametrize("b,m,r,ok", [
    (5, 100, 1, True), (5, 100, 126, True), (5, 100, 127, False),
    (1, 128, 32, True), (1, 128, 65, True), (1, 128, 66, False),
    (1, 129, 1, True), (1, 129, 128, True), (1, 129, 129, False),
    (5, 256, 1, True), (5, 256, 32, True), (5, 256, 33, False),
    (1, 257, 1, False), (2, 1, 1, True), (1, 32, 400, True),
    (0, 10, 1, False), (1, 10, 0, False)])
def test_geometry_takes_and_refuses(b, m, r, ok):
    """M up to 128 on the square layout (four row slots of 32, one block a
    factor both ways), up to 256 on the packed one (eight), and R columns
    as far as every kernel's shared memory, laid out as csrc/draw_solve.cu
    lays it, fits one block's (R <= 32 at M=256: the backward's columns
    kernel); `draw_solve_refusal` says the same of b factors of a draw's r
    columns."""
    reason = ck.draw_solve_refusal(torch.zeros(b, m, m), torch.zeros(r, m, b))
    assert (reason is None) == ok
    if not ok:
        with pytest.raises(ValueError):
            ck.draw_solve_geometry(b, m, r)
        return
    geo = ck.draw_solve_geometry(b, m, r)
    ld, tri = m | 1, m * (m + 1) // 2
    if m <= 128:
        assert geo.layout == "square"
        assert geo.fwd_smem_bytes == 4 * ((m + r) * ld + m)
        assert geo.bwd_smem_bytes == 4 * (2 * m * ld + 3 * r * m + m)
    else:
        assert geo.layout == "packed"
        assert geo.fwd_smem_bytes == 4 * (-(-(tri + r * ld + m) // 4) * 4
                                          + 36 * (m + r))
        assert geo.bwd_smem_bytes == 4 * (tri + 3 * r * m + m)
    assert max(geo.fwd_smem_bytes, geo.bwd_smem_bytes) <= ck.MAX_SMEM_BYTES


def test_geometry_at_the_scale_preset_and_past_it():
    """B=5, M=256, R=1 (the `scale` step's draw) takes the packed layout:
    170,656 bytes forward, 135,680 in the backward's columns kernel;
    M=257 is refused with its reason; M <= 128 stays on the square layout,
    one block a factor."""
    geo = ck.draw_solve_geometry(5, 256, 1)
    assert (geo.layout, geo.fwd_smem_bytes, geo.bwd_smem_bytes) == (
        "packed", 170656, 135680)
    with pytest.raises(ValueError, match=r"M <= 256 .*got M=257"):
        ck.draw_solve_geometry(5, 257, 1)
    for m in (1, 100, 128):
        assert ck.draw_solve_geometry(5, m, 1).layout == "square"
    assert ck.draw_solve_geometry(5, 129, 1).layout == "packed"


def test_refusal_reads_the_draw_shape():
    """R is the draws of a dimwise GP's factor and the draws times D of a
    shared one."""
    k = torch.zeros(D, M, M)
    assert ck.draw_solve_refusal(k, torch.zeros(126, M, D)) is None
    assert "R=127" in ck.draw_solve_refusal(k, torch.zeros(127, M, D))
    shared = torch.zeros(M, M)
    assert ck.draw_solve_refusal(shared, torch.zeros(25, M, D)) is None
    assert "R=130" in ck.draw_solve_refusal(shared, torch.zeros(26, M, D))


def _source():
    return SOURCE.read_text()


def _c_parameters(text, fn):
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    return [p.strip() for p in params.split(",")]


@pytest.mark.parametrize("fn", sorted(ck._SIGNATURES["draw_solve"]))
def test_ctypes_signatures_match_the_c_entry_points(fn):
    """Pointers (and the stream) as void pointers, ints as ints, the jitter
    as a float, as the C declarations say."""
    want = [ck._P if "*" in p else ck._F if p.startswith("float ") else ck._I
            for p in _c_parameters(_source(), fn)]
    assert ck._SIGNATURES["draw_solve"][fn] == want


def test_the_source_states_its_limits_and_builds_with_the_others():
    """The C limits are the wrapper's, every kernel the occupancy query
    names exists, and the library builds with the others and counts
    launches of both layouts."""
    text = _source()
    for macro, value in (("MAX_ROWS", ck._DRAW_SOLVE_MAX_ROWS),
                         ("PACKED_ROWS", ck._DRAW_SOLVE_PACKED_ROWS),
                         ("SLAB_WARPS", ck._DRAW_SOLVE_SLAB_COLS // 4),
                         ("BWD_COLS", 4),
                         ("PANEL_STRIDE", ck._DRAW_SOLVE_PANEL_STRIDE)):
        assert re.search(rf"#define {macro} (\d+)", text).group(1) == str(value)
    for name, _ in ck.DRAW_SOLVE_KERNELS.values():
        assert re.search(rf"\b{name}\(", text), name
    assert "atomicAdd" not in text
    assert cuda_build.SOURCES["draw_solve"] == SOURCE.name
    assert {"draw_solve_fwd", "draw_solve_bwd", "draw_solve_fwd_packed",
            "draw_solve_bwd_slabs"} <= set(ck.LAUNCHES)


def test_double_backward_raises(monkeypatch):
    """The kernels' autograd rule is first order only (launchers
    monkeypatched: the plain versions stand in for the kernels)."""
    monkeypatch.setattr(ck, "_draw_solve_fwd", lambda k3, u, v, jitter: (
        om.cholesky_jittered(k3, jitter), u, u + v))
    k3, u, v = _operands(8, 1, 1, torch.float64)
    args = [t.clone().requires_grad_() for t in (k3, u, v)]
    nu = ck._DrawSolveFn.apply(*args, 1e-5)
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(nu.sum(), args, create_graph=True)


def _reader():
    path = ROOT / "benchmark" / "metrics" / "device_draw_solves_pct.py"
    spec = importlib.util.spec_from_file_location("device_draw_solves_pct",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("device,library,pct",
                         [(22000, 0, 100.0), (0, 5, 0.0), (300, 100, 75.0)])
def test_reader_share_of_draws_on_the_device(monkeypatch, device, library,
                                             pct):
    monkeypatch.setattr(ck, "DRAW_SOLVES", {"device": device,
                                            "library": library})
    got = _reader().read(SimpleNamespace(trace=None, on_device=True))
    assert got == pytest.approx(pct)


@pytest.mark.parametrize("case", ["cpu", "no_counter", "no_draw"])
def test_reader_nothing_to_read(monkeypatch, case):
    counts = {"device": 0, "library": 0} if case == "no_draw" else {
        "device": 7, "library": 1}
    monkeypatch.setattr(ck, "DRAW_SOLVES", counts)
    if case == "no_counter":
        monkeypatch.delattr(ck, "DRAW_SOLVES")
    ctx = SimpleNamespace(trace=None, on_device=case != "cpu")
    assert _reader().read(ctx) is None


def test_capture_counts_draws_like_launches():
    """A capture's draws are taken back out of `cuda_kernels.DRAW_SOLVES`
    with its launches and each replay adds them again (`ops/capture.py`);
    the two counters' keys are disjoint."""
    from gpode_tpu_torch.ops import capture
    assert not set(ck.DRAW_SOLVES) & set(ck.LAUNCHES)
    draws, launches = dict(ck.DRAW_SOLVES), dict(ck.LAUNCHES)
    take = capture.launch_counter()
    ck.DRAW_SOLVES["device"] += 1
    ck.LAUNCHES["draw_solve_fwd"] += 1
    delta = take()
    assert delta == {"draw_solve_fwd": 1, "device": 1}
    assert ck.DRAW_SOLVES == draws and ck.LAUNCHES == launches
    for _ in range(3):
        capture.replay_launches(delta)
    assert ck.DRAW_SOLVES["device"] == draws["device"] + 3
    assert ck.LAUNCHES["draw_solve_fwd"] == launches["draw_solve_fwd"] + 3
