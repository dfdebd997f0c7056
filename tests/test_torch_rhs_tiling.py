"""Launch geometry of the `fused_rhs` kernels and the dispatch rule that asks
it.

`gpode_tpu_torch.ops.cuda_kernels.rhs_fwd_geometry` / `rhs_bwd_geometry` are
pure arithmetic, checked on the CPU against the limits `csrc/fused_rhs.cu`
states: tiles cover every row, a block fits the card (threads within the
variant's bound, shared memory under 227 KB), Din may differ from D, each
width takes the narrowest variant the source instantiates, and a shape the
kernels do not take raises before anything is launched.

The dispatch rule (`models/gp.kernel_rhs_active`, `models/flow`) takes a
kernel exactly where the geometries of both its directions take the shape,
for the rk4 segment, the dopri5 attempt and `fused_rhs` (`eval_draw`, Din !=
D too); any other shape takes the plain path.
"""

import dataclasses
import logging
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from gpode_tpu_torch.models import flow, gp
from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops.ode import FIRST_STEP_SPAN

torch.set_num_threads(1)

# (N, Din, D, M, S): the train step's shapes, the card tests' others, Din !=
# D both ways, and the widest D the backward takes (square at the bench's M
# and S; any Din <= 5 with its 640-thread variant)
SHAPES = {
    "official": (3000, 5, 5, 100, 256),
    "m256": (3000, 5, 5, 256, 256),
    "ragged_n37": (37, 5, 5, 100, 256),
    "one_row": (1, 5, 5, 100, 256),
    "rows2995": (2995, 5, 5, 100, 256),
    "ragged_units": (203, 5, 5, 40, 100),
    "din3_d5": (300, 3, 5, 100, 256),
    "din8_d2": (300, 8, 2, 100, 256),
    "widest_square_d11": (300, 11, 11, 100, 256),
    "widest_d20": (300, 4, 20, 40, 64),
    "tiny": (50, 2, 2, 16, 32),
}
SMS = 132   # multiprocessors of an H100 SXM


def _align4(v):
    return (v + 3) & ~3


def _acc(din, m, s):
    return din * s + 2 * s + m + m * din


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_geometry_covers_rows_and_fits_the_card(shape):
    n, din, d, m, s = SHAPES[shape]
    geo = ck.rhs_fwd_geometry(n, din, d, m, s)
    # one tile per block, every row in exactly one block
    assert geo.blocks == math.ceil(n / geo.rt)
    assert (geo.blocks - 1) * geo.rt < n <= geo.blocks * geo.rt
    # the variant: loops over Din reach it, a tile's row sums fit one fold
    assert (geo.dp, geo.rt, geo.maxt) in ck.RHS_VARIANTS["fwd"]
    assert din <= geo.dp and 2 * geo.rt <= 32
    # the block: G groups of D warps within the variant's thread bound, and
    # no warp without a 32-column unit of its dim
    assert geo.threads == 32 * d * geo.groups
    assert geo.groups >= 1 and geo.threads <= geo.maxt <= 1024
    assert geo.groups <= math.ceil(s / 32) + math.ceil(m / 32)
    # shared memory: x tile | 1/lengthscale (D, DP) | the warps' row sums
    assert geo.smem_bytes == 4 * (geo.rt * _align4(geo.dp) + _align4(d * geo.dp)
                                  + 32 * d * geo.groups)
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_geometry_covers_rows_and_fits_the_card(shape, sms):
    n, din, d, m, s = SHAPES[shape]
    geo = ck.rhs_bwd_geometry(n, din, d, m, s, sms)
    # whole tiles per block, every row in exactly one block
    assert geo.rows_per_block % geo.rt == 0 and geo.rows_per_block >= geo.rt
    assert (geo.blocks - 1) * geo.rows_per_block < n <= geo.blocks * geo.rows_per_block
    assert geo.blocks <= ck._RHS_BWD_BLOCKS_PER_SM * sms
    # the variant: loops over Din reach it, a tile's dx shares fit one fold
    assert (geo.dp, geo.rt, geo.maxt) in ck.RHS_VARIANTS["bwd"]
    assert din <= geo.dp and geo.rt * geo.dp <= 32
    assert geo.threads == 32 * d * geo.groups
    assert geo.groups >= 1 and geo.threads <= geo.maxt <= 1024
    assert geo.groups <= math.ceil(s / 32) + math.ceil(m / 32)
    # shared memory: x tile | g tile (RT, D) | il | accumulators | dls | dxw
    warps = d * geo.groups
    assert geo.smem_bytes == 4 * (
        geo.rt * _align4(geo.dp) + _align4(geo.rt * d) + _align4(d * geo.dp)
        + _align4(d * _acc(din, m, s)) + 32 * geo.dp * warps + 32 * warps)
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES
    # scratch: one slab per (block, dim)
    assert geo.part_main_floats == geo.blocks * d * (din * s + 2 * s + m + din + 1)
    assert geo.part_dz_floats == geo.blocks * d * m * din


def test_main_path_geometry():
    """At the bench shapes: the exact-width variants, 10-warp forward blocks
    of 8-row tiles (more blocks than SMs) and at most one 20-warp backward
    block per SM, each with several tiles."""
    n, din, d, m, s = SHAPES["official"]
    fwd = ck.rhs_fwd_geometry(n, din, d, m, s)
    assert (fwd.dp, fwd.rt, fwd.maxt, fwd.threads, fwd.blocks) == (5, 8, 1024, 320, 375)
    bwd = ck.rhs_bwd_geometry(n, din, d, m, s, SMS)
    assert (bwd.dp, bwd.rt, bwd.maxt, bwd.threads) == (5, 6, 640, 640)
    assert bwd.blocks <= ck._RHS_BWD_BLOCKS_PER_SM * SMS
    assert bwd.rows_per_block >= 2 * bwd.rt


FWD_REFUSED = [
    ((100, 17, 5, 100, 256), "Din <= 16"),
    ((100, 0, 5, 100, 256), "Din <= 16"),
    ((0, 5, 5, 100, 256), r"N, D, M, S >= 1"),
    ((100, 5, 0, 100, 256), r"N, D, M, S >= 1"),
    ((100, 5, 5, 0, 256), r"N, D, M, S >= 1"),
    ((100, 5, 5, 100, 0), r"N, D, M, S >= 1"),
    ((100, 4, 33, 16, 32), "D <= 32"),       # the 1024-thread variants
    ((100, 9, 17, 16, 32), "D <= 16"),       # the 512-thread variant
]
BWD_REFUSED = FWD_REFUSED[:-2] + [
    ((100, 4, 21, 40, 64), "D <= 20"),       # the 640-thread variant
    ((100, 8, 17, 40, 64), "D <= 16"),       # the 512-thread variant
    ((100, 12, 12, 100, 256), "shared memory"),
    ((100, 5, 5, 4000, 256), "shared memory"),
]


@pytest.mark.parametrize("args,match", FWD_REFUSED,
                         ids=["din17", "din0", "no_rows", "no_dims",
                              "no_inducing", "no_features", "din4_d33",
                              "din9_d17"])
def test_unsupported_forward_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ck.rhs_fwd_geometry(*args)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("args,match", BWD_REFUSED,
                         ids=["din17", "din0", "no_rows", "no_dims",
                              "no_inducing", "no_features", "din4_d21",
                              "din8_d17", "d12_smem", "m4000_smem"])
def test_unsupported_backward_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ck.rhs_bwd_geometry(*args, SMS)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("din,fwd,bwd", [
    (1, (4, 8, 1024), (4, 4, 640)), (4, (4, 8, 1024), (4, 4, 640)),
    (5, (5, 8, 1024), (5, 6, 640)), (6, (8, 8, 1024), (8, 4, 512)),
    (8, (8, 8, 1024), (8, 4, 512)), (9, (16, 4, 512), (16, 1, 512)),
    (16, (16, 4, 512), (16, 1, 512)),
])
def test_each_width_takes_the_narrowest_instantiated_variant(din, fwd, bwd):
    """(loop bound over Din, rows per tile, thread bound) by Din, whatever
    D is; the block stays within the bound."""
    for d in (1, din, 16):
        f = ck.rhs_fwd_geometry(300, din, d, 16, 64)
        b = ck.rhs_bwd_geometry(300, din, d, 16, 64, SMS)
        assert (f.dp, f.rt, f.maxt) == fwd and f.threads <= f.maxt
        assert (b.dp, b.rt, b.maxt) == bwd and b.threads <= b.maxt


def _source():
    return (pathlib.Path(ck.__file__).parents[1] / "csrc" / "fused_rhs.cu").read_text()


@pytest.mark.parametrize("direction,macro", [("fwd", "RHS_FWD_VARIANTS"),
                                             ("bwd", "RHS_BWD_VARIANTS")])
def test_source_instantiates_the_variants_the_geometry_selects(direction, macro):
    line = re.search(rf"#define {macro}\(X\)(.*)", _source()).group(1)
    built = tuple(tuple(map(int, v)) for v in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", line))
    assert built == ck.RHS_VARIANTS[direction]


def test_rhs_kernel_tables_name_every_kernel_once():
    """The occupancy queries and ptxas entry names that `chip_smoke.py`
    reads for the two `fused_rhs` kernels: each exists in the source."""
    text = _source()
    assert set(ck.RHS_KERNELS) == set(ck.RHS_VARIANTS) == {"fwd", "bwd"}
    for lib, kernel, query in ck.RHS_KERNELS.values():
        assert lib == "fused_rhs"
        assert re.search(rf"\b{kernel}\(", text)
        assert f'extern "C" int {query}(' in text
        assert query in ck._SIGNATURES[lib]


def _accepts(kernel, n, din, d, m, s):
    """Both directions' geometries take the shape (asked directly)."""
    stages = ck.KERNEL_STAGES[kernel]
    try:
        if stages is None:
            ck.rhs_fwd_geometry(n, din, d, m, s)
            ck.rhs_bwd_geometry(n, din, d, m, s, SMS)
        else:
            ck.segment_fwd_geometry(n, din, d, m, s, stages)
            ck.segment_bwd_geometry(n, din, d, m, s, stages, SMS)
    except ValueError:
        return False
    return True


def test_kernel_refusal_asks_both_directions():
    # D = 21 at Din = 4: the forward takes it, the backward does not
    assert _accepts("fused_rhs", 300, 4, 20, 40, 64)
    ck.rhs_fwd_geometry(300, 4, 21, 40, 64)
    assert "backward" in ck.kernel_refusal("fused_rhs", 300, 4, 21, 40, 64)
    # D = 12 at the bench's M and S: the segment forwards take it, their
    # backwards do not
    for kernel, stages in (("rk4_segment", 4), ("dopri5_attempt", 6)):
        ck.segment_fwd_geometry(2970, 12, 12, 100, 256, stages)
        assert "shared memory" in ck.kernel_refusal(kernel, 2970, 12, 12, 100, 256)
        assert "forward" in ck.kernel_refusal(kernel, 2970, 17, 17, 100, 256)
    assert ck.kernel_refusal("fused_rhs", 3000, 5, 5, 100, 256) is None


# ---------------------------------------------------------------------------
# The dispatch rule
# ---------------------------------------------------------------------------

M, S, ROWS = 100, 256, 2970
CONFIGS = {
    "rk4_segment": flow.SolverConfig(solver="rk4", ts_dense_scale=2),
    "dopri5_attempt": flow.SolverConfig(solver="dopri5",
                                        first_step=FIRST_STEP_SPAN),
    "fused_rhs": flow.SolverConfig(solver="dopri5", first_step=None),
}
# at the bench's M and S: the segment backwards (and `fused_rhs`'s) refuse
# D >= 12 for shared memory, every kernel refuses Din > 16
TAKEN = {5: True, 11: True, 12: False, 16: False, 17: False, 33: False}


def _svgp(din, d, m):
    return gp.init_svgp(torch.Generator().manual_seed(0), din, d, m,
                        device="cpu")


@pytest.mark.parametrize("kernel", sorted(CONFIGS))
@pytest.mark.parametrize("dim", sorted(TAKEN))
def test_dispatch_takes_a_kernel_exactly_where_both_directions_accept(kernel, dim):
    cfg = CONFIGS[kernel]
    params = _svgp(dim, dim, M)
    ts = torch.tensor([0.0, 0.01])
    assert flow._kernel_of(cfg, ts) == kernel
    want = _accepts(kernel, ROWS, dim, dim, M, S)
    assert want == TAKEN[dim]
    assert flow._kernels_active(cfg, params, ROWS, S, kernel) == want
    # the row gate still holds, and a caller who forces the kernels gets
    # them (and the wrapper's ValueError on a refused shape)
    assert not flow._kernels_active(cfg, params, 255, S, kernel)
    forced = dataclasses.replace(cfg, kernels=True)
    assert flow._kernels_active(forced, params, ROWS, S, kernel)


def _draw(params, din, d, m, s, seed=1):
    rng = np.random.default_rng(seed)

    def t(*shape, uniform=False):
        a = rng.uniform(size=shape) if uniform else rng.normal(size=shape)
        return torch.tensor(a, dtype=torch.float32)

    with torch.no_grad():
        return gp.draw_posterior(params, t(s, d), t(din, s, d),
                                 t(1, s, d, uniform=True), t(m, d))


@pytest.mark.parametrize("kernel,dim", [("rk4_segment", 5), ("rk4_segment", 12),
                                        ("dopri5_attempt", 5),
                                        ("dopri5_attempt", 12)])
def test_flow_forward_launches_the_segment_kernel_only_where_taken(
        monkeypatch, kernel, dim):
    """`flow_forward` of 256 rows calls the segment wrapper at D = 5 and the
    plain solver at D = 12 (its backward would not fit), with the same
    answer."""
    cfg = CONFIGS[kernel]
    params = _svgp(dim, dim, M)
    draw = _draw(params, dim, dim, M, S)
    name = {"rk4_segment": "fused_rk4_segment",
            "dopri5_attempt": "fused_dopri5_attempt"}[kernel]
    calls = []
    real = getattr(flow, name)
    monkeypatch.setattr(flow, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    x0 = torch.tensor(np.random.default_rng(2).normal(size=(256, dim)),
                      dtype=torch.float32)
    ts = torch.tensor([0.0, 0.01])
    with torch.no_grad():
        got, _ = flow.flow_forward(params, draw, x0, ts, cfg)
        want, _ = flow.flow_forward(params, draw, x0, ts,
                                    dataclasses.replace(cfg, kernels=False))
    assert len(calls) == TAKEN[dim]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("din,d,m,s,taken", [
    (3, 5, M, S, True), (8, 2, M, S, True), (4, 20, 40, 64, True),
    (4, 21, 40, 64, False),    # the backward's 640-thread bound
    (9, 17, 40, 64, False),    # the backward's 512-thread bound
    (12, 12, M, S, False),     # the backward's shared memory
    (17, 2, 40, 64, False),    # Din > 16
], ids=["din3_d5", "din8_d2", "din4_d20", "din4_d21", "din9_d17", "d12_smem",
        "din17"])
def test_eval_draw_takes_the_kernel_exactly_where_both_directions_accept(
        monkeypatch, caplog, din, d, m, s, taken):
    params = _svgp(din, d, m)
    draw = _draw(params, din, d, m, s)
    assert _accepts("fused_rhs", 300, din, d, m, s) == taken
    calls = []
    monkeypatch.setattr(gp, "fused_rhs",
                        lambda *a: calls.append(1) or ck.fused_rhs_plain(*a))
    monkeypatch.setattr(gp, "_REFUSALS_LOGGED", set())
    x = torch.tensor(np.random.default_rng(3).normal(size=(300, din)),
                     dtype=torch.float32)
    with torch.no_grad(), caplog.at_level(logging.WARNING, logger=gp.__name__):
        got = gp.eval_draw(params, draw, x)
        again = gp.eval_draw(params, draw, x)
        if taken:   # what the kernel wrapper computes for a CPU tensor
            want = ck.fused_rhs_plain(x, params.z, params.kernel.lengthscales,
                                      params.kernel.variance, draw.omega,
                                      draw.phase, draw.weights, draw.nu)
        else:
            want = gp.eval_draw(params, draw, x, use_kernel=False)
    assert len(calls) == 2 * taken
    assert got.shape == (300, d)
    assert torch.equal(got, want) and torch.equal(got, again)
    # a refused shape is logged once, with the geometry's reason
    refusals = [r for r in caplog.records if "refuse" in r.getMessage()]
    assert len(refusals) == (0 if taken else 1)
