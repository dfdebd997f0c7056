"""Launch geometry of the wide-layout rhs kernels (`csrc/fused_rhs_wide.cu`).

`gpode_tpu_torch.ops.wide_rhs.wide_fwd_geometry` / `wide_bwd_geometry` are
pure arithmetic, checked on the CPU against the limits the source states:
tiles cover every row, the 32-column units a warp takes cover the packed
column axis without straddling a dim's block, a block fits the card
(threads within the variant's bound, shared memory under 227 KB), Din may
differ from D, each width takes the narrowest variant the source
instantiates, and a shape the kernels do not take raises before anything is
launched. The ctypes signatures are held against the source's C entry
points.
"""

import math
import pathlib
import re

import pytest

from gpode_tpu_torch.ops import cuda_kernels as ck
from gpode_tpu_torch.ops import wide_rhs as wr

# (N, Din, D, M, S): the A/B's and the card checks' shapes (the bench, 2995
# rows, M=256), one row, a ragged tile, Din != D both ways, padded units and
# the widest dims
SHAPES = {
    "bench": (3000, 5, 5, 100, 256),
    "rows2995": (2995, 5, 5, 100, 256),
    "m256": (3000, 5, 5, 256, 256),
    "m256_rows2995": (2995, 5, 5, 256, 256),
    "one_row": (1, 5, 5, 100, 256),
    "ragged_n77": (77, 4, 4, 24, 64),
    "ragged_padded": (37, 5, 5, 27, 256),
    "din3_d2": (203, 3, 2, 40, 256),
    "din10_d12_s100": (203, 10, 12, 40, 100),
    "din8_d2": (300, 8, 2, 100, 256),
    "din2_d8": (300, 2, 8, 100, 256),
    "widest": (300, 16, 16, 100, 256),
}
SMS = 132   # multiprocessors of an H100 SXM


def _pads(m, s):
    return wr._ceil_to(s, wr.KERNEL_PAD), wr._ceil_to(m, wr.KERNEL_PAD)


def _align4(v):
    return (v + 3) & ~3


def _column(d, unit, lane, dims, sp, mp):
    """csrc `wide_column`: the packed column of a lane of dim d's unit."""
    su = sp // 32
    if unit < su:
        return d * sp + 32 * unit + lane
    return dims * sp + d * mp + 32 * (unit - su) + lane


def _dim_of(c, dims, sp, mp):
    return c // sp if c < dims * sp else (c - dims * sp) // mp


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_geometry_covers_rows_and_fits_the_card(shape):
    n, din, d, m, s = SHAPES[shape]
    sp, mp = _pads(m, s)
    geo = wr.wide_fwd_geometry(n, din, d, sp, mp)
    # one tile per block, every row in exactly one block
    assert geo.blocks == math.ceil(n / geo.rt)
    assert (geo.blocks - 1) * geo.rt < n <= geo.blocks * geo.rt
    # the variant: loops over Din and D reach it, the dense sums fit one fold
    assert (geo.dp, geo.rt, geo.maxt) in wr.WIDE_FWD_VARIANTS
    assert max(din, d) <= geo.dp and geo.rt * geo.dp <= 32
    # G groups of D warps within the thread bound, each with a unit
    assert geo.threads == 32 * d * geo.groups
    assert geo.groups >= 1 and geo.threads <= geo.maxt <= 1024
    assert geo.groups <= (sp + mp) // 32
    # x tile | xn (rt, D) | the warps' folded sums
    assert geo.smem_bytes == 4 * (geo.rt * _align4(geo.dp) + _align4(geo.rt * d)
                                  + 32 * d * geo.groups)
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_geometry_covers_rows_and_fits_the_card(shape, sms):
    n, din, d, m, s = SHAPES[shape]
    sp, mp = _pads(m, s)
    geo = wr.wide_bwd_geometry(n, din, d, sp, mp, sms)
    # whole tiles per row block, every row in exactly one row block; one
    # block per (row block, dim), about _BWD_BLOCKS_PER_SM per SM in all
    assert geo.rows_per_block % geo.rt == 0 and geo.rows_per_block >= geo.rt
    assert ((geo.row_blocks - 1) * geo.rows_per_block < n
            <= geo.row_blocks * geo.rows_per_block)
    assert geo.blocks == geo.row_blocks * d
    assert geo.row_blocks <= max(1, math.ceil(wr._BWD_BLOCKS_PER_SM * sms / d))
    # the variant: the dx and dxn shares of a tile fit one fold
    assert (geo.dp, geo.rt, geo.maxt) in wr.WIDE_BWD_VARIANTS
    assert max(din, d) <= geo.dp and geo.rt * (geo.dp + 1) <= 32
    assert geo.threads == 32 * geo.warps <= geo.maxt <= 1024
    assert 1 <= geo.warps <= (sp + mp) // 32
    # x and g tiles | xn | folded shares | the dim's accumulators
    cols = sp + mp
    assert geo.smem_bytes == 4 * (2 * geo.rt * _align4(geo.dp) + _align4(geo.rt)
                                  + 32 * geo.warps + (din + d + 1) * cols)
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES
    # scratch: a slab of its dim's columns per block, a dx share per dim
    assert geo.slab_floats == (din + d + 1) * cols + din
    assert geo.part_floats == geo.blocks * geo.slab_floats
    assert geo.dx_part_floats == d * n * din


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_units_cover_the_packed_columns_without_straddling_a_dims_block(shape):
    """Every packed column belongs to exactly one (dim, unit, lane), and a
    unit's 32 columns lie in one of its dim's two blocks; the forward's
    warps of a dim and the backward's warps of a block share the dim's
    units, each unit taken once."""
    n, din, d, m, s = SHAPES[shape]
    sp, mp = _pads(m, s)
    w = d * (sp + mp)
    units = (sp + mp) // 32
    seen = [0] * w
    for dd in range(d):
        rff = range(dd * sp, (dd + 1) * sp)
        gram = range(d * sp + dd * mp, d * sp + (dd + 1) * mp)
        for unit in range(units):
            block = [_column(dd, unit, lane, d, sp, mp) for lane in range(32)]
            assert all(c in rff for c in block) or all(c in gram for c in block)
            assert all(_dim_of(c, d, sp, mp) == dd for c in block)
            for c in block:
                seen[c] += 1
    assert seen == [1] * w
    fwd = wr.wide_fwd_geometry(n, din, d, sp, mp)
    taken = sorted(u for grp in range(fwd.groups)
                   for u in range(grp, units, fwd.groups))
    assert taken == list(range(units))
    bwd = wr.wide_bwd_geometry(n, din, d, sp, mp, SMS)
    taken = sorted(u for warp in range(bwd.warps)
                   for u in range(warp, units, bwd.warps))
    assert taken == list(range(units))


def test_main_path_geometry():
    """At the A/B's bench shape: the exact-width variants, 5-warp forward
    blocks of 6-row tiles (a warp per dim, more blocks than SMs), and
    backward blocks of one dim's columns, each walking several tiles."""
    n, din, d, m, s = SHAPES["bench"]
    sp, mp = _pads(m, s)
    fwd = wr.wide_fwd_geometry(n, din, d, sp, mp)
    assert (fwd.dp, fwd.rt, fwd.maxt, fwd.threads, fwd.blocks) == (5, 6, 640, 160, 500)
    bwd = wr.wide_bwd_geometry(n, din, d, sp, mp, SMS)
    assert (bwd.dp, bwd.rt, bwd.maxt) == (5, 5, 640)
    assert bwd.threads == 32 * wr._BWD_WARPS
    assert bwd.blocks <= d * math.ceil(wr._BWD_BLOCKS_PER_SM * SMS / d)
    assert bwd.rows_per_block >= 2 * bwd.rt
    # a slab holds one dim's columns: a fifth of the packed axis
    assert bwd.slab_floats == 11 * 384 + 5


FWD_REFUSED = [
    ((100, 17, 5, 128, 256), "Din, D <= 16"),
    ((100, 5, 17, 128, 256), "Din, D <= 16"),
    ((100, 0, 5, 128, 256), "Din, D <= 16"),
    ((0, 5, 5, 128, 256), "N >= 1"),
    ((100, 5, 5, 0, 256), "multiples of 32"),
    ((100, 5, 5, 128, 100), "multiples of 32"),
]
BWD_REFUSED = FWD_REFUSED + [
    # 33 accumulators per column of the dim's 2048: 270336 bytes
    ((100, 16, 16, 1024, 1024), "shared memory"),
    ((100, 5, 5, 4096, 4096), "shared memory"),
]


@pytest.mark.parametrize("args,match", FWD_REFUSED,
                         ids=["din17", "d17", "din0", "no_rows", "no_features",
                              "ragged_inducing"])
def test_unsupported_forward_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        wr.wide_fwd_geometry(*args)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("args,match", BWD_REFUSED,
                         ids=["din17", "d17", "din0", "no_rows", "no_features",
                              "ragged_inducing", "d16_smem", "m4096_smem"])
def test_unsupported_backward_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        wr.wide_bwd_geometry(*args, SMS)
    assert ck.LAUNCHES == before


def test_backward_takes_what_the_whole_axis_slab_refused():
    """The former backward kept every column's accumulators in one block and
    refused Din=10, D=12, M=40, S=256 (W=3840) for shared memory; a block now
    holds one dim's 320 columns."""
    geo = wr.wide_bwd_geometry(64, 10, 12, 256, 64, SMS)
    assert (geo.dp, geo.rt) == (16, 1)
    assert geo.smem_bytes == 4 * (2 * 16 + 4 + 32 * geo.warps + 23 * 320)
    assert geo.smem_bytes < 40_000


@pytest.mark.parametrize("din,d,fwd,bwd", [
    (1, 1, (4, 8, 640), (4, 6, 640)), (4, 2, (4, 8, 640), (4, 6, 640)),
    (3, 5, (5, 6, 640), (5, 5, 640)), (5, 5, (5, 6, 640), (5, 5, 640)),
    (6, 2, (8, 4, 640), (8, 3, 512)), (2, 8, (8, 4, 640), (8, 3, 512)),
    (9, 1, (16, 2, 512), (16, 1, 512)), (16, 16, (16, 2, 512), (16, 1, 512)),
])
def test_each_width_takes_the_narrowest_instantiated_variant(din, d, fwd, bwd):
    """(loop bound, rows per tile, thread bound) by max(Din, D); the block
    stays within the bound."""
    f = wr.wide_fwd_geometry(300, din, d, 64, 32)
    b = wr.wide_bwd_geometry(300, din, d, 64, 32, SMS)
    assert (f.dp, f.rt, f.maxt) == fwd and f.threads <= f.maxt
    assert (b.dp, b.rt, b.maxt) == bwd and b.threads <= b.maxt


def _source():
    return (pathlib.Path(wr.__file__).parents[1] / "csrc"
            / "fused_rhs_wide.cu").read_text()


@pytest.mark.parametrize("direction,macro", [("fwd", "WIDE_FWD_VARIANTS"),
                                             ("bwd", "WIDE_BWD_VARIANTS")])
def test_source_instantiates_the_variants_the_geometry_selects(direction, macro):
    line = re.search(rf"#define {macro}\(X\)(.*)", _source()).group(1)
    built = tuple(tuple(map(int, v)) for v in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", line))
    assert built == wr.WIDE_VARIANTS[direction]


def test_wide_kernel_tables_name_every_kernel_once():
    """The kernels, occupancy queries and mangled-name suffixes that
    `chip_smoke.py` reads: each exists in the source, each counter once."""
    text = _source()
    assert set(wr.WIDE_KERNELS) == {"fused_rhs_wide_fwd", "fused_rhs_wide2_fwd",
                                    "fused_rhs_wide_bwd"} <= set(ck.LAUNCHES)
    for direction, kernel in wr.WIDE_KERNEL_NAMES.items():
        assert re.search(rf"\b{kernel}\(", text)
        assert f'extern "C" int gpode_wide_{direction}_occupancy(' in text
    # the dense and multiply-reduce forwards are the bool template argument
    for dense in ("true", "false"):
        assert f"wide_fwd_launch<DP_, RT_, MAXT_, {dense}>" in text
    assert ck.variant_key("wide_fwd_kernel", 5, 6, 640, "Lb1E") == \
        "wide_fwd_kernelILi5ELi6ELi640ELb1EE"


def _c_parameters(text, fn):
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    return [p.strip() for p in params.split(",")]


@pytest.mark.parametrize("fn", sorted(ck._SIGNATURES["fused_rhs_wide"]))
def test_ctypes_signatures_match_the_c_entry_points(fn):
    """A pointer (or the stream) is passed as a void pointer and an int as
    an int: the argument types ctypes is given follow the C declaration."""
    want = [ck._P if "*" in p else ck._I for p in _c_parameters(_source(), fn)]
    assert ck._SIGNATURES["fused_rhs_wide"][fn] == want
