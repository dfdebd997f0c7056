"""Launch geometry of the two segment backward kernels
(`fused_dopri5_attempt` and `fused_rk4_segment` backward): pure arithmetic in
`gpode_tpu_torch.ops.cuda_kernels.segment_bwd_geometry`, checked on the CPU
against the limits the kernels in `csrc/fused_dopri5.cu` / `csrc/fused_rk4.cu`
state: tiles cover every row, a block fits the card, the scratch buffers have
one slab per block and dim, and a shape the kernels do not take raises
before anything is launched.
"""

import math
import pathlib
import re

import pytest

from gpode_tpu_torch.ops import cuda_kernels as ck

# (N, Din = D, M, S)
SHAPES = {
    "official": (2970, 5, 100, 256),
    "m256": (2970, 5, 256, 256),
    "ragged_n77": (77, 5, 100, 256),
    "one_row": (1, 5, 100, 256),
    "din8": (3000, 8, 100, 256),
    "wide_registers_din10": (500, 10, 100, 256),
    "tiny": (50, 2, 16, 32),
    "ragged_features": (203, 3, 40, 100),
}
STAGES = {"dopri5": 6, "rk4": 4}
SMS = 132   # multiprocessors of an H100 SXM


def _align4(v):
    return (v + 3) & ~3


@pytest.mark.parametrize("kernel", sorted(STAGES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_geometry_covers_rows_and_fits_the_card(shape, kernel):
    n, dim, m, s = SHAPES[shape]
    geo = ck.segment_bwd_geometry(n, dim, dim, m, s, STAGES[kernel], SMS)
    # tiles: whole tiles per block, every row in exactly one block
    assert geo.rows_per_block % geo.rt == 0 and geo.rows_per_block >= geo.rt
    assert geo.blocks * geo.rows_per_block >= n
    assert (geo.blocks - 1) * geo.rows_per_block < n
    assert geo.blocks <= ck._SEG_BWD_BLOCKS_PER_SM * SMS
    # the variant: loops over Din reach it, a tile's dx shares fit one fold
    assert (geo.dp, geo.rt, geo.maxt) in ck._SEG_BWD_VARIANTS[STAGES[kernel]]
    assert dim <= geo.dp and geo.rt * geo.dp <= 32
    # the block: G groups of D warps within the variant's thread bound
    assert geo.threads == 32 * dim * geo.groups
    assert geo.groups >= 1 and geo.threads <= geo.maxt <= 1024
    assert geo.groups <= math.ceil(s / 32) + math.ceil(m / 32)
    # shared memory: stage inputs | planes | il | accumulators | dls | dx shares
    warps = geo.threads // 32
    acc = dim * (dim * s + 2 * s + m + m * dim)
    assert acc == dim * ck._acc_floats(dim, m, s)
    stages, planes = (6, 7) if kernel == "dopri5" else (4, 6)
    assert geo.smem_bytes == 4 * (
        stages * geo.rt * _align4(geo.dp) + planes * _align4(geo.rt * geo.dp)
        + geo.dp * geo.dp + _align4(acc) + 32 * geo.dp * warps + 32 * warps)
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES
    # scratch: one slab per (block, dim)
    assert geo.part_main_floats == geo.blocks * dim * (dim * s + 2 * s + m + dim + 1)
    assert geo.part_dz_floats == geo.blocks * dim * m * dim


@pytest.mark.parametrize("shape", ["official", "m256"])
def test_main_path_geometry_fills_the_card(shape):
    """At the train step's shapes two blocks are resident per SM by shared
    memory and every block has rows."""
    n, dim, m, s = SHAPES[shape]
    for stages in STAGES.values():
        geo = ck.segment_bwd_geometry(n, dim, dim, m, s, stages, SMS)
        assert 2 * geo.smem_bytes <= ck.MAX_SMEM_BYTES
        assert geo.blocks > SMS
        assert geo.dp == 5   # the exact-width variant: no padded lanes of work


@pytest.mark.parametrize("sms", [1, 66, 132, 144])
def test_geometry_adapts_to_the_sm_count(sms):
    n, dim, m, s = SHAPES["official"]
    geo = ck.segment_bwd_geometry(n, dim, dim, m, s, 6, sms)
    assert geo.blocks <= ck._SEG_BWD_BLOCKS_PER_SM * sms
    assert geo.blocks * geo.rows_per_block >= n


@pytest.mark.parametrize("args,match", [
    ((100, 5, 4, 100, 256, 6), "Din == D"),
    ((100, 17, 17, 100, 256, 6), "Din = D <= 16"),
    ((100, 0, 0, 100, 256, 4), "Din = D <= 16"),
    ((0, 5, 5, 100, 256, 4), "N, M, S >= 1"),
    ((100, 5, 5, 0, 256, 4), "N, M, S >= 1"),
    ((100, 16, 16, 100, 256, 6), "shared memory"),
    ((100, 5, 5, 4000, 256, 4), "shared memory"),
    ((100, 5, 5, 100, 256, 5), "stages"),
], ids=["din_ne_d", "din17", "din0", "no_rows", "no_inducing", "din16_smem",
        "m4000_smem", "stages5"])
def test_unsupported_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ck.segment_bwd_geometry(*args, SMS)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("dim,dopri5,rk4", [
    (1, (4, 4, 640), (4, 4, 640)), (4, (4, 4, 640), (4, 4, 640)),
    (5, (5, 6, 640), (5, 4, 640)), (6, (8, 4, 512), (8, 4, 512)),
    (8, (8, 4, 512), (8, 4, 512)), (9, (16, 1, 512), (16, 1, 512)),
    (12, (16, 1, 512), (16, 1, 512)),
])
def test_each_width_takes_the_narrowest_instantiated_variant(dim, dopri5, rk4):
    """(loop bound over Din, rows per tile, thread bound) by Din: the tables
    in `csrc/fused_dopri5.cu` and `csrc/fused_rk4.cu` instantiate exactly
    these, and no other."""
    for stages, want in ((6, dopri5), (4, rk4)):
        geo = ck.segment_bwd_geometry(300, dim, dim, 16, 64, stages, SMS)
        assert (geo.dp, geo.rt, geo.maxt) == want


@pytest.mark.parametrize("source,macro,stages", [
    ("fused_dopri5.cu", "DP_BWD_VARIANTS", 6),
    ("fused_rk4.cu", "RK4_BWD_VARIANTS", 4),
])
def test_sources_instantiate_the_variants_the_geometry_selects(source, macro,
                                                               stages):
    text = (pathlib.Path(ck.__file__).parents[1] / "csrc" / source).read_text()
    line = re.search(rf"#define {macro}\(X\)(.*)", text).group(1)
    built = tuple(tuple(map(int, v)) for v in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", line))
    assert built == ck._SEG_BWD_VARIANTS[stages]
