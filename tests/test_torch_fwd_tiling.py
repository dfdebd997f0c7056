"""Launch geometry of the two segment forward kernels
(`fused_dopri5_attempt` and `fused_rk4_segment` forward): pure arithmetic in
`gpode_tpu_torch.ops.cuda_kernels.segment_fwd_geometry`, checked on the CPU
against the limits the kernels in `csrc/fused_dopri5.cu` / `csrc/fused_rk4.cu`
state: one tile per block covers every row, a block fits the card, each
width takes the narrowest variant the sources instantiate, and a shape the
kernels do not take raises before anything is launched.
"""

import math
import pathlib
import re

import pytest

from gpode_tpu_torch.ops import cuda_kernels as ck

# (N, Din = D, M, S): the train step's shapes and the card tests' others
SHAPES = {
    "official": (3000, 5, 100, 256),
    "m256": (3000, 5, 256, 256),
    "ragged_n77": (77, 5, 100, 256),
    "one_row": (1, 5, 100, 256),
    "din8": (203, 8, 100, 256),
    "din10": (203, 10, 100, 256),
    "tiny": (50, 2, 16, 32),
    "ragged_units": (203, 3, 40, 100),
}
STAGES = {"dopri5": 6, "rk4": 4}
DERIVATIVES = {"dopri5": 7, "rk4": 4}   # k planes a block keeps


def _align4(v):
    return (v + 3) & ~3


@pytest.mark.parametrize("kernel", sorted(STAGES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_geometry_covers_rows_and_fits_the_card(shape, kernel):
    n, dim, m, s = SHAPES[shape]
    geo = ck.segment_fwd_geometry(n, dim, dim, m, s, STAGES[kernel])
    # one tile per block, every row in exactly one block
    assert geo.blocks == math.ceil(n / geo.rt)
    assert (geo.blocks - 1) * geo.rt < n <= geo.blocks * geo.rt
    # the variant: loops over Din reach it, a tile's row sums fit one fold
    assert (geo.dp, geo.rt, geo.maxt) in ck._SEG_FWD_VARIANTS[STAGES[kernel]]
    assert dim <= geo.dp and 2 * geo.rt <= 32
    # the block: G groups of D warps within the variant's thread bound, and
    # no warp without a 32-column unit of its dim
    assert geo.threads == 32 * dim * geo.groups
    assert geo.groups >= 1 and geo.threads <= geo.maxt <= 1024
    assert geo.groups <= math.ceil(s / 32) + math.ceil(m / 32)
    # shared memory: xb, xi | stage derivatives | il | the warps' row sums
    warps = geo.threads // 32
    assert geo.smem_bytes == 4 * (
        2 * geo.rt * _align4(geo.dp) + DERIVATIVES[kernel] * _align4(geo.rt * geo.dp)
        + geo.dp * geo.dp + 32 * warps)
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape", ["official", "m256"])
def test_main_path_forward_geometry(shape):
    """At the train step's shapes: the exact-width variant, 8-row tiles in
    10-warp blocks (three resident per SM at its 64 registers), and more
    blocks than the card has SMs."""
    n, dim, m, s = SHAPES[shape]
    for stages in STAGES.values():
        geo = ck.segment_fwd_geometry(n, dim, dim, m, s, stages)
        assert (geo.dp, geo.rt, geo.maxt) == (5, 8, 1024)
        assert geo.threads == 320 and geo.blocks == 375
        assert 3 * geo.smem_bytes <= ck.MAX_SMEM_BYTES
        assert 3 * geo.threads * (65536 // geo.maxt) <= 65536   # registers


@pytest.mark.parametrize("args,match", [
    ((100, 5, 4, 100, 256, 6), "Din == D"),
    ((100, 17, 17, 100, 256, 6), "Din = D <= 16"),
    ((100, 0, 0, 100, 256, 4), "Din = D <= 16"),
    ((0, 5, 5, 100, 256, 4), "N, M, S >= 1"),
    ((100, 5, 5, 0, 256, 4), "N, M, S >= 1"),
    ((100, 5, 5, 100, 0, 6), "N, M, S >= 1"),
    ((100, 5, 5, 100, 256, 7), "stages"),
], ids=["din_ne_d", "din17", "din0", "no_rows", "no_inducing", "no_features",
        "stages7"])
def test_unsupported_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ck.segment_fwd_geometry(*args)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("dim,want", [
    (1, (4, 8, 1024)), (4, (4, 8, 1024)), (5, (5, 8, 1024)), (6, (8, 4, 384)),
    (8, (8, 4, 384)), (9, (16, 4, 512)), (16, (16, 4, 512)),
])
def test_each_width_takes_the_narrowest_instantiated_forward_variant(dim, want):
    """(loop bound over Din, rows per tile, thread bound) by Din, the same
    for both kernels; the block stays within the bound at every width."""
    for stages in STAGES.values():
        geo = ck.segment_fwd_geometry(300, dim, dim, 16, 64, stages)
        assert (geo.dp, geo.rt, geo.maxt) == want
        assert geo.threads <= geo.maxt


@pytest.mark.parametrize("source,macro,stages", [
    ("fused_dopri5.cu", "DP_FWD_VARIANTS", 6),
    ("fused_rk4.cu", "RK4_FWD_VARIANTS", 4),
])
def test_sources_instantiate_the_forward_variants_the_geometry_selects(
        source, macro, stages):
    text = (pathlib.Path(ck.__file__).parents[1] / "csrc" / source).read_text()
    line = re.search(rf"#define {macro}\(X\)(.*)", text).group(1)
    built = tuple(tuple(map(int, v)) for v in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", line))
    assert built == ck._SEG_FWD_VARIANTS[stages]
    assert built == ck.SEGMENT_VARIANTS["fwd", stages]


def test_segment_kernel_tables_name_every_kernel_once():
    """The occupancy queries and ptxas entry names that `chip_smoke.py`
    reads for the four segment kernels: each exists in its source."""
    csrc = pathlib.Path(ck.__file__).parents[1] / "csrc"
    sources = {"fused_dopri5": "fused_dopri5.cu", "fused_rk4": "fused_rk4.cu"}
    assert set(ck.SEGMENT_KERNELS) == set(ck.SEGMENT_VARIANTS)
    assert len({k for _, k, _ in ck.SEGMENT_KERNELS.values()}) == 4
    for lib, kernel, query in ck.SEGMENT_KERNELS.values():
        text = (csrc / sources[lib]).read_text()
        assert re.search(rf"\b{kernel}\(", text)
        assert f'extern "C" int {query}(' in text
        assert query in ck._SIGNATURES[lib]
