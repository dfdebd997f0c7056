"""Launch geometry of the `rbf_gram` kernel (`csrc/rbf_gram.cu`).

`gpode_tpu_torch.ops.cuda_kernels.gram_geometry` is pure arithmetic, checked
on the CPU against the limits the source states: the blocks' row tiles and
column groups cover every output element of K (D, N, M) exactly once (the
thread-to-element map of the source is replayed here), a block stays within
the source's thread, group and shared-memory bounds, each Din up to 16
takes the narrowest variant the source instantiates and a wider one the
runtime-Din variant, 16-byte stores only where M % 4 == 0, at least two
blocks per SM at every shape `chip_smoke.py` gives the kernel, and a shape
the kernel does not take raises before anything is launched. The ctypes
signatures are held against the source's C entry points.
"""

import math
import pathlib
import re

import numpy as np
import pytest

from gpode_tpu_torch.ops import cuda_kernels as ck

SMS = 132   # multiprocessors of an H100 SXM

# (N, Din, D, M): the shapes chip_smoke.py and the card tests give the kernel
# (the MoCap states at M=100 and 256, the ragged N=77, the VDP grid)
SMOKE_SHAPES = {
    "mocap_m100": (3000, 5, 5, 100),
    "mocap_m256": (3000, 5, 5, 256),
    "ragged_n77": (77, 5, 5, 100),
    "vdp_grid": (900, 2, 2, 16),
}
# small shapes whose every element is replayed: one row, ragged groups
# (M % 4 != 0), a ragged last row block, Din up to the widest exact variant
# and past it (the runtime-Din variant; at the widest Din its blocks lose
# rows, lanes and column groups to fit shared memory), several column chunks
REPLAYED = {
    "one_row": (1, 5, 5, 16),
    "m17": (77, 2, 3, 17),
    "m3": (9, 1, 1, 3),
    "ragged_rows": (301, 3, 2, 100),
    "din16": (40, 16, 2, 6),
    "din7": (50, 7, 1, 33),
    "two_chunks": (3, 2, 2, 1030),
    "din17": (77, 17, 3, 17),
    "din40": (301, 40, 2, 100),
    "din_max": (5, ck.GRAM_MAX_DIN, 1, 9),
}


def _source():
    return (pathlib.Path(ck.__file__).parents[1] / "csrc"
            / "rbf_gram.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", _source()).group(1))


def _replay(n, din, d, m, geo):
    """How often the source's kernel writes each element of K (D, N, M) at
    geometry `geo`: block (bx, by, bz), thread t takes column group
    t % groups_per_block and row lane t / groups_per_block, rows lane,
    lane + lanes, ... of its tile, and stores the group's columns below M."""
    written = np.zeros((d, n, m), np.int64)
    for bx in range(geo.row_blocks):
        row0 = bx * geo.rows_per_block
        rows = min(geo.rows_per_block, n - row0)
        for by in range(geo.col_chunks):
            for t in range(geo.threads):
                group, lane = t % geo.groups_per_block, t // geo.groups_per_block
                col0 = (by * geo.groups_per_block + group) * 4
                if col0 >= m:
                    continue
                cols = slice(col0, min(col0 + 4, m))
                for r in range(lane, rows, geo.lanes):
                    written[:, row0 + r, cols] += 1
    return written


@pytest.mark.parametrize("shape", sorted(REPLAYED))
def test_every_output_element_is_written_once(shape):
    n, din, d, m = REPLAYED[shape]
    geo = ck.gram_geometry(n, din, d, m, SMS)
    assert geo.blocks == geo.row_blocks * geo.col_chunks * d
    assert np.all(_replay(n, din, d, m, geo) == 1)


@pytest.mark.parametrize("shape", sorted(SMOKE_SHAPES) + sorted(REPLAYED))
def test_geometry_fits_the_source_limits(shape):
    n, din, d, m = (SMOKE_SHAPES | REPLAYED)[shape]
    geo = ck.gram_geometry(n, din, d, m, SMS)
    assert _define("GRAM_GROUP") == ck._GRAM_GROUP
    groups = math.ceil(m / ck._GRAM_GROUP)
    assert 1 <= geo.groups_per_block <= min(groups, ck._GRAM_BLOCK_GROUPS)
    # balanced chunks: none is more than one group short of the others
    assert geo.col_chunks == math.ceil(groups / geo.groups_per_block)
    assert groups > (geo.col_chunks - 1) * geo.groups_per_block
    assert geo.threads == geo.lanes * geo.groups_per_block
    assert 1 <= geo.threads <= _define("GRAM_MAX_THREADS")
    # whole lanes per tile, every row in exactly one block
    assert geo.rows_per_block % geo.lanes == 0
    assert geo.rows_per_block // geo.lanes <= ck._GRAM_MAX_ROWS_PER_LANE
    assert (geo.row_blocks - 1) * geo.rows_per_block < n
    assert n <= geo.row_blocks * geo.rows_per_block
    # the tile's scaled x rows (and for the runtime-Din variant the chunk's
    # z rows) within the card's limit; the 16-byte store on aligned rows
    assert geo.smem_bytes == (
        4 * geo.rows_per_block * geo.dp if geo.dp else
        4 * din * (geo.rows_per_block + 4 * geo.groups_per_block))
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES
    assert geo.vec == (m % 4 == 0)


@pytest.mark.parametrize("shape", sorted(SMOKE_SHAPES))
def test_smoke_shapes_give_at_least_two_blocks_per_sm(shape):
    geo = ck.gram_geometry(*SMOKE_SHAPES[shape], SMS)
    assert geo.blocks >= 2 * SMS


def test_the_mocap_shape_geometry():
    """N=3000, Din=D=5, M=100: 25 groups of 4 columns in two chunks of 13,
    16 lanes (208 threads) of 4 rows, 470 blocks; float4 stores. M=256: four
    chunks of 16 groups, 16 lanes of 8 rows, 480 blocks."""
    geo = ck.gram_geometry(3000, 5, 5, 100, SMS)
    assert (geo.dp, geo.groups_per_block, geo.col_chunks, geo.lanes,
            geo.rows_per_block, geo.threads, geo.blocks, geo.vec) == (
                5, 13, 2, 16, 64, 208, 470, True)
    geo = ck.gram_geometry(3000, 5, 5, 256, SMS)
    assert (geo.groups_per_block, geo.col_chunks, geo.lanes,
            geo.rows_per_block, geo.blocks) == (16, 4, 16, 128, 480)


@pytest.mark.parametrize("din", [*range(1, 18), 40, ck.GRAM_MAX_DIN])
def test_each_din_takes_the_narrowest_instantiated_variant(din):
    geo = ck.gram_geometry(100, din, 3, 40, SMS)
    assert geo.dp == min((v for v in ck.GRAM_VARIANTS if v >= din),
                         default=ck.GRAM_ANY_DIN)
    assert (geo.dp == ck.GRAM_ANY_DIN) == (din > 16)


def test_source_instantiates_the_variants_the_geometry_selects():
    line = re.search(r"#define GRAM_VARIANTS\(X\)(.*)", _source()).group(1)
    built = tuple(int(v) for v in re.findall(r"X\((\d+)\)", line))
    assert built == ck.GRAM_VARIANTS
    assert ck.gram_variant_key(5) == "rbf_gram_kernelILi5EE"
    assert ck.gram_variant_key(ck.GRAM_ANY_DIN) == "rbf_gram_kernelILi0EE"
    assert re.search(r"\brbf_gram_kernel\(", _source())


REFUSED = [
    ((10, ck.GRAM_MAX_DIN + 1, 2, 8), "Din <= 11622"),
    ((10, 0, 2, 8), "Din <= 11622"),
    ((10, 2, 0, 8), "D <= 65535"),
    ((10, 2, 65536, 8), "D <= 65535"),
    ((0, 2, 2, 8), "N, M >= 1"),
    ((10, 2, 2, 0), "N, M >= 1"),
    ((10, 2, 2, 65535 * 64 + 1), "M <= 4194240"),
]


@pytest.mark.parametrize("args,match", REFUSED,
                         ids=["din_over_smem", "din0", "d0", "d65536", "no_rows",
                              "no_columns", "m_over_the_grid"])
def test_unsupported_shape_raises_before_any_launch(args, match):
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ck.gram_geometry(*args, SMS)
    assert ck.LAUNCHES == before


def _c_parameters(fn):
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', _source()).group(1)
    return [p.strip() for p in params.split(",")]


@pytest.mark.parametrize("fn", sorted(ck._SIGNATURES["rbf_gram"]))
def test_ctypes_signatures_match_the_c_entry_points(fn):
    want = [ck._P if "*" in p else ck._I for p in _c_parameters(fn)]
    assert ck._SIGNATURES["rbf_gram"][fn] == want


@pytest.mark.parametrize("din", [5, 16, 17, 40])
def test_cross_gram_takes_rbf_gram_only_where_its_geometry_does(
        monkeypatch, caplog, din):
    """`gp.cross_gram` without gradients takes `rbf_gram` at every Din its
    geometry takes, the runtime-Din variant's too, and logs no refusal;
    the kernel's route agrees with `rbf_K`."""
    import torch

    from gpode_tpu_torch.models import gp

    ck.gram_geometry(9, din, din, 6, SMS)   # the kernel takes the shape
    calls = []
    real = gp.rbf_gram
    monkeypatch.setattr(gp, "rbf_gram",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    params = gp.init_svgp(torch.Generator().manual_seed(0), din, din, 6)
    x = torch.randn(9, din, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = gp.cross_gram(params, x)
    assert calls == [(9, din)]
    assert got.shape == (din, 6, 9)
    torch.testing.assert_close(got, gp.rbf_K(params.kernel, params.z, x),
                               rtol=1e-5, atol=1e-6)
    assert not [r for r in caplog.records if "rbf_gram" in r.getMessage()]
