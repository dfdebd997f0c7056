"""Launch geometry of the batched-draw dopri5 attempt kernel
(`dopri5_attempt_draws`): pure arithmetic in
`gpode_tpu_torch.ops.cuda_kernels.draws_attempt_geometry`, checked on the
CPU against what `csrc/dopri5_draws.cu` states: every row of every draw in
exactly one block, a block that fits the card, the variants the source
instantiates, the C entry points' argument types, and the shapes it refuses
before anything is launched.
"""

import math
import pathlib
import re

import pytest

from gpode_tpu_torch.ops import cuda_kernels as ck

SOURCE = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc" / "dopri5_draws.cu"

# (draws, N, Din = D, M, S): the validation request, the test evaluation,
# the capture gate's old 256 rows, and small and odd widths
SHAPES = {
    "validation": (32, 2, 5, 100, 256),
    "test_eval": (128, 2, 5, 100, 256),
    "rows256": (4, 256, 5, 100, 256),
    "ragged": (3, 19, 5, 16, 32),
    "one_row": (1, 1, 1, 1, 1),
    "din8": (5, 7, 8, 100, 256),
    "din16": (2, 9, 16, 40, 64),
}


def _align4(v):
    return (v + 3) & ~3


def _source():
    return SOURCE.read_text()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_geometry_covers_every_draws_rows_and_fits_the_card(shape):
    draws, n, dim, m, s = SHAPES[shape]
    geo = ck.draws_attempt_geometry(draws, n, dim, dim, m, s)
    assert geo.tiles == math.ceil(n / geo.rt)
    assert (geo.tiles - 1) * geo.rt < n <= geo.tiles * geo.rt
    assert geo.blocks == draws * geo.tiles
    assert (geo.dp, geo.rt, geo.maxt) in ck._DRAWS_VARIANTS
    assert dim <= geo.dp and 2 * geo.rt <= 32
    assert geo.threads == 32 * dim * geo.groups <= geo.maxt <= 1024
    assert 1 <= geo.groups <= math.ceil(s / 32) + math.ceil(m / 32)
    warps = geo.threads // 32
    # FwdSmem<DP, RT, 7> and the tile's squared errors
    assert geo.smem_bytes == 4 * (
        2 * geo.rt * _align4(geo.dp) + 7 * _align4(geo.rt * geo.dp)
        + geo.dp * geo.dp + 32 * warps + _align4(geo.rt * geo.dp))
    assert geo.smem_bytes <= ck.MAX_SMEM_BYTES
    assert ck.kernel_refusal("dopri5_attempt_draws", n, dim, dim, m, s,
                             draws=draws) is None


def test_the_validation_request_fills_a_block_per_draw():
    """32 draws x 2 rows at the bench widths: one block per draw, as many
    warps as the 1024-thread variant holds in groups of 5."""
    geo = ck.draws_attempt_geometry(32, 2, 5, 5, 100, 256)
    assert (geo.dp, geo.rt, geo.maxt, geo.groups) == (5, 8, 1024, 6)
    assert (geo.tiles, geo.blocks, geo.threads) == (1, 32, 960)


@pytest.mark.parametrize("args,match", [
    ((2, 3, 5, 4, 100, 256), "Din == D"),
    ((2, 3, 17, 17, 100, 256), "Din <= 16"),
    ((0, 3, 5, 5, 100, 256), "at least one draw"),
    ((2, 0, 5, 5, 100, 256), "N, D, M, S >= 1"),
    ((2 ** 29, 40, 5, 5, 100, 256), "tiles"),
])
def test_unsupported_shapes_are_refused_before_any_launch(args, match):
    with pytest.raises(ValueError, match=match):
        ck.draws_attempt_geometry(*args)
    draws, n, din, d, m, s = args
    assert match.split()[0] in ck.kernel_refusal(
        "dopri5_attempt_draws", n, din, d, m, s, draws=draws)


def test_the_source_instantiates_the_variants_the_geometry_selects():
    line = re.search(r"#define DRAWS_VARIANTS\(X\)(.*)", _source()).group(1)
    built = tuple(tuple(map(int, v)) for v in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", line))
    assert built == ck._DRAWS_VARIANTS


def test_the_kernel_table_names_the_source_and_its_entry_points():
    text = _source()
    lib, kernel, query = ck.DRAWS_KERNEL
    assert lib == "dopri5_draws"
    assert re.search(rf"\b{kernel}\(", text)
    assert re.search(r"\bdraws_ratio_kernel\(", text)
    assert f'extern "C" int {query}(' in text
    assert re.search(r"\bdraws_commit_kernel\(", text)
    assert set(ck._SIGNATURES[lib]) == {"gpode_dp_draws_attempt", query,
                                        "gpode_dp_draws_commit"}


def _c_parameters(text, fn):
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    return [p.strip() for p in params.split(",")]


@pytest.mark.parametrize("fn", sorted(ck._SIGNATURES["dopri5_draws"]))
def test_ctypes_signatures_match_the_c_entry_points(fn):
    """A pointer (or the stream) is passed as a void pointer, an int as an
    int and a float as a float: the argument types ctypes is given follow
    the C declaration."""
    want = [ck._P if "*" in p else ck._F if p.startswith("float ") else ck._I
            for p in _c_parameters(_source(), fn)]
    assert ck._SIGNATURES["dopri5_draws"][fn] == want


def test_the_library_is_built_with_the_others():
    from gpode_tpu_torch.ops import cuda_build
    assert cuda_build.SOURCES["dopri5_draws"] == SOURCE.name
    assert "dopri5_attempt_draws" in ck.LAUNCHES
