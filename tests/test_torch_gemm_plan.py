"""Host-side launch plans of the kernels on the shared split-TF32
mainloop (``csrc/gemm_f32.cuh``): ``conv1x1_dw`` and ``ln_matmul``. They
are pure Python, so they run here without a card:

- the tile instance each wrapper picks from the output's shape (and, for
  ``ln_matmul``, the SM count);
- ``conv1x1_dw``'s split of M: deterministic, covering M exactly in the
  kernel's own ``s * M // splits`` bounds, no split shorter than its
  minimum, at most one wave of resident blocks, at most 65535 splits;
- the copy width (16- or 4-byte ``cp.async``) for aligned, odd-width and
  storage-offset operands;
- the size of ``ln_matmul``'s statistics workspace;
- the same for ``conv1x1_dw_bf16`` (``csrc/conv1x1_dw_bf16.cu``, bf16
  operands): its two routes' tile tables against the instances the
  source defines, its split of M (64-row k-blocks on the wgmma route,
  rows on the mma.sync route), its copy width in bf16 values (16-byte,
  4-byte or plain 2-byte copies), and the route each layout takes: every
  shape of a ResNet-50 step on 16-byte-aligned operands the wgmma route,
  views at a 2- or 4-byte offset and odd channel counts the mma.sync
  route.
"""

import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.nn import cuda_conv as cc
from paddle_tpu_torch.nn import fused_ln as fl
from paddle_tpu_torch.nn import gemm_bf16
from paddle_tpu_torch.nn.gemm_f32 import (LARGE, SMALL, TILES, copy_width,
                                          pick_tile)

H100_SMS = 132

# the 15 distinct (M, Cin, Cout) of conv1x1_dw in a ResNet-50 step at
# batch 128, 224 x 224 (chip_smoke.resnet50_dw_shapes)
RESNET50_DW = [
    (401408, 64, 64), (401408, 64, 256), (401408, 256, 64),
    (401408, 256, 128), (100352, 128, 512), (100352, 256, 512),
    (100352, 512, 128), (100352, 512, 256), (25088, 256, 1024),
    (25088, 512, 1024), (25088, 1024, 256), (25088, 1024, 512),
    (6272, 512, 2048), (6272, 1024, 2048), (6272, 2048, 512)]


def test_tile_table_matches_the_kernel_instances():
    # csrc/gemm_f32.cuh: Large = 128 x 128, 1 block an SM; Small = 64 x
    # 64, 3 blocks an SM
    assert TILES[LARGE] == (128, 128, 1) and TILES[SMALL] == (64, 64, 3)


@pytest.mark.parametrize("rows,cols,min_tiles,want", [
    (128, 128, 0, LARGE), (4096, 4096, 0, LARGE), (127, 4096, 0, SMALL),
    (4096, 64, 0, SMALL), (64, 64, 0, SMALL), (1, 1, 0, SMALL),
    (256, 256, 4, LARGE), (256, 257, 5, LARGE), (256, 256, 5, SMALL)])
def test_pick_tile(rows, cols, min_tiles, want):
    assert pick_tile(rows, cols, min_tiles) == want


def test_conv1x1_dw_tiles_of_a_resnet50_step():
    # the 64-channel outputs of the first stage take the 64 x 64 tile,
    # every other output of the step the 128 x 128 one
    for m, cin, cout in RESNET50_DW:
        tile, _ = cc._plan(m, cin, cout, H100_SMS)
        assert tile == (SMALL if min(cin, cout) < 128 else LARGE)


@pytest.mark.parametrize("M,N,want", [
    (16384, 512, LARGE), (16384, 2048, LARGE), (128, 256, SMALL),
    (2048, 1280, LARGE), (1024, 1024, SMALL), (100, 4096, SMALL),
    (1, 1, SMALL)])
def test_ln_matmul_tile(M, N, want):
    assert fl._plan(M, N, H100_SMS) == want


@pytest.mark.parametrize("m,cin,cout,sms", [
    *[(m, ci, co, H100_SMS) for m, ci, co in RESNET50_DW],
    (1, 3, 10, H100_SMS), (34, 8, 8, H100_SMS), (255, 64, 64, H100_SMS),
    (256, 64, 64, H100_SMS), (6144, 10, 3, H100_SMS),
    (5000, 130, 70, 132), (100352, 64, 64, 16), (3000, 300, 1000, 1),
    (0, 64, 64, H100_SMS), (2 ** 31 - 1, 1, 1, 10 ** 6)])
def test_conv1x1_dw_splits_cover_m(m, cin, cout, sms):
    tile, splits = cc._plan(m, cin, cout, sms)
    assert (tile, splits) == cc._plan(m, cin, cout, sms)     # repeatable
    assert 1 <= splits <= 65535
    # the kernel's rows of split s: [s * m // splits, (s + 1) * m // splits)
    bounds = [(s * m // splits, (s + 1) * m // splits)
              for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if splits > 1:
        assert min(e - b for b, e in bounds) >= cc._MIN_SPLIT_ROWS
    t = TILES[tile]
    tiles = -(-cin // t.rows) * -(-cout // t.cols)
    if tiles <= t.blocks_per_sm * sms:       # at most one wave of blocks
        assert tiles * splits <= t.blocks_per_sm * sms


def test_conv1x1_dw_splits_fill_the_card_and_cap():
    # one output tile over a long M: one wave of 64 x 64 blocks
    assert cc._plan(401408, 64, 64, H100_SMS) == (SMALL, 3 * H100_SMS)
    # too short to split
    assert cc._plan(511, 64, 64, H100_SMS) == (SMALL, 1)
    # the grid's z limit
    assert cc._splits(2 ** 31 - 1, 1, 1, 10 ** 6, SMALL) == 65535


@pytest.mark.parametrize("shape,offset,want", [
    ((64, 64), 0, 4), ((64, 6), 0, 1), ((64, 66), 0, 1), ((1, 1), 0, 1),
    ((64, 64), 1, 1), ((64, 64), 2, 1), ((64, 64), 4, 4),
    ((64, 64), 64, 4)])
def test_copy_width(shape, offset, want):
    rows, cols = shape
    buf = torch.zeros(rows * cols + offset)
    t = buf[offset:].view(rows, cols)
    assert t.is_contiguous()
    assert copy_width(t) == want


def test_copy_width_of_all_operands():
    x = torch.zeros(33, 64)
    w = torch.zeros(64, 128)
    assert copy_width(x, w, None, None) == 4
    assert copy_width(x[1:], w) == 4                 # one 256-byte row in
    assert copy_width(x, torch.zeros(64, 130)) == 1
    assert copy_width(x, w, torch.zeros(65)[1:]) == 1  # scale 4 bytes off
    assert copy_width(torch.zeros(65, 6)[1:], torch.zeros(65, 64)[1:]) == 1


@pytest.mark.parametrize("M", [1, 3, 16384])
def test_ln_matmul_stats_workspace(M):
    # each row's mean, then each row's 1 / sqrt(var + eps)
    assert fl._stats_numel(M) == 2 * M


# -- conv1x1_dw_bf16 (csrc/conv1x1_dw_bf16.cu) --------------------------------

def test_bf16_tile_table_matches_the_kernel_instances():
    # csrc/conv1x1_dw_bf16.cu: WgLarge = 128 x 128, 1 block an SM;
    # WgSmall = 64 x 64, 3 blocks an SM (wgmma); Large and Small the same
    # (mma.sync); the same indices as the f32 table
    assert gemm_bf16.WGMMA_TILES[LARGE] == (128, 128, 1)
    assert gemm_bf16.WGMMA_TILES[SMALL] == (64, 64, 3)
    assert gemm_bf16.MMA_TILES[LARGE] == (128, 128, 1)
    assert gemm_bf16.MMA_TILES[SMALL] == (64, 64, 3)
    assert gemm_bf16.tiles(8) is gemm_bf16.WGMMA_TILES
    assert gemm_bf16.tiles(2) is gemm_bf16.tiles(1) is gemm_bf16.MMA_TILES


SOURCE = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
          / "conv1x1_dw_bf16.cu")


def test_bf16_tile_tables_match_the_source():
    """The tables against the instances the C entry point launches: tile
    0 is the route's ``*Large``, tile 1 its ``*Small``; the wgmma
    instances' k-block is the plan's :data:`WGMMA_ROWS`."""
    src = SOURCE.read_text()
    wg = {n: tuple(map(int, a)) for n, *a in re.findall(
        r"using (Wg\w+) = WgCfg<(\d+), (\d+), \d+, (\d+)>;", src)}
    mma = {n: tuple(map(int, a)) for n, *a in re.findall(
        r"using (\w+) = Cfg<(\d+), (\d+), \d+, \d+, \d+, (\d+)>;", src)}
    assert (wg["WgLarge"], wg["WgSmall"]) == gemm_bf16.WGMMA_TILES
    assert (mma["Large"], mma["Small"]) == gemm_bf16.MMA_TILES
    assert re.search(r"launch_wgmma<WgLarge>.*\n.*launch_wgmma<WgSmall>", src)
    assert re.search(r"BK = (\d+);\n  static constexpr int STAGES = STAGES_",
                     src)[1] == str(gemm_bf16.WGMMA_ROWS)


@pytest.mark.parametrize("m,cin,cout", RESNET50_DW + [(1, 3, 10), (0, 8, 8),
                                                      (5000, 130, 70)])
def test_conv1x1_dw_bf16_splits_cover_m_in_one_wave(m, cin, cout):
    for width in (8, 2, 1):
        tiles = gemm_bf16.tiles(width)
        tile, splits = cc._plan(m, cin, cout, H100_SMS, tiles)
        assert tile == cc._plan(m, cin, cout, H100_SMS)[0]
        assert 1 <= splits <= 65535
        if splits > 1:
            assert m // splits >= cc._MIN_SPLIT_ROWS
        t = tiles[tile]
        n = -(-cin // t.rows) * -(-cout // t.cols)
        assert n * splits <= max(n, t.blocks_per_sm * H100_SMS)


@pytest.mark.parametrize("m,splits", [
    (401408, 396), (401408, 66), (100352, 33), (6272, 2), (6272, 1),
    (1000, 3), (1, 1), (65, 1), (257 * 64 + 5, 64), (2 ** 31 - 1, 65535)])
@pytest.mark.parametrize("width", [8, 2])
def test_bf16_split_rows_cover_m(m, splits, width):
    """The rows each split covers, as the kernel computes them
    (``split_kblocks`` on the wgmma route, ``s * M / splits`` on the
    mma.sync one), tile M exactly in order; on the wgmma route every split
    is whole 64-row k-blocks but the last, and at least
    ``_MIN_SPLIT_ROWS`` rows of k-blocks where the plan splits."""
    if width == 8:
        kbs = -(-m // gemm_bf16.WGMMA_ROWS)
        rows = [(min(m, s * kbs // splits * gemm_bf16.WGMMA_ROWS),
                 min(m, (s + 1) * kbs // splits * gemm_bf16.WGMMA_ROWS))
                for s in range(splits)]
    else:
        rows = [(s * m // splits, (s + 1) * m // splits)
                for s in range(splits)]
    assert len(rows) == splits and rows[0][0] == 0 and rows[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(b <= e for b, e in rows)
    if width == 8:
        kb = gemm_bf16.WGMMA_ROWS
        assert all(b % kb == 0 for b, _ in rows)
        if splits > 1 and splits <= m // cc._MIN_SPLIT_ROWS:
            assert min(-(-(e - b) // kb) for b, e in rows) \
                >= cc._MIN_SPLIT_ROWS // kb


def _bf16(rows, cols, offset=0):
    buf = torch.empty(rows * cols + offset, dtype=torch.bfloat16)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("m,cin,cout", RESNET50_DW)
def test_resnet50_shapes_take_the_wgmma_route(m, cin, cout):
    # a ResNet-50 step's operands are fresh tensors: 16-byte aligned rows
    # of 64-2048 channels; the plan reads shapes and pointers, no values
    x = torch.empty(m, cin, dtype=torch.bfloat16)
    dy = torch.empty(m, cout, dtype=torch.bfloat16)
    tile, splits, vec = cc._launch_plan(x, dy, H100_SMS)
    assert gemm_bf16.route(vec) == "wgmma" and vec == 8
    assert tile == (SMALL if min(cin, cout) < 128 else LARGE)
    assert (tile, splits) == cc._plan(m, cin, cout, H100_SMS,
                                      gemm_bf16.WGMMA_TILES)


@pytest.mark.parametrize("x,dy,width", [
    (_bf16(100, 64, 1), _bf16(100, 64), 1),      # 2 bytes off 4
    (_bf16(100, 64), _bf16(100, 64, 1), 1),
    (_bf16(100, 64, 2), _bf16(100, 64), 2),      # 4 bytes off 16
    (_bf16(100, 64), _bf16(100, 64, 6), 2),      # 12 bytes off 16
    (_bf16(100, 63), _bf16(100, 64), 1),         # an odd channel count
    (_bf16(100, 64), _bf16(100, 129), 1),
    (_bf16(100, 66), _bf16(100, 64), 2),         # even, not a multiple of 8
    (_bf16(100, 64, 8), _bf16(100, 64, 16), 8)])  # 16 and 32 bytes off
def test_views_and_odd_channels_take_mma_sync(x, dy, width):
    tile, splits, vec = cc._launch_plan(x, dy, H100_SMS)
    assert vec == width
    assert gemm_bf16.route(vec) == ("wgmma" if width == 8 else "mma_sync")
    assert (tile, splits) == cc._plan(x.shape[0], x.shape[1], dy.shape[1],
                                      H100_SMS, gemm_bf16.tiles(width))


def test_bf16_plan_is_a_function_of_shapes_layout_and_sms():
    # two allocations of the same shapes and alignment plan alike; a
    # different SM count may split differently, never the route or tile
    a = cc._launch_plan(_bf16(401408, 64), _bf16(401408, 256), H100_SMS)
    b = cc._launch_plan(_bf16(401408, 64, 8), _bf16(401408, 256, 64),
                        H100_SMS)
    assert a == b == (SMALL, 99, 8)
    c = cc._launch_plan(_bf16(401408, 64), _bf16(401408, 256), 16)
    assert (c[0], c[2]) == (a[0], a[2]) and c[1] == 12


@pytest.mark.parametrize("shape,offset,want", [
    ((64, 64), 0, 8), ((64, 8), 0, 8), ((64, 6), 0, 2), ((64, 66), 0, 2),
    ((64, 7), 0, 1), ((1, 1), 0, 1), ((64, 64), 1, 1), ((64, 64), 2, 2),
    ((64, 64), 4, 2), ((64, 64), 8, 8), ((64, 64), 64, 8)])
def test_bf16_copy_width(shape, offset, want):
    rows, cols = shape
    buf = torch.zeros(rows * cols + offset, dtype=torch.bfloat16)
    t = buf[offset:].view(rows, cols)
    assert t.is_contiguous()
    assert gemm_bf16.copy_width(t) == want


def test_bf16_copy_width_of_both_operands():
    x = torch.zeros(33, 64, dtype=torch.bfloat16)
    dy = torch.zeros(33, 128, dtype=torch.bfloat16)
    assert gemm_bf16.copy_width(x, dy) == 8
    assert gemm_bf16.copy_width(x[1:], dy[1:]) == 8     # 128-byte rows in
    assert gemm_bf16.copy_width(x, torch.zeros(33, 130,
                                               dtype=torch.bfloat16)) == 2
    assert gemm_bf16.copy_width(torch.zeros(34, 6, dtype=torch.bfloat16)[1:],
                                dy) == 2                # 12 bytes off 16
    assert gemm_bf16.copy_width(x, torch.zeros(33, 3,
                                               dtype=torch.bfloat16)) == 1
