"""Host-side launch plans of the kernels built on ``csrc/gemm_f32.cuh``
(``conv1x1_dw`` and ``ln_matmul``): which tile instance, which copy
width. Pure functions of shapes, pointers and the SM count, so a run is
repeatable bit for bit and the CPU tests can check them."""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["LARGE", "SMALL", "TILES", "Tile", "copy_width", "pick_tile"]


class Tile(NamedTuple):
    rows: int           # output rows per block
    cols: int           # output columns per block
    blocks_per_sm: int  # resident blocks an SM holds (registers, smem)


# the instances of csrc/gemm_f32.cuh (Large, Small), by the index the C
# entry points take
TILES = (Tile(128, 128, 1), Tile(64, 64, 3))
LARGE, SMALL = 0, 1


def pick_tile(rows: int, cols: int, min_tiles: int = 0) -> int:
    """:data:`LARGE` where the output reaches 128 in both dimensions and
    gives at least ``min_tiles`` large tiles, else :data:`SMALL`."""
    big = TILES[LARGE]
    if rows < big.rows or cols < big.cols:
        return SMALL
    n = -(-rows // big.rows) * -(-cols // big.cols)
    return LARGE if n >= min_tiles else SMALL


def copy_width(*operands) -> int:
    """4 (16-byte ``cp.async``) when every operand's base pointer is
    16-byte aligned and its rows (its last dimension) hold a multiple of 4
    floats, else 1 (4-byte copies). ``None`` operands are skipped."""
    for t in operands:
        if t is None:
            continue
        if t.data_ptr() % 16 or t.shape[-1] % 4:
            return 1
    return 4
