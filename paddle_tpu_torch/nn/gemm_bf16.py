"""Host-side launch plan of ``conv1x1_dw_bf16`` (``csrc/conv1x1_dw_bf16.cu``,
bf16 operands summed in f32): its route, tile instance and copy width.

Two routes, picked by the operands' layout alone:

- ``"wgmma"``: ``wgmma.mma_async`` on 128-byte-swizzled shared-memory
  stages that TMA fills, for operands whose base pointers are 16-byte
  aligned and whose rows hold a multiple of 8 values (copy width 8). M is
  split in whole k-blocks of :data:`WGMMA_ROWS` rows: split ``s`` of
  ``S`` takes k-blocks ``[s * KB // S, (s + 1) * KB // S)`` of ``KB =
  ceil(M / WGMMA_ROWS)``.
- ``"mma_sync"``: ``mma.sync.m16n8k16`` fed by ``ldmatrix.trans``, for
  the views the first cannot load: 4-byte ``cp.async`` (copy width 2) or
  plain 2-byte loads (copy width 1, a view at an odd element offset or an
  odd row). Split ``s`` takes rows ``[s * M // S, (s + 1) * M // S)``.

Pure functions of shapes and pointers, so a run is repeatable bit for
bit and the CPU tests can check them. The tile is picked and M split as
for the f32 kernel (:func:`~.gemm_f32.pick_tile`, ``cuda_conv._splits``),
from the route's table."""

from __future__ import annotations

from typing import Tuple

from .gemm_f32 import LARGE, SMALL, Tile

__all__ = ["LARGE", "SMALL", "MMA_TILES", "WGMMA_ROWS", "WGMMA_TILES",
           "copy_width", "route", "tiles"]

# the instances of csrc/conv1x1_dw_bf16.cu by the index the C entry point
# takes: WgLarge, WgSmall (wgmma) and Large, Small (mma.sync)
WGMMA_TILES = (Tile(128, 128, 1), Tile(64, 64, 3))
MMA_TILES = (Tile(128, 128, 1), Tile(64, 64, 3))
WGMMA_ROWS = 64     # rows of M in a k-block of the wgmma route


def copy_width(*operands) -> int:
    """The copy the kernel stages rows with, in bf16 values: 8 (16-byte
    copies, the wgmma route) when every operand's base pointer is 16-byte
    aligned and its rows (its last dimension) hold a multiple of 8 values;
    else 2 (4-byte ``cp.async``) when every base pointer is 4-byte aligned
    and every row even; else 1 (plain 2-byte loads, which a view at an odd
    element offset or an odd row needs)."""
    for width, align in ((8, 16), (2, 4)):
        if all(t.data_ptr() % align == 0 and t.shape[-1] % width == 0
               for t in operands):
            return width
    return 1


def route(width: int) -> str:
    """``"wgmma"`` for copy width 8, else ``"mma_sync"``."""
    return "wgmma" if width == 8 else "mma_sync"


def tiles(width: int) -> Tuple[Tile, Tile]:
    """The tile table of the route that copy width ``width`` takes."""
    return WGMMA_TILES if width == 8 else MMA_TILES

