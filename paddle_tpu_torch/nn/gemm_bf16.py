"""Host-side launch plan of ``conv1x1_dw_bf16`` (``csrc/conv1x1_dw_bf16.cu``,
bf16 operands on ``mma.sync.m16n8k16``): its tile instances and its copy
width. Pure functions of shapes and pointers, so a run is repeatable bit
for bit and the CPU tests can check them. The tile is picked and M split
as for the f32 kernel (:func:`~.gemm_f32.pick_tile`,
``cuda_conv._splits``), from this table."""

from __future__ import annotations

from .gemm_f32 import LARGE, SMALL, Tile

__all__ = ["LARGE", "SMALL", "TILES", "copy_width"]

# the instances of csrc/conv1x1_dw_bf16.cu (Large, Small), by the index
# the C entry point takes
TILES = (Tile(128, 128, 1), Tile(64, 64, 4))


def copy_width(*operands) -> int:
    """The copy the kernel stages rows with, in bf16 values: 8 (16-byte
    ``cp.async``) when every operand's base pointer is 16-byte aligned and
    its rows (its last dimension) hold a multiple of 8 values; else 2
    (4-byte ``cp.async``) when every base pointer is 4-byte aligned and
    every row even; else 1 (plain 2-byte loads, which a view at an odd
    element offset or an odd row needs)."""
    for width, align in ((8, 16), (2, 4)):
        if all(t.data_ptr() % align == 0 and t.shape[-1] % width == 0
               for t in operands):
            return width
    return 1
