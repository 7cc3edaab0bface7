"""Fused LayerNorm and matrix product — the port of
``paddle_tpu/nn/fused_ln.py``.

:func:`fused_ln_matmul` computes ``LayerNorm(x) @ w`` with the
``LayerNorm`` module's numerics (f32 row mean and variance,
``rsqrt(var + eps)``, the optional scale and bias, the normalised rows
cast back to ``x``'s dtype before the product, the product accumulated in
f32). For CUDA tensors it launches ``ln_matmul`` (``csrc/ln_matmul.cu``,
the port of ``_ln_matmul_kernel``): a statistics pass writes each row's
mean and ``rsqrt(var + eps)`` to a ``[2, M]`` workspace, then the product
normalises each tile of ``x`` as it lands in shared memory, so the
normalised ``[M, K]`` tensor never reaches device memory; for CPU tensors
it runs the unfused :func:`ln_matmul_reference`. A CUDA call never falls
back: the wrapper checks device, dtype, shape and contiguity, raises on a
refused launch and counts each call (both passes) once in
:func:`launch_counts`. ``x`` and ``w`` both float32 launch ``ln_matmul``;
both bfloat16 launch ``ln_matmul_bf16`` (the same kernel on bf16 operands:
f32 statistics, the normalised tile rounded to bf16 before a bf16 product
summed in f32, the output in bf16, as ``_ln_matmul_kernel`` computes it
on bf16 inputs), with ``scale`` and ``bias`` in bf16 or f32; a mixed x/w
call is refused on the card. ``ln_matmul_bf16`` has two routes
(:func:`ln_bf16_plan`, counted in :func:`route_counts`): ``wgmma`` fed by
TMA for 16-byte aligned ``x`` and ``w`` whose rows hold a multiple of 8
values and ``K`` up to 1280 (a block takes a strip of ``x`` rows, its
statistics and its normalisation once, and walks every ``N`` tile of
``w`` over it; it reads bf16 ``scale`` and ``bias`` as they are), and
``mma.sync`` for the rest (a statistics launch, then the product; scale
and bias widened to f32 first).

The JAX function's argument checks are kept, so a call it refuses is
refused here too: ``K`` of ``x`` and ``w`` must agree, and the output
must tile by ``(block_m, block_n)`` (by default the ``_auto_block``
heuristic's, which always divides). The JAX autotuner is not ported: the
wrapper picks the kernel's own tile (128 x 128 or 64 x 64, :func:`_plan`),
and the block sizes are only checked.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import cuda_build
from ..utils.cuda_build import check_cuda, check_dtype, stream_ptr
from . import gemm_bf16
from .gemm_f32 import TILES, copy_width, pick_tile

__all__ = ["fused_ln_matmul", "ln_matmul_reference", "launch_counts",
           "reset_launch_counts", "route_counts", "ln_bf16_plan",
           "LnBf16Plan", "WGMMA_LN", "KERNELS"]

# kernel name -> csrc source stem
KERNELS = {"ln_matmul": "ln_matmul", "ln_matmul_bf16": "ln_matmul"}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# ln_matmul_bf16's launches by route (LnBf16Plan.route)
_routes: Dict[str, int] = {"wgmma": 0, "mma_sync": 0}

# x, w, scale, bias, out, stats; M K N; eps; tile vec; stream; and for the
# bf16 entry whether scale and bias are bf16
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_BF16 = _ARGTYPES + [ctypes.c_int]


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def route_counts() -> Dict[str, int]:
    """``ln_matmul_bf16``'s launches since the last
    :func:`reset_launch_counts`, by route: ``"wgmma"`` or
    ``"mma_sync"``."""
    return dict(_routes)


def reset_launch_counts() -> None:
    for counts in (_launches, _routes):
        for name in counts:
            counts[name] = 0


def _auto_block(t: int, cap: int) -> int:
    """Largest block ``<= cap`` dividing ``t``, preferring multiples of 128,
    then of 8, then any divisor (``pallas_attention._auto_block``)."""
    for b in range(min(cap, t) // 128 * 128, 127, -128):
        if t % b == 0:
            return b
    for b in range(min(cap, t) // 8 * 8, 7, -8):
        if t % b == 0:
            return b
    for b in range(min(cap, t), 0, -1):
        if t % b == 0:
            return b
    return min(cap, t)


def ln_matmul_reference(x, w, scale=None, bias=None, eps: float = 1e-6):
    """Unfused ``LayerNorm(x) @ w``: f32 statistics (the biased, two-pass
    variance), cast back to ``x.dtype`` before the product, f32
    accumulation, the result in ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y.float() @ w.float()).to(x.dtype)


def _check(x, w, scale, bias) -> str:
    """Raise unless a kernel takes the operands: ``x`` and ``w`` both f32
    (``ln_matmul``: ``scale``/``bias`` f32 too) or both bf16
    (``ln_matmul_bf16``: ``scale``/``bias`` bf16 or f32), contiguous, on
    x's card, ``scale``/``bias`` ``[K]``, sizes within 32-bit indices.
    Returns the kernel's name."""
    name = "ln_matmul"
    M, K = x.shape
    N = w.shape[1]
    affine = {}
    for key, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            if tuple(t.shape) != (K,):
                raise ValueError(f"{name}: {key} {tuple(t.shape)} must be "
                                 f"[{K}]")
            affine[key] = t
    if x.dtype == torch.bfloat16 or w.dtype == torch.bfloat16:
        if x.dtype != w.dtype:
            raise ValueError(f"{name}: mixed dtypes, x {x.dtype} and w "
                             f"{w.dtype}; the kernels take both f32 or both "
                             f"bf16")
        for key, t in affine.items():
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{name}: {key} has dtype {t.dtype}, the "
                                 f"bf16 kernel takes bf16 or f32")
        name = "ln_matmul_bf16"
    else:
        check_dtype(name, torch.float32, x=x, w=w, **affine)
    check_cuda(name, x.device, x=x, w=w, **affine)
    if max(M * K, K * N, M * N, 2 * M) >= 2 ** 31 or -(-M // 64) > 65535:
        raise ValueError(f"{name}: [{M}, {K}] x [{K}, {N}] exceeds the "
                         f"kernel's sizes")
    return name


def _plan(M: int, N: int, sms: int) -> int:
    """The tile instance of the product: 128 x 128 where the output gives
    at least one such tile per SM, else 64 x 64."""
    return pick_tile(M, N, min_tiles=sms)


class _LnWgTile(NamedTuple):
    rows: int        # rows of x a block's strip holds
    stages: int      # TMA stages of w tiles
    k_max: int       # the largest K whose strip fits shared memory


_MAX_SMEM = 232448     # dynamic shared memory a block may opt into
_LN_BN = 128           # columns of an N tile of the wgmma route
_LN_STAGE = 64 * _LN_BN * 2   # bytes of a [64, BN] bf16 w tile


def _ln_wg_smem(rows: int, stages: int, K: int) -> int:
    """``LnW::smem_bytes``: 1024 bytes to align to the swizzle's period,
    the strip (``ceil(K / 64)`` k-blocks of ``rows`` x 64 bf16 values), the
    w stages and ``2 stages + 1`` mbarriers of 8 bytes."""
    return (1024 + -(-K // 64) * rows * 128 + stages * _LN_STAGE
            + 8 * (2 * stages + 1))


def _ln_wg_tile(rows: int, stages: int) -> _LnWgTile:
    # beside 8 bytes a row of static shared memory (its statistics)
    kb_max = (_MAX_SMEM - 8 * rows - _ln_wg_smem(rows, stages, 0)) // (
        rows * 128)
    return _LnWgTile(rows, stages, 64 * kb_max)


# the wgmma instances of csrc/ln_matmul.cu (LnLarge, LnSmall) by the index
# the entry point takes: strips of 128 rows for K up to 640, of 64 rows for
# K up to 1280 (each beside four w stages)
WGMMA_LN = (_ln_wg_tile(128, 4), _ln_wg_tile(64, 4))


class LnBf16Plan(NamedTuple):
    """The launch of ``ln_matmul_bf16`` (``csrc/ln_matmul.cu``): ``route``
    ``"wgmma"`` or ``"mma_sync"``, ``tile`` the instance index and ``vec``
    the copy width the entry point takes. On ``wgmma`` a block holds a
    strip of ``rows`` rows of x (all of K; ``smem`` bytes of shared
    memory with the w stages) and walks its share of the ``ceil(N /
    cols)`` N tiles, N split ``splits`` ways; on ``mma.sync`` a block owns
    a ``rows x cols`` output tile (``smem`` 0: the instance's fixed
    figure, ``splits`` 1). ``grid`` is ``(blocks along N, blocks along
    M)``."""
    route: str
    tile: int
    vec: int
    rows: int
    cols: int
    smem: int
    splits: int
    grid: Tuple[int, int]


def ln_bf16_plan(M: int, K: int, N: int, width: int, sms: int) -> LnBf16Plan:
    """The launch for bf16 ``x [M, K]``, ``w [K, N]`` of copy width
    ``width`` (:func:`~.gemm_bf16.copy_width`) on a card of ``sms`` SMs;
    pure Python, a function of these alone. Width 8 with ``K`` within an
    instance's reach takes ``wgmma``: the 128-row strip where ``K <=
    WGMMA_LN[0].k_max``, else the 64-row one, and ``N``'s tiles split
    into as many shares as fill one wave with the strips (at least one
    share, no more shares than tiles; the kernel computes the same).
    Otherwise ``mma.sync``
    with the 128 x 128 tile where the output gives one per SM, else 64 x
    64 (:func:`_plan`), on 4-byte copies (width 8 past the instances'
    K, or 2) or plain loads (1)."""
    if width == 8:
        for tile, t in enumerate(WGMMA_LN):
            if K <= t.k_max:
                strips = -(-M // t.rows)
                n_tiles = -(-N // _LN_BN)
                splits = max(1, min(n_tiles, sms // strips))
                return LnBf16Plan("wgmma", tile, 8, t.rows, _LN_BN,
                                  _ln_wg_smem(t.rows, t.stages, K), splits,
                                  (splits, strips))
    vec = 1 if width == 1 else 2
    tile = _plan(M, N, sms)
    t = TILES[tile]
    return LnBf16Plan("mma_sync", tile, vec, t.rows, t.cols, 0, 1,
                      (-(-N // t.cols), -(-M // t.rows)))


def _stats_numel(M: int) -> int:
    """Floats of the statistics workspace: each row's mean, then each
    row's ``1 / sqrt(var + eps)``."""
    return 2 * M


def fused_ln_matmul(x, w, scale=None, bias=None, *, eps: float = 1e-6,
                    block_m: Optional[int] = None,
                    block_n: Optional[int] = None):
    """``LayerNorm(x) @ w``: ``x [M, K]``, ``w [K, N]``, optional
    ``scale``/``bias`` ``[K]`` (the ``LayerNorm`` module's affine
    parameters), ``eps`` as the module's. ``block_m``/``block_n``: tile
    sizes the JAX kernel would use, which must divide ``M``/``N``; None
    takes the heuristic's. The result has x's dtype."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"fused_ln_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be [M, K] and [K, N]")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"x [{M},{K}] @ w [{K2},{N}]: contraction mismatch")
    bm = _auto_block(M, 128) if block_m is None else min(block_m, M)
    bn = _auto_block(N, 512) if block_n is None else min(block_n, N)
    if M % bm or N % bn:
        raise ValueError(f"[{M},{N}] must tile by blocks ({bm}, {bn})")
    if all(t is None or t.device.type == "cpu"
           for t in (x, w, scale, bias)):
        return ln_matmul_reference(x, w, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul: no kernel for x on {x.device}")
    name = _check(x, w, scale, bias)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    route, extra = None, ()
    if name == "ln_matmul_bf16":
        plan = ln_bf16_plan(M, K, N, gemm_bf16.copy_width(x, w), sms)
        route, tile, vec = plan.route, plan.tile, plan.vec
        affine = [t for t in (scale, bias) if t is not None]
        # the wgmma route reads bf16 scale and bias where both are bf16;
        # otherwise the kernel reads f32 (one [K] widening each)
        bf = bool(affine) and route == "wgmma" and all(
            t.dtype == torch.bfloat16 for t in affine)
        if not bf:
            scale, bias = (None if t is None else t.float().contiguous()
                           for t in (scale, bias))
        extra = (int(bf),)
    else:
        tile, vec = _plan(M, N, sms), copy_width(x, w, scale, bias)
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    stats = torch.empty(_stats_numel(M), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        cuda_build.launch(_launches, name, KERNELS[name],
                          _ARGTYPES_BF16 if extra else _ARGTYPES,
                          x.data_ptr(), w.data_ptr(),
                          None if scale is None else scale.data_ptr(),
                          None if bias is None else bias.data_ptr(),
                          out.data_ptr(), stats.data_ptr(), M, K, N,
                          float(eps), tile, vec, stream_ptr(x), *extra)
    if route is not None:
        _routes[route] += 1
    return out
