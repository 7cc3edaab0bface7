"""1x1 convolution as a matrix product with a CUDA weight-gradient kernel —
the port of ``paddle_tpu/nn/pallas_conv.py``.

A 1x1 stride-1 convolution over NHWC activations is the product
``[B*H*W, Cin] @ [Cin, Cout]``. :func:`conv1x1` computes it as one, under
:class:`Conv1x1Function`: the forward ``x2d @ w`` and the input gradient
``dy2d @ w^T`` stay plain ``torch.matmul`` products, as the JAX package
leaves them to XLA; the weight gradient ``dW = x2d^T @ dy2d``, a reduction
over a huge M into a tiny ``[Cin, Cout]``, is the ``conv1x1_dw`` kernel
(``csrc/conv1x1_dw.cu``, the port of ``_dw_kernel``) on float32
operands and ``conv1x1_dw_bf16`` (``csrc/conv1x1_dw_bf16.cu``) on the
bf16 operands of the ``bfloat16_compute`` policy, each summing in f32.
:func:`conv1x1_strided` is the stride-s shortcut: slice, then
:func:`conv1x1`.

Under ``bfloat16_compute`` the layer hands this module bf16 ``x`` and
``w``, as the JAX layer hands ``conv1x1``: the forward and ``dx`` are bf16
products (cuBLAS sums them in f32 and rounds the result to bf16, given
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False``), and ``dW`` is the f32 sum of the kernel rounded to ``w``'s
bf16, as ``pallas_conv.py`` casts ``dw_pallas``'s output.

:func:`conv1x1_dw` is the wrapper: the plain version
:func:`conv1x1_dw_plain` for CPU tensors, a kernel for CUDA tensors
picked by the operands' dtype (float32 or bf16; mixed or other dtypes
raise), with device, shape and contiguity checked, the launch checked and
counted in :func:`launch_counts` under the kernel's name; no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..utils import cuda_build
from ..utils.cuda_build import check_cuda, check_dtype, stream_ptr
from . import gemm_bf16
from .gemm_f32 import TILES, copy_width, pick_tile

__all__ = ["Conv1x1Function", "conv1x1", "conv1x1_dw", "conv1x1_dw_plain",
           "conv1x1_strided", "launch_counts", "reset_launch_counts",
           "route_counts", "KERNELS"]

# kernel name -> csrc source stem
KERNELS = {"conv1x1_dw": "conv1x1_dw", "conv1x1_dw_bf16": "conv1x1_dw_bf16"}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# conv1x1_dw_bf16's launches by route (gemm_bf16.route)
_routes: Dict[str, int] = {"wgmma": 0, "mma_sync": 0}

_MIN_SPLIT_ROWS = 256  # no split of M shorter than this: 8 k-tiles of 32


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def route_counts() -> Dict[str, int]:
    """``conv1x1_dw_bf16``'s launches since the last
    :func:`reset_launch_counts`, by route: ``"wgmma"`` or
    ``"mma_sync"``."""
    return dict(_routes)


def reset_launch_counts() -> None:
    for counts in (_launches, _routes):
        for name in counts:
            counts[name] = 0


def conv1x1_dw_plain(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """``x2d^T @ dy2d`` in float32, ``[Cin, Cout]`` — the oracle of the JAX
    package's tests for ``dw_pallas``. bf16 operands widen exactly, and
    their products are exact in f32, as in ``dw_pallas``."""
    return x2d.float().T @ dy2d.float()


def _plan(m: int, cin: int, cout: int, sms: int,
          tiles=TILES) -> Tuple[int, int]:
    """``(tile, splits)`` of a kernel's launch: the tile instance for a
    ``[cin, cout]`` output (:func:`~.gemm_f32.pick_tile`) and
    :func:`_splits`, from the kernel's table of instances (``tiles``: the
    f32 kernel's :data:`~.gemm_f32.TILES` or a table of the bf16 kernel's,
    :func:`~.gemm_bf16.tiles`). A function of the shapes and the SM count
    only, so a run is repeatable bit for bit."""
    tile = pick_tile(cin, cout)
    return tile, _splits(m, cin, cout, sms, tile, tiles)


def _splits(m: int, cin: int, cout: int, sms: int, tile: int,
            tiles=TILES) -> int:
    """The splits of M: as many as fill one wave of resident blocks
    (output tiles times splits up to ``blocks_per_sm * sms``), at least
    one, none shorter than ``_MIN_SPLIT_ROWS`` rows, at most 65535 (the
    grid's z limit)."""
    t = tiles[tile]
    tiles = -(-cin // t.rows) * -(-cout // t.cols)
    return max(1, min(t.blocks_per_sm * sms // tiles, m // _MIN_SPLIT_ROWS,
                      65535))


def _launch_plan(x2d: torch.Tensor, dy2d: torch.Tensor,
                 sms: int) -> Tuple[int, int, int]:
    """``(tile, splits, vec)`` of a launch on ``x2d``'s dtype: the copy
    width from the operands' pointers and rows, then the tile and the
    splits of M from the table of the instances that width reaches (for
    bf16 also the route: ``vec`` 8 is the wgmma route,
    :func:`~.gemm_bf16.route`). A function of shapes, pointers and the
    SM count only."""
    (m, cin), cout = x2d.shape, dy2d.shape[1]
    if x2d.dtype == torch.bfloat16:
        vec = gemm_bf16.copy_width(x2d, dy2d)
        tiles = gemm_bf16.tiles(vec)
    else:
        vec, tiles = copy_width(x2d, dy2d), TILES
    return (*_plan(m, cin, cout, sms, tiles), vec)


# operand dtype -> kernel name
_BY_DTYPE = {torch.float32: "conv1x1_dw", torch.bfloat16: "conv1x1_dw_bf16"}


def conv1x1_dw(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """``dW = x2d^T @ dy2d`` with f32 accumulation: ``x2d [M, Cin]``,
    ``dy2d [M, Cout]``, both float32 or both bf16, give ``[Cin, Cout]``
    f32. The dtypes are checked first (mixed or other dtypes raise, on
    any device); then CPU tensors run :func:`conv1x1_dw_plain` and CUDA
    tensors launch ``conv1x1_dw`` (float32) or ``conv1x1_dw_bf16`` (bf16),
    one launch counted once under that name, whatever the split of M."""
    if x2d.dtype not in _BY_DTYPE:
        raise ValueError(f"conv1x1_dw: x2d has dtype {x2d.dtype}; the "
                         f"kernels take float32 or bfloat16")
    name = _BY_DTYPE[x2d.dtype]
    check_dtype(name, x2d.dtype, dy2d=dy2d)
    if x2d.device.type == "cpu" and dy2d.device.type == "cpu":
        return conv1x1_dw_plain(x2d, dy2d)
    dev = x2d.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for x2d on {dev}")
    if x2d.dim() != 2 or dy2d.dim() != 2 or x2d.shape[0] != dy2d.shape[0]:
        raise ValueError(f"{name}: x2d {tuple(x2d.shape)} and dy2d "
                         f"{tuple(dy2d.shape)} must be [M, Cin] and "
                         f"[M, Cout]")
    check_cuda(name, dev, x2d=x2d, dy2d=dy2d)
    m, cin = x2d.shape
    cout = dy2d.shape[1]
    if max(m * cin, m * cout, cin * cout) >= 2 ** 31:
        raise ValueError(f"{name}: [{m}, {cin}] x [{m}, {cout}] exceeds "
                         f"the kernel's 32-bit sizes")
    out = torch.empty(cin, cout, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile, splits, vec = _launch_plan(x2d, dy2d, sms)
    work = torch.empty(splits, cin, cout, dtype=torch.float32, device=dev) \
        if splits > 1 else None
    with torch.cuda.device(dev):
        cuda_build.launch(_launches, name, KERNELS[name], _ARGTYPES,
                          x2d.data_ptr(), dy2d.data_ptr(), out.data_ptr(),
                          None if work is None else work.data_ptr(), m, cin,
                          cout, splits, tile, vec, stream_ptr(x2d))
    if name == "conv1x1_dw_bf16":
        _routes[gemm_bf16.route(vec)] += 1
    return out


# x, dy, out, work; M Cin Cout splits tile vec; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


class Conv1x1Function(torch.autograd.Function):
    """``y = x @ w`` over NHWC ``x [B, H, W, Cin]`` and ``w [Cin, Cout]``,
    the JAX ``conv1x1`` ``custom_vjp``: the backward gives ``dx = dy @
    w^T`` (a plain product) and ``dW`` from :func:`conv1x1_dw`, each only
    where autograd asks for it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cin, cout = w.shape
        dy2 = dy.reshape(-1, cout).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (dy2 @ w.T).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = conv1x1_dw(x.reshape(-1, cin), dy2).to(w.dtype)
        return dx, dw


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, ww, cin = x.shape
    return (x.reshape(b * h * ww, cin) @ w).reshape(b, h, ww, w.shape[1])


def conv1x1(x: torch.Tensor, w: torch.Tensor, *,
            kernel_dw: bool = True) -> torch.Tensor:
    """``y[b, h, w, :] = x[b, h, w, :] @ w``; ``x [B, H, W, Cin]``, ``w
    [Cin, Cout]``. A non-contiguous ``x`` is copied first (the kernel
    reads rows of ``[B*H*W, Cin]``). With ``kernel_dw`` the product runs
    under :class:`Conv1x1Function` and its weight gradient is the
    ``conv1x1_dw`` kernel; without, autograd differentiates the plain
    product (the ``"matmul"`` lowering)."""
    x = x.contiguous()
    return Conv1x1Function.apply(x, w) if kernel_dw else _product(x, w)


def conv1x1_strided(x: torch.Tensor, w: torch.Tensor, stride=(1, 1), *,
                    kernel_dw: bool = True) -> torch.Tensor:
    """The stride-s 1x1 convolution (the bottleneck shortcut): slicing
    commutes with a pointwise product, so ``x[:, ::sh, ::sw, :]`` then
    :func:`conv1x1`; the slice's gradient scatters into zeros."""
    sh, sw = stride
    if (sh, sw) != (1, 1):
        x = x[:, ::sh, ::sw, :]
    return conv1x1(x, w, kernel_dw=kernel_dw)
