"""Attention kernels of the port — the port of
``paddle_tpu/nn/pallas_attention.py``'s flash forward and backward and its
paged decode and paged span, over f32, bf16 and int8 pools.

Each kernel comes as three pieces:

- a plain PyTorch version (``*_plain``): the same function written with
  whole-tensor ops, the CPU path and the card's yardstick;
- a CUDA C++ kernel for ``sm_90a`` in ``paddle_tpu_torch/csrc/``, built at
  first use and called through :mod:`ctypes`;
- a wrapper (the public name) that runs the plain version for CPU tensors
  and the kernel for CUDA tensors. A CUDA tensor never falls back: the
  wrapper checks device, dtype, shape and contiguity, launches on the
  current stream, raises if the launch is refused, and counts the launch
  in :func:`launch_counts`.

:func:`flash_attention` is differentiable: under grad mode, with an input
that requires grad, it runs through :class:`FlashAttentionFunction`, whose
backward is :func:`flash_attention_bwd` (the ``flash_bwd_dq`` and
``flash_bwd_dkv`` kernels). Under ``torch.no_grad()`` it launches the
forward kernel alone and saves nothing.

The flash kernels take q, k, v (and dO, O) all float32 or all bfloat16,
as the JAX kernels take either: bf16 operands launch ``flash_fwd_bf16``,
``flash_bwd_dq_bf16`` and ``flash_bwd_dkv_bf16``, which multiply bf16
values into f32 sums, round p (and ds) to bf16 before the second product
and write O, dq, dk and dv in bf16; the LSE and delta stay f32 (the bf16
backward's delta by ``flash_bwd_delta_bf16``). 16-byte aligned bf16
operands go by ``wgmma`` fed by TMA, views 4 bytes off 16 by
``mma.sync`` (:func:`route_counts`). Mixed dtypes are refused on the card
(JAX would promote them).

Layouts are the JAX package's: ``[B, H, T, D]`` for flash, LSE and delta
``[B, H, T]``; ``q [S, H, D]``, one layer's pools ``[N, bs, H, D]``,
``tables [S, MB]``, ``lengths [S]`` for paged decode; ``q [S, Q, H, D]``
and ``start``/``n`` ``[S]`` for paged span. A quantized pool is the tuple
``(int8 values [N, bs, H, D], f32 scales [N, bs, H])``; the kernels
dequantize it on chip and count their launches apart
(``paged_decode_int8``, ``paged_span_int8``). A bf16 pool (both pools
``torch.bfloat16``) is widened on chip, and p is rounded to bf16 before
``p . V`` as JAX's kernels round it (``paged_decode_bf16``,
``paged_span_bf16``). The paged kernels split the context into fixed
partitions (:func:`paged_plan`) and merge the partials in a second launch
(a bf16 call runs a max pass over K first, which stores the scores its main
pass reads in K's place: K crosses once). The paged kernels take
float32 queries (the path's projections accumulate in f32); all take
``D`` in {64, 128}.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from ..utils import cuda_build
from ..utils.cuda_build import check_cuda, check_dtype, stream_ptr
from .gemm_f32 import copy_width

__all__ = ["FlashAttentionFunction", "FlashBwdPlan", "FlashFwdPlan",
           "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_bwd_delta",
           "flash_attention_fwd", "flash_attention_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "flash_bwd_dq", "flash_bwd_dq_plain",
           "flash_bwd_plan", "flash_fwd_plan", "flash_copy_width",
           "paged_decode_attention", "paged_decode_plain",
           "paged_span_attention", "paged_span_plain", "paged_plan",
           "paged_rounding_slack",
           "PagedPlan", "PAGED_BF16_KERNELS", "POOL_BF16", "POOL_F32",
           "POOL_INT8", "paged_pv_smem_bytes",
           "launch_counts", "reset_launch_counts", "route_counts",
           "capturing_launches", "count_replay", "KERNELS", "SPAN_MAX_Q"]

_NEG = -1e30
_HEAD_DIMS = (64, 128)

# kernel name -> csrc source stem
KERNELS = {"flash_fwd": "flash_fwd", "paged_decode": "paged_decode",
           "flash_bwd_dq": "flash_bwd", "flash_bwd_dkv": "flash_bwd",
           "flash_fwd_bf16": "flash_fwd", "flash_bwd_dq_bf16": "flash_bwd",
           "flash_bwd_dkv_bf16": "flash_bwd",
           "flash_bwd_delta_bf16": "flash_bwd",
           "paged_span": "paged_span", "paged_span_int8": "paged_span",
           "paged_decode_int8": "paged_decode",
           "paged_decode_bf16": "paged_decode",
           "paged_span_bf16": "paged_span"}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# the bf16 flash kernels' launches by route (FlashFwdPlan.route,
# FlashBwdPlan.route)
_routes: Dict[str, Dict[str, int]] = {
    name: {"wgmma": 0, "mma_sync": 0}
    for name in ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}
# where _launch counts: _launches, or a capture's own tally while a CUDA
# graph is being captured (its launches run only when it replays)
_counter = [_launches]


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, those
    of CUDA graph replays included (:func:`count_replay`)."""
    return dict(_launches)


def route_counts(kernel: str) -> Dict[str, int]:
    """The launches of ``kernel`` (``flash_fwd_bf16``,
    ``flash_bwd_dq_bf16`` or ``flash_bwd_dkv_bf16``) since the last
    :func:`reset_launch_counts`, by route: ``"wgmma"`` (16-byte aligned
    operands) or ``"mma_sync"`` (views 4 bytes off 16)."""
    return dict(_routes[kernel])


def reset_launch_counts() -> None:
    for counts in (_launches, *_routes.values()):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def capturing_launches() -> Iterator[Dict[str, int]]:
    """Inside the block (a CUDA graph capture) the wrappers count their
    launches in the yielded dict instead of :func:`launch_counts`: a
    captured launch runs only when the graph replays."""
    captured = {name: 0 for name in KERNELS}
    _counter.append(captured)
    try:
        yield captured
    finally:
        _counter.pop()


def count_replay(captured: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture launched ``captured``."""
    for name, n in captured.items():
        _launches[name] += n


# ---------------------------------------------------------------------------
# flash forward and backward
# ---------------------------------------------------------------------------

def _scores(q, k, segments, causal: bool, scale: float) -> torch.Tensor:
    """``q.k^T * scale`` in f32, ``[B, H, T, T]``, with ``-inf`` on the
    pairs that do not attend (the causal cone, other segments, padding)."""
    T = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    vis = torch.ones(T, T, dtype=torch.bool, device=q.device)
    if causal:
        vis = torch.tril(vis)
    vis = vis[None, None]
    if segments is not None:
        sq, sk = segments[:, :, None], segments[:, None, :]
        vis = vis & ((sq == sk) & (sq > 0) & (sk > 0))[:, None]
    return s.masked_fill(~vis, float("-inf"))


def _rounded(p: torch.Tensor, dtype) -> torch.Tensor:
    """``p`` rounded to ``dtype`` and widened back to f32, as the JAX
    kernels cast p and ds to the other operand's dtype before their second
    product (``p.astype(v.dtype)``); f32 leaves ``p`` as it is, bit for
    bit."""
    return p if dtype == torch.float32 else p.to(dtype).float()


def _probs(q, k, segments, lse, causal, scale) -> torch.Tensor:
    """``p = exp(q.k^T * scale - LSE)`` with masked pairs at 0, f32."""
    return torch.exp(_scores(q, k, segments, causal, scale) - lse[..., None])


def flash_attention_plain(q, k, v, segments=None, causal: bool = False,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O [B, H, T, D], LSE [B, H, T] f32)`` with the kernel's
    conventions: masked scores are ``-inf``, the row max is floored at
    ``-1e30`` and the row sum clamped at ``1e-30``, so a row with no
    visible key (segment id 0) gives zeros and an LSE of about ``-1e30``.
    As in JAX's ``_attn_kernel``, the row sum takes the f32 p and the
    product with v takes p rounded to v's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, segments, causal, scale)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", _rounded(p, v.dtype),
                       v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_dq_plain(q, k, v, segments, do, lse, delta,
                       causal: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``dq = scale * (p * (dO.v^T - delta)) . k`` — the ``flash_bwd_dq``
    kernel's function, from whole tensors; ds rounded to k's dtype before
    the product, as in JAX's ``_dq_kernel``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _probs(q, k, segments, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    return (torch.einsum("bhqk,bhkd->bhqd", _rounded(ds, k.dtype), k.float())
            * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, segments, do, lse, delta,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` with ``dk = scale * ds^T . q`` and ``dv = p^T . dO`` —
    the ``flash_bwd_dkv`` kernel's function, from whole tensors; ds
    rounded to q's dtype and p to dO's before the products, as in JAX's
    ``_dkv_kernel``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _probs(q, k, segments, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", _rounded(p, do.dtype), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32, ``[B, H, T]``."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_delta(o, do) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, T]``, which the backward
    kernels take (JAX computes it outside its kernels too). CPU tensors
    run the plain version; bf16 ones on the card launch
    ``flash_bwd_delta_bf16``, one pass over O and dO that sums their
    exact products in f32 (the plain version writes and reads two f32
    copies of both). On the card ``o`` and ``do`` must be bf16 of one
    shape ``[B, H, T, D]`` with ``D`` in ``(64, 128)``, contiguous on one
    device and 4-byte aligned (the kernel loads pairs of values)."""
    if o.device.type == "cpu":
        return _delta(o, do)
    name = "flash_bwd_delta"
    if o.dim() != 4 or do.shape != o.shape:
        raise ValueError(f"{name}: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be one [B, H, T, D] shape")
    B, H, T, D = o.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_HEAD_DIMS}")
    check_dtype(name, torch.bfloat16, o=o, do=do)
    check_cuda(name, o.device, o=o, do=do)
    if flash_copy_width(o, do) == 0:
        raise ValueError(f"{name}: a bf16 operand lies 2 bytes off a 4-byte "
                         f"boundary; the kernel loads 4 bytes at a time")
    delta = torch.empty((B, H, T), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        _launch("flash_bwd_delta_bf16", o.data_ptr(), do.data_ptr(),
                delta.data_ptr(), B * H * T, D, stream_ptr(o))
    return delta


def flash_attention_bwd_plain(q, k, v, segments, o, lse, do,
                              causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(dq, dk, dv)`` of the flash forward from its saved ``O`` and
    ``LSE``, as the two kernels compute them: ``delta = rowsum(dO * O)``
    in f32, ``p = exp(s - LSE)``, ``ds = p * (dp - delta)``, the scale
    applied once, to dq and dk. Masked pairs and padding rows (LSE about
    ``-1e30``) give ``p = 0``."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, segments, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, segments, do, lse, delta, causal,
                                 scale)
    return dq, dk, dv


_FLASH_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_name(name: str, dtype) -> str:
    """The flash kernel ``name`` for operands of ``dtype``: ``name`` for
    float32, ``name + "_bf16"`` for bfloat16."""
    return name + "_bf16" if dtype == torch.bfloat16 else name


def flash_copy_width(*operands) -> int:
    """The copy a flash kernel stages rows with, in values: for float32
    operands 4 (16-byte ``cp.async``: every base pointer 16-byte aligned)
    or 1 (4-byte copies); for bf16 ones 8 (16 bytes) or 2 (4 bytes: every
    base pointer 4-byte aligned), and 0 where a bf16 pointer lies 2 bytes
    off 4, which no copy of the kernels takes. A row of D in {64, 128}
    values is a whole number of either copy."""
    if operands[0].dtype == torch.bfloat16:
        for width, align in ((8, 16), (2, 4)):
            if all(t.data_ptr() % align == 0 for t in operands):
                return width
        return 0
    return copy_width(*operands)


def _check_flash(name: str, q, k, v, segments, same=None, rows=None):
    """Validate the flash kernels' operands for a launch on ``q``'s card:
    ``k``, ``v`` and ``same`` shaped like ``q`` and of its dtype (float32
    or bf16; a mixed call is refused: JAX would promote it, the kernels
    take one dtype), bf16 ones at least 4-byte aligned, ``rows`` ``[B, H,
    T]`` f32, all contiguous on one device, ``segments`` ``[B, T]`` int32.
    Returns the segments pointer (``None`` without segments)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    B, H, T, D = q.shape
    same = {"k": k, "v": v, **(same or {})}
    rows = rows or {}
    for key, t in same.items():
        if t.shape != q.shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    for key, t in rows.items():
        if tuple(t.shape) != (B, H, T):
            raise ValueError(f"{name}: {key} {tuple(t.shape)} != "
                             f"{(B, H, T)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid's 65535")
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{name}: q has dtype {q.dtype}, the kernels take "
                         f"torch.float32 or torch.bfloat16")
    mixed = {key: t.dtype for key, t in same.items() if t.dtype != q.dtype}
    if mixed:
        raise ValueError(f"{name}: mixed dtypes, q {q.dtype} and "
                         + ", ".join(f"{key} {d}" for key, d in mixed.items())
                         + "; the kernels take one dtype")
    check_dtype(name, torch.float32, **rows)
    check_cuda(name, q.device, q=q, **same, **rows)
    if flash_copy_width(q, *same.values()) == 0:
        raise ValueError(f"{name}: a bf16 operand lies 2 bytes off a 4-byte "
                         f"boundary; the kernels copy 4 or 16 bytes at a "
                         f"time")
    if segments is None:
        return None
    if tuple(segments.shape) != (B, T):
        raise ValueError(f"{name}: segments {tuple(segments.shape)} != "
                         f"{(B, T)}")
    check_dtype(name, torch.int32, segments=segments)
    check_cuda(name, q.device, segments=segments)
    return segments.data_ptr()


def _launch(name: str, *args) -> None:
    """Launch kernel ``name`` with ``args`` and count it."""
    cuda_build.launch(_counter[-1], name, KERNELS[name], _ARGTYPES[name],
                      *args)


def flash_attention_fwd(q, k, v, segments=None, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention forward over ``[B, H, T, D]`` returning ``(O,
    LSE)``; ``segments`` ``[B, T]`` int32 packed-sequence ids (1-based,
    0 = padding) confine attention within each sub-sequence, shared
    across heads. Any ``T`` is taken; tiles past ``T`` are masked. CUDA
    tensors launch ``flash_fwd`` on :func:`flash_fwd_plan`'s instance,
    with 16-byte copies where ``q``, ``k`` and ``v`` allow them, else
    4-byte ones (any contiguous view); bf16 tensors launch
    ``flash_fwd_bf16`` (O in bf16, the LSE in f32), on views at any 4-byte
    offset: by ``wgmma`` fed by TMA where ``q``, ``k``, ``v`` and O start
    on 16-byte boundaries, else by ``mma.sync`` on 4-byte copies
    (:func:`route_counts`)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segments, causal, scale)
    seg_ptr = _check_flash("flash_attention", q, k, v, segments)
    B, H, T, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    width = flash_copy_width(q, k, v, out)
    plan = flash_fwd_plan(B, H, T, D, causal, q.dtype, width)
    with torch.cuda.device(q.device):          # launch on q's card
        _launch(_kernel_name("flash_fwd", q.dtype), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), seg_ptr, out.data_ptr(),
                lse.data_ptr(), B, H, T, D, scale, int(causal), plan.tile,
                width, stream_ptr(q))
    if q.dtype == torch.bfloat16:
        _routes["flash_fwd_bf16"][plan.route] += 1
    return out, lse


class _FwdTile(NamedTuple):
    rows: int           # query rows a block owns, 16 a row group
    stream_rows: int    # rows of each streamed K/V tile
    stages: int         # cp.async ring stages
    blocks_per_sm: int  # resident blocks an SM holds (smem, registers)
    key_splits: int     # warps a row group, each on its part of a tile


class _BwdTile(NamedTuple):
    rows: int           # resident rows a block owns, 16 a pair of warps
    stream_rows: int    # rows of each streamed tile
    stages: int         # cp.async ring stages
    blocks_per_sm: int  # resident blocks an SM holds (smem, registers)


class _BwdTileW(NamedTuple):
    rows: int           # resident rows a block owns, 64 a warpgroup
    stream_rows: int    # rows of each streamed tile
    stages: int         # TMA ring stages of dk/dv and the recomputing dq
    ds_stages: int      # TMA ring stages of dq from the stored ds
    blocks_per_sm: int  # resident blocks an SM holds (smem)


# the instances of csrc/flash_fwd.cu and csrc/flash_bwd.cu (Large, Small)
# by head dim, in the order of the index their entry points take
_FWD_TILES = {D: (_FwdTile(128, 32, 2, 1, 1), _FwdTile(32, 32, 2, 2, 2))
              for D in (64, 128)}
_BWD_TILES = {128: (_BwdTile(64, 32, 2, 1), _BwdTile(32, 16, 2, 2)),
              64: (_BwdTile(64, 32, 2, 1), _BwdTile(32, 16, 2, 3))}
# the bf16 instances (LargeB, SmallB): the forward's warps each take 16
# rows and every key of a tile of 64 (no key splits), the backward's the
# f32 shapes
_FWD_TILES_BF16 = {D: (_FwdTile(128, 64, 2, 1, 1), _FwdTile(64, 64, 2, 2, 1))
                   for D in (64, 128)}
# the bf16 wgmma instances (LargeW, SmallW): 128 or 64 query rows, a
# consumer warpgroup each 64, and a producer warpgroup; key tiles of 64
# through four TMA stages; one block an SM
_FWD_TILES_WGMMA = {D: (_FwdTile(128, 64, 4, 1, 1),
                        _FwdTile(64, 64, 4, 1, 1)) for D in (64, 128)}
_BWD_TILES_BF16 = {D: (_BwdTile(64, 32, 2, 1), _BwdTile(32, 16, 2, 2))
                   for D in (64, 128)}
# the bf16 backward's wgmma instances (LargeBW, SmallBW): 128 or 64
# resident rows, a consumer warpgroup each 64, and a producer warpgroup;
# streamed tiles of 64 through three TMA stages, six for dq from the
# stored ds; one block an SM
_BWD_TILES_WGMMA = {D: (_BwdTileW(128, 64, 3, 6, 1),
                        _BwdTileW(64, 64, 3, 6, 1)) for D in (64, 128)}


def _fwd_tiles(dtype=torch.float32, route="mma_sync"):
    if dtype != torch.bfloat16:
        return _FWD_TILES
    return _FWD_TILES_WGMMA if route == "wgmma" else _FWD_TILES_BF16


def _bwd_tiles(dtype=torch.float32, route="mma_sync"):
    if dtype != torch.bfloat16:
        return _BWD_TILES
    return _BWD_TILES_WGMMA if route == "wgmma" else _BWD_TILES_BF16
_SMS = 132           # the H100's SMs: one wave of blocks
# largest [B*H, T, T] ds buffer the backward stores: the buffer lives for
# one flash_attention_bwd call, so it raises a step's peak memory by its
# size at most, and that rise is held to 1 GiB
_DS_BUDGET = 2 ** 30


def _pick_tile(tiles, B: int, H: int, T: int) -> int:
    """0 (the large instance) unless its blocks would fill less than one
    wave of the card (``_SMS`` SMs times the blocks an SM holds), else 1."""
    large = tiles[0]
    n_large = B * H * -(-T // large.rows)
    return 0 if n_large >= _SMS * large.blocks_per_sm else 1


class FlashFwdPlan(NamedTuple):
    """The launch of ``flash_fwd`` (``csrc/flash_fwd.cu``): ``tile`` is the
    instance index the entry point takes; a block owns ``rows`` query
    rows in groups of 16, each taken by ``key_splits`` warps (``warps``
    in all), and streams K and V in tiles of ``stream_rows`` through
    ``stages`` ``cp.async`` stages in ``smem`` bytes of shared memory, of
    which an SM holds ``blocks_per_sm``; each warp of a row group takes
    its ``stream_rows / key_splits`` rows of every tile, and the groups'
    states are merged at the end. ``grid`` blocks cover ``B * H`` heads
    times ``T`` in ``rows`` (``tiles`` a head). ``route`` is
    ``"mma_sync"``, or for bf16 operands on 16-byte boundaries
    ``"wgmma"``: then ``rows / 64`` consumer warpgroups and a producer
    warpgroup (``warps``), the stages filled by TMA."""
    tile: int
    rows: int
    warps: int
    key_splits: int
    stream_rows: int
    stages: int
    smem: int
    blocks_per_sm: int
    tiles: int
    grid: int
    route: str


def _fwd_smem(D: int, t: _FwdTile, dtype=torch.float32,
              route: str = "mma_sync") -> int:
    """``Cfg::SMEM_BYTES`` of the forward: Q's hi and lo planes, ``rows x
    (D + 4)`` each, and per stage K and V, ``stream_rows x (D + 4)`` each,
    and their ``stream_rows`` segment ids (the key splits' merge reuses
    the ring). bf16 (``CfgB``): no Q planes (each warp's Q fragments live
    in registers); per stage K and V as bf16 rows of pitch ``D + 8`` and
    the segment ids. bf16 on ``wgmma`` (``CfgW``): 1024 bytes to align
    to the swizzle's period, Q as ``rows x D`` bf16 values, per stage K
    and V as ``stream_rows x D`` each, and ``2 stages + 1`` mbarriers of
    8 bytes."""
    if dtype == torch.bfloat16 and route == "wgmma":
        return (1024 + 2 * t.rows * D + t.stages * 4 * t.stream_rows * D
                + 8 * (2 * t.stages + 1))
    if dtype == torch.bfloat16:
        return 4 * t.stages * (t.stream_rows * (D + 8) + t.stream_rows)
    ld = D + 4
    return 4 * (2 * t.rows * ld
                + t.stages * (2 * t.stream_rows * ld + t.stream_rows))


def flash_fwd_plan(B: int, H: int, T: int, D: int, causal: bool = False,
                   dtype=torch.float32,
                   width: Optional[int] = None) -> FlashFwdPlan:
    """The forward kernel's launch for ``[B, H, T, D]`` operands of
    ``dtype`` (float32 or bfloat16) copied ``width`` values at a time
    (:func:`flash_copy_width`; None: the widest, 16 bytes); pure Python,
    a function of the shapes, the dtype and the width alone, so one call
    always takes one instance and reruns are bit-equal. bf16 operands at
    width 8 take the ``wgmma`` route, at width 2 ``mma.sync``; f32 ones
    ``mma.sync`` (split TF32). The large instance (128 query rows a
    block) unless its blocks would fill less than one wave of the card,
    then the small one (f32: 32 rows, two warps each 16, splitting the
    keys; bf16 ``mma.sync``: 64 rows, a warp each 16, key tiles of 64;
    ``wgmma``: 64 rows, one consumer warpgroup). ``causal`` changes no
    instance: the kernel only orders its query tiles by it (the longest
    first)."""
    del causal
    bf16 = dtype == torch.bfloat16
    route = "wgmma" if bf16 and width in (None, 8) else "mma_sync"
    tiles = _fwd_tiles(dtype, route)[D]
    tile = _pick_tile(tiles, B, H, T)
    t = tiles[tile]
    n = -(-T // t.rows)
    warps = 4 * (t.rows // 64 + 1) if route == "wgmma" \
        else t.rows // 16 * t.key_splits
    return FlashFwdPlan(tile, t.rows, warps, t.key_splits, t.stream_rows,
                        t.stages, _fwd_smem(D, t, dtype, route),
                        t.blocks_per_sm, n, B * H * n, route)


class FlashBwdPlan(NamedTuple):
    """The launch of ``flash_bwd_dq`` and ``flash_bwd_dkv`` (one instance
    for both kernels, ``csrc/flash_bwd.cu``): ``tile`` is the instance
    index the entry points take; a block of ``warps`` warps, in pairs of
    16 rows, owns ``rows`` resident rows (query rows in dq, key rows in
    dk/dv) and streams the other side's rows in tiles of ``stream_rows``
    through ``stages`` ``cp.async`` stages in ``smem`` bytes of shared
    memory, of which an SM holds ``blocks_per_sm``; ``grid`` blocks cover
    ``B * H`` heads times ``T`` in ``rows``, so the grid covers ``T``
    exactly (``tiles`` a head). With ``stored_ds``, :func:`flash_attention_bwd`
    has ``flash_bwd_dkv`` store ``ds`` in a ``[B * H, T, T]`` buffer and
    ``flash_bwd_dq`` read it back (five products in place of seven);
    without it dq recomputes ``s`` and ``dp`` (seven). ``route`` is
    ``"mma_sync"``, or for bf16 operands on 16-byte boundaries
    ``"wgmma"``: then ``rows / 64`` consumer warpgroups and a producer
    warpgroup (``warps``), the stages filled by TMA, and dq from the
    stored ds on a ring of its own in ``ds_smem`` bytes (0 on the other
    route, whose dq shares ``smem``'s instance)."""
    tile: int
    rows: int
    warps: int
    stream_rows: int
    stages: int
    smem: int
    blocks_per_sm: int
    tiles: int
    grid: int
    stored_ds: bool
    route: str = "mma_sync"
    ds_smem: int = 0


def _bwd_smem(D: int, t, dtype=torch.float32, route: str = "mma_sync") -> int:
    """``Cfg::SMEM_BYTES``: four resident ``rows x (D + 4)`` planes (hi and
    lo of two operands), per stage two ``stream_rows x (D + 4)`` matrices
    and three ``stream_rows`` vectors (LSE, delta, segment ids), and the
    pairs' exchange, a ``16 x stream_rows`` score tile a warp. bf16
    (``CfgB``): no resident planes (each warp's fragments of its resident
    operand live in registers), the two matrices as bf16 rows of pitch
    ``D + 8``. bf16 on ``wgmma`` (``CfgBW``, dk/dv and the recomputing
    dq): 1024 bytes to align to the swizzle's period, two resident ``rows
    x D`` bf16 matrices, per stage two ``stream_rows x D`` ones and 1024
    bytes of row vectors, for the one-warpgroup instance at D 128 dk/dv's
    stash of P (32 floats a consumer thread, two threads a resident row),
    and ``2 stages + 1`` mbarriers of 8 bytes."""
    if dtype == torch.bfloat16 and route == "wgmma":
        return (1024 + 2 * 2 * t.rows * D
                + t.stages * (2 * 2 * t.stream_rows * D + 1024)
                + (256 * t.rows if D == 128 and t.rows == 64 else 0)
                + 8 * (2 * t.stages + 1))
    xchg = t.rows // 8 * 16 * t.stream_rows
    if dtype == torch.bfloat16:
        return 4 * (t.stages * (t.stream_rows * (D + 8) + 3 * t.stream_rows)
                    + xchg)
    ld = D + 4
    return 4 * (4 * t.rows * ld
                + t.stages * (2 * t.stream_rows * ld + 3 * t.stream_rows)
                + xchg)


def _bwd_ds_smem(D: int, t: _BwdTileW) -> int:
    """``CfgBW::DS_SMEM_BYTES``, dq from the stored ds on ``wgmma``: 1024
    bytes to align, per stage the block's ``rows x stream_rows`` bf16 tile
    of ds, a ``stream_rows x D`` bf16 K tile and 1024 bytes of row
    vectors, then the block's ``rows`` segment ids and ``2 ds_stages``
    mbarriers."""
    return (1024 + t.ds_stages * (2 * t.rows * t.stream_rows
                                  + 2 * t.stream_rows * D + 1024)
            + 4 * t.rows + 16 * t.ds_stages)


# what one stored ds entry takes, and the T it needs (16-byte rows)
_DS_ITEM = {torch.float32: (4, 4), torch.bfloat16: (2, 8)}


def flash_bwd_plan(B: int, H: int, T: int, D: int, causal: bool = False,
                   dtype=torch.float32,
                   width: Optional[int] = None) -> FlashBwdPlan:
    """The backward kernels' launch for ``[B, H, T, D]`` operands of
    ``dtype`` (float32 or bfloat16) copied ``width`` values at a time
    (:func:`flash_copy_width`; None: the widest, 16 bytes); pure Python, a
    function of the shapes, the dtype and the width alone, so one call
    always takes one instance and reruns are bit-equal. bf16 operands at
    width 8 take the ``wgmma`` route, at width 2 ``mma.sync``; f32 ones
    ``mma.sync`` (split TF32). The large instance unless its blocks would
    fill less than one wave of the card (``_SMS`` SMs times the blocks an
    SM holds), then the small one; ``ds`` stored, in the operands' dtype,
    where its rows are whole 16-byte pieces (``T`` a multiple of 4 for
    f32, of 8 for bf16) and the buffer takes at most ``_DS_BUDGET`` (1
    GiB: at ``T = 2048`` and 4 heads, batches up to 16 in f32, 32 in
    bf16). ``causal`` changes no instance: the kernels only order their
    tiles by it (the longest first)."""
    del causal
    bf16 = dtype == torch.bfloat16
    route = "wgmma" if bf16 and width in (None, 8) else "mma_sync"
    tiles = _bwd_tiles(dtype, route)[D]
    tile = _pick_tile(tiles, B, H, T)
    t = tiles[tile]
    n = -(-T // t.rows)
    item, mult = _DS_ITEM[dtype]
    wgmma = route == "wgmma"
    return FlashBwdPlan(tile, t.rows,
                        4 * (t.rows // 64 + 1) if wgmma else t.rows // 8,
                        t.stream_rows, t.stages,
                        _bwd_smem(D, t, dtype, route), t.blocks_per_sm, n,
                        B * H * n,
                        T % mult == 0 and item * B * H * T * T <= _DS_BUDGET,
                        route, _bwd_ds_smem(D, t) if wgmma else 0)


def _launch_bwd(name: str, q, k, v, seg_ptr, do, lse, delta, outs,
                causal: bool, scale: Optional[float], ds=None) -> None:
    """Launch ``name`` on the plan's instance, route and copy width; ``ds``
    the stored-ds buffer (:attr:`FlashBwdPlan.stored_ds`) or ``None``."""
    B, H, T, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    width = flash_copy_width(q, k, v, do, *outs)
    plan = flash_bwd_plan(B, H, T, D, causal, q.dtype, width)
    kernel = _kernel_name(name, q.dtype)
    with torch.cuda.device(q.device):          # launch on q's card
        _launch(kernel, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), seg_ptr, do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in outs),
                None if ds is None else ds.data_ptr(), B, H, T, D, scale,
                int(causal), plan.tile, width, stream_ptr(q))
    if q.dtype == torch.bfloat16:
        _routes[kernel][plan.route] += 1


def _check_ds(name: str, q, ds) -> None:
    """A stored-ds buffer: ``[B * H, T, T]`` in q's dtype (f32 or bf16),
    contiguous on ``q``'s card, 16-byte aligned, its rows whole 16-byte
    pieces (``T`` a multiple of 4 for f32, of 8 for bf16: the kernels copy
    its rows 16 bytes at a time)."""
    B, H, T, _ = q.shape
    mult = _DS_ITEM[q.dtype][1]
    if tuple(ds.shape) != (B * H, T, T):
        raise ValueError(f"{name}: ds {tuple(ds.shape)} != {(B * H, T, T)}")
    if T % mult or ds.data_ptr() % 16:
        raise ValueError(f"{name}: a stored ds needs T % {mult} == 0 (T = "
                         f"{T}) and a 16-byte aligned buffer")
    check_dtype(name, q.dtype, ds=ds)
    check_cuda(name, q.device, ds=ds)


def flash_bwd_dq(q, k, v, segments, do, lse, delta, causal: bool = False,
                 scale: Optional[float] = None, ds=None) -> torch.Tensor:
    """dq of the flash forward (the ``flash_bwd_dq`` kernel), given the
    forward's ``LSE`` and ``delta = rowsum(dO * O)``. With ``ds``, the
    ``[B * H, T, T]`` buffer that :func:`flash_bwd_dkv` filled on the same
    operands, the kernel reads ds back and runs only ``ds . k``; without
    it, it recomputes ``s`` and ``dp``. bf16 operands launch
    ``flash_bwd_dq_bf16`` (dq in bf16; ``ds`` bf16): by ``wgmma`` fed by
    TMA where q, k, v and dO start on 16-byte boundaries, else by
    ``mma.sync`` on 4-byte copies (:func:`route_counts`). CPU tensors run the
    plain version, which needs no buffer and leaves ``ds`` as it is."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, segments, do, lse, delta, causal,
                                  scale)
    seg_ptr = _check_flash("flash_bwd_dq", q, k, v, segments, {"do": do},
                           {"lse": lse, "delta": delta})
    if ds is not None:
        _check_ds("flash_bwd_dq", q, ds)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", q, k, v, seg_ptr, do, lse, delta, (dq,),
                causal, scale, ds)
    return dq


def flash_bwd_dkv(q, k, v, segments, do, lse, delta, causal: bool = False,
                  scale: Optional[float] = None, ds=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of the flash forward (the ``flash_bwd_dkv`` kernel),
    given the forward's ``LSE`` and ``delta = rowsum(dO * O)``. With
    ``ds``, a ``[B * H, T, T]`` buffer in the operands' dtype, the kernel
    also stores there ``ds[q][k]`` of every tile it visits (bf16: rounded
    as dq's product rounds it), for :func:`flash_bwd_dq`; the entries of
    skipped tiles stay as they were. bf16 operands launch
    ``flash_bwd_dkv_bf16`` (dk and dv in bf16), on the routes of
    :func:`flash_bwd_dq`. CPU tensors run the plain
    version and leave ``ds`` as it is."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, segments, do, lse, delta,
                                   causal, scale)
    seg_ptr = _check_flash("flash_bwd_dkv", q, k, v, segments, {"do": do},
                           {"lse": lse, "delta": delta})
    if ds is not None:
        _check_ds("flash_bwd_dkv", q, ds)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, seg_ptr, do, lse, delta, (dk, dv),
                causal, scale, ds)
    return dk, dv


def flash_attention_bwd(q, k, v, segments, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` from its saved
    ``O`` and ``LSE`` and the upstream gradient ``dO``. CPU tensors run
    :func:`flash_attention_bwd_plain`; CUDA tensors compute ``delta``
    (bf16: :func:`flash_bwd_delta`'s kernel; f32: one PyTorch reduction)
    and call :func:`flash_bwd_dkv` and :func:`flash_bwd_dq`: where the
    plan stores ``ds``, dk/dv writes it to a buffer of this call's and dq
    reads it back instead of recomputing it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, segments, o, lse, do,
                                         causal, scale)
    _check_flash("flash_attention_bwd", q, k, v, segments,
                 {"o": o, "do": do}, {"lse": lse})
    delta = flash_bwd_delta(o, do) if q.dtype == torch.bfloat16 \
        else _delta(o, do)
    B, H, T, D = q.shape
    ds = torch.empty((B * H, T, T), dtype=q.dtype, device=q.device) \
        if flash_bwd_plan(B, H, T, D, causal, q.dtype).stored_ds else None
    dk, dv = flash_bwd_dkv(q, k, v, segments, do, lse, delta, causal, scale,
                           ds)
    dq = flash_bwd_dq(q, k, v, segments, do, lse, delta, causal, scale, ds)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 segments: Optional[torch.Tensor], causal: bool,
                 scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as a dispatcher op, so that
    ``torch.utils.checkpoint``'s selective policies see it (the
    transformer's ``remat="dots"`` keeps its outputs)."""
    return flash_attention_fwd(q, k, v, segments, causal, scale)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd: the forward (:func:`flash_fwd_op`)
    saves ``q, k, v, segments, O, LSE`` (as the JAX ``custom_vjp``'s
    ``_fwd`` does) and the backward is :func:`flash_attention_bwd`.
    ``segments``, ``causal`` and ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segments, causal, scale):
        o, lse = flash_fwd_op(q, k, v, segments, causal, scale)
        ctx.save_for_backward(q, k, v, segments, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segments, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, segments, o, lse,
                                         do.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, segments=None, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``O`` of :func:`flash_attention_fwd`, differentiable: with grad mode
    on and an input that requires grad it goes through
    :class:`FlashAttentionFunction`; otherwise it launches the forward
    alone and saves nothing (serving prefill)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, segments, causal, scale)
    return flash_attention_fwd(q, k, v, segments, causal, scale)[0]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # pointers (for the backward, ds last), then B H T D, then scale,
    # causal, tile, vec, stream
    "flash_fwd": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_bwd_dq": [_P] * 9 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_bwd_dkv": [_P] * 10 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_fwd_bf16": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_bwd_dq_bf16": [_P] * 9 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_bwd_dkv_bf16": [_P] * 10 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # o, dout, delta; rows, D; stream
    "flash_bwd_delta_bf16": [_P] * 3 + [_I] * 2 + [_P],
    # q, pools (and scales), tables, lengths or start and n, out,
    # workspace; then S (Q) H D N bs MB part, scale, stream
    "paged_decode": [_P] * 7 + [_I] * 7 + [_F, _P],
    "paged_decode_int8": [_P] * 9 + [_I] * 7 + [_F, _P],
    "paged_decode_bf16": [_P] * 7 + [_I] * 7 + [_F, _P],
    "paged_span": [_P] * 8 + [_I] * 8 + [_F, _P],
    "paged_span_int8": [_P] * 10 + [_I] * 8 + [_F, _P],
    "paged_span_bf16": [_P] * 8 + [_I] * 8 + [_F, _P],
}


# ---------------------------------------------------------------------------
# paged decode and paged span
# ---------------------------------------------------------------------------

SPAN_MAX_Q = 256     # query rows per slot the span kernel takes
_SPAN_ROWS = 16      # query rows a block at Q > 1 (csrc/paged_span.cu)
_PART_POSITIONS = 128  # least positions a partition holds
_MAX_SMEM = 232448   # dynamic shared memory a block may opt into (227 KB)
_MAX_BLOCKS = 128    # pool blocks a partition may span (one per thread)
# the pool kinds of the paged kernels (csrc/paged_attention.cuh: Pool); a
# bool ``quant`` reads as f32 (False) or int8 (True)
POOL_F32, POOL_INT8, POOL_BF16 = 0, 1, 2
_RAW_BYTES = {POOL_F32: 0, POOL_INT8: 1, POOL_BF16: 2}
_POOL_SUFFIX = {POOL_F32: "", POOL_INT8: "_int8", POOL_BF16: "_bf16"}
# kernels one bf16-pool paged call launches (the wrappers count the call
# as one launch): the max pass, pv_kernel and the merge
PAGED_BF16_KERNELS = 3


class PagedPlan(NamedTuple):
    """The launch plan of the paged kernels (``csrc/paged_attention.cuh``)
    for a table of ``MB`` blocks of ``bs`` positions, head dim ``D`` and
    ``Q`` query rows a slot.

    A partition holds ``part`` positions, a whole number of pool blocks
    that depends on ``bs`` alone, so every row's split depends on its
    position only; ``parts`` partitions cover the table's ``MB * bs``
    positions; ``rows`` query rows share a block, ``tiles`` blocks cover
    a slot's ``Q`` rows; ``smem`` is the partials kernel's dynamic shared
    memory in bytes (bf16 pools: the max pass's). Over bf16 pools the
    main pass is ``pv_kernel``, with ``pv_smem`` bytes, and the max pass
    stores each row's scores, ``scores`` floats a (row, head, partition)
    (``part`` rounded up to 4); 0 for other pools, which launch neither."""
    part: int
    parts: int
    rows: int
    tiles: int
    smem: int
    q_rows: int
    record: int
    pv_smem: int = 0
    scores: int = 0

    def workspace_shape(self, S: int, H: int) -> Tuple[int, ...]:
        """The partials workspace: per (slot, row, head, partition) one
        record of ``acc[D]``, ``m``, ``l`` and two pad floats."""
        return (S, self.q_rows, H, self.parts, self.record)

    def scores_shape(self, S: int, H: int) -> Tuple[int, ...]:
        """The bf16 pools' stored scores, past the records: ``(S, Q, H,
        parts, scores)`` f32, ``4 * S * Q * H * parts * scores`` bytes
        (256 KB at S 8, Q 1, H 8 over 1024 positions; 4 MB at S 1, Q 128;
        64 MB at S 8, Q 256); none for other pools (``scores`` 0)."""
        return (S, self.q_rows, H, self.parts, self.scores)

    def workspace_numel(self, S: int, H: int) -> int:
        """f32 elements of one call's workspace: the records, then the
        stored scores."""
        return (math.prod(self.workspace_shape(S, H))
                + math.prod(self.scores_shape(S, H)))


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def paged_smem_bytes(D: int, rows: int, part: int, pool: int) -> int:
    """``paged::Layout``'s total for pool kind ``pool`` (:data:`POOL_F32`,
    :data:`POOL_INT8` or :data:`POOL_BF16`): padded K and V of a
    partition, the query tile, the scores, the row state and the
    partition's pool blocks and, for int8 and bf16 pools, the raw K and V
    rows (and int8's scales)."""
    b = 4 * part * (D + 4) + 4 * part * D + 4 * rows * D + 4 * rows * part
    b = _align16(_align16(b) + 8 * rows + 4 * _MAX_BLOCKS)
    b += 2 * _RAW_BYTES[int(pool)] * part * D
    if pool == POOL_INT8:
        b = _align16(b + 4 * part) + 4 * part
    return _align16(b)


def paged_pv_smem_bytes(D: int, rows: int, part: int) -> int:
    """``paged::PvLayout``'s total, the bf16 pools' main pass: the stored
    scores of ``rows`` rows (then p), the row state and the partition's
    pool blocks, and its raw bf16 V rows; no K, raw K, query tile or f32
    V."""
    b = _align16(4 * rows * _score_pitch(part))
    b = _align16(b + 8 * rows + 4 * _MAX_BLOCKS)
    return _align16(b + 2 * part * D)


def _score_pitch(part: int) -> int:
    return -(-part // 4) * 4


def paged_plan(MB: int, bs: int, D: int, Q: int,
               pool: int = POOL_F32) -> PagedPlan:
    """The split of the paged kernels for one launch over a pool of kind
    ``pool``; pure Python."""
    part = bs * -(-_PART_POSITIONS // bs)
    parts = -(-(MB * bs) // part)
    rows = 1 if Q == 1 else _SPAN_ROWS
    bf16 = pool == POOL_BF16
    return PagedPlan(part, parts, rows, -(-Q // rows),
                     paged_smem_bytes(D, rows, part, pool), Q, D + 4,
                     paged_pv_smem_bytes(D, rows, part) if bf16 else 0,
                     _score_pitch(part) if bf16 else 0)


def _unpack_pages(pages):
    """``(values, scales)`` of a quantized ``(int8 [N, bs, H, D], f32
    scales [N, bs, H])`` pool, ``(values, None)`` of a plain one."""
    if isinstance(pages, tuple):
        return pages[0], pages[1]
    return pages, None


def _check_pool_pair(name: str, pages_k, pages_v) -> None:
    if isinstance(pages_k, tuple) != isinstance(pages_v, tuple):
        raise ValueError(f"{name}: the K and V pools must both be plain or "
                         f"both (int8 values, scales)")


def _gathered(pages, tables) -> torch.Tensor:
    """One layer's pool in position order, ``[S, MB*bs, H, D]`` f32,
    through the serving pool's own (dequantizing) gather, so the plain
    versions and the ``"xla"`` path read int8 pools the same way."""
    from ..serve.kv_cache import gather_pages
    return gather_pages(pages, tables).float()


def _masked_softmax_pv(s, v, vis, eq: str, v_dtype) -> torch.Tensor:
    """``softmax(s) . v`` over the last axis of the scores ``s`` with the
    kernels' conventions: pairs outside ``vis`` at ``-inf``, the row max
    floored at ``-1e30`` and the sum clamped at ``1e-30``, so a row with
    nothing visible gives zeros. p enters the product rounded to
    ``v_dtype``, V's dtype as JAX's paged kernels see it
    (:func:`_v_dtype`)."""
    s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum(eq, _rounded(p, v_dtype), v) / l


def _v_dtype(pages_v):
    """The dtype of V in the paged kernels' ``p . V``: a plain pool's, or
    f32 for an int8 pool, which JAX dequantizes to f32 first."""
    values, scales = _unpack_pages(pages_v)
    return values.dtype if scales is None else torch.float32


def paged_decode_plain(q, pages_k, pages_v, tables, lengths,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``[S, H, D]``: each slot's query against its table's pages in
    position order (dequantized for an int8 pool), positions ``>=
    lengths`` masked, length 0 giving zeros."""
    S, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    k = _gathered(pages_k, tables)
    v = _gathered(pages_v, tables)
    s = torch.einsum("shd,swhd->shw", q.float(), k) * scale
    live = torch.arange(k.shape[1], device=q.device)[None] < lengths[:, None]
    return _masked_softmax_pv(s, v, live[:, None, :], "shw,swhd->shd",
                              _v_dtype(pages_v)).to(q.dtype)


def paged_span_plain(q, pages_k, pages_v, tables, start, n,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``[S, Q, H, D]``: row ``j`` of slot ``s`` (position ``start[s] +
    j``) against the slot's pages in position order (dequantized for an
    int8 pool), seeing positions ``<= start[s] + j``; ``n == 0`` gives
    zeros on every row, rows ``>= n`` are padding (compare live rows
    only) — the oracle ``paged_span_reference_attention`` with the
    kernel's conventions."""
    S, Q, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    k = _gathered(pages_k, tables)
    v = _gathered(pages_v, tables)
    s = torch.einsum("sqhd,swhd->sqhw", q.float(), k) * scale
    pos = start.long()[:, None] + torch.arange(Q, device=q.device)[None]
    vis = torch.arange(k.shape[1], device=q.device)[None, None] \
        <= pos[..., None]                                 # [S, Q, W]
    vis = vis & (n > 0)[:, None, None]
    return _masked_softmax_pv(s, v, vis[:, :, None, :], "sqhw,swhd->sqhd",
                              _v_dtype(pages_v)).to(q.dtype)


def paged_rounding_slack(q, pages_k, pages_v, tables, start, n,
                         scale: Optional[float] = None) -> torch.Tensor:
    """``[S, Q, H, D]``: how far a correct kernel may lie from
    :func:`paged_span_plain` beyond summation order, for the span ``q [S,
    Q, H, D]`` (decode: ``q[:, None]``, ``start = lengths - 1``, ``n =
    (lengths > 0)``). Zero unless the pools are bf16. Over a bf16 pool p
    is rounded to bf16 before ``p . V``, and a kernel's f32 p differs from
    the plain version's by the rounding of the scores (other summation
    orders) and of ``exp``; where a p lies that close to a midpoint of two
    bf16 values, the two may round it one bf16 ulp apart. The slack is the
    sum of ``ulp(p) * |v| / l`` over the keys whose p lies within ``(4
    sqrt(D) 2^-24 (a + a_max) + 2^-23 |s - m| + 2^-21) p`` of a midpoint,
    with ``a = scale * sum_d |q_d k_d|`` the dot's magnitude and ``a_max``
    the row's largest: four times the typical f32 error of two D-term
    chains, plus the subtraction and two ``exp`` ulps. In a CPU model of
    the kernel's chains against ``einsum`` (D 64 and 128, 327,680 keys)
    every p that rounded differently lay within half that window. A kernel
    that did not round p at all lies ~2^-9 of each p off, everywhere:
    hold the mean error too (``chip_smoke.py``)."""
    S, Q, H, D = q.shape
    values, _ = _unpack_pages(pages_v)
    if values.dtype != torch.bfloat16:
        return torch.zeros_like(q, dtype=torch.float32)
    scale = D ** -0.5 if scale is None else scale
    k = _gathered(pages_k, tables)
    v = _gathered(pages_v, tables)
    s = torch.einsum("sqhd,swhd->sqhw", q.float(), k) * scale
    a = torch.einsum("sqhd,swhd->sqhw", q.float().abs(), k.abs()) * abs(scale)
    pos = start.long()[:, None] + torch.arange(Q, device=q.device)[None]
    vis = (torch.arange(k.shape[1], device=q.device)[None, None]
           <= pos[..., None]) & (n > 0)[:, None, None]
    vis = vis[:, :, None, :]
    s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    a = a.masked_fill(~vis, 0.0)
    eta = 4 * D ** 0.5 * 2.0 ** -24 * (a + a.amax(-1, keepdim=True)) \
        + 2.0 ** -23 * (s - m).abs().nan_to_num(0.0) + 2.0 ** -21
    ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p)[1] - 8)
    frac = p / ulp - torch.floor(p / ulp)
    near = ((frac - 0.5).abs() * ulp <= eta * p) & vis
    return torch.einsum("sqhw,swhd->sqhd", torch.where(near, ulp, 0.0),
                        v.abs()) / l


def _pool_kind(name: str, kv, vv, quant: bool) -> int:
    """The pool kind of a K/V pair: int8 tuples, both bf16, or both f32;
    a mixed pair or another dtype is refused."""
    if quant:
        check_dtype(name, torch.int8, pages_k=kv, pages_v=vv)
        return POOL_INT8
    if kv.dtype != vv.dtype:
        raise ValueError(f"{name}: mixed pools, K {kv.dtype} and V "
                         f"{vv.dtype}; the kernels take both f32 or both "
                         f"bf16")
    if kv.dtype == torch.bfloat16:
        return POOL_BF16
    check_dtype(name, torch.float32, pages_k=kv, pages_v=vv)
    return POOL_F32


def _check_paged(name: str, q, pages_k, pages_v, tables, Q: int,
                 **per_slot) -> Tuple[int, list, int, int, PagedPlan]:
    """Validate the paged kernels' operands for a launch on ``q``'s card:
    ``q [S, (Q,) H, D]`` f32 with ``D`` in {64, 128}; both pools f32 or
    both bf16 ``[N, bs, H, D]``, or both ``(int8 [N, bs, H, D], f32 scales
    [N, bs, H])``; ``tables [S, MB]`` and each ``per_slot`` vector ``[S]``
    int32; all contiguous on one device, the pools and ``q`` 16-byte
    aligned; the plan's shared memory within what a block may use. Reads
    no tensor's values. Returns ``(pool kind, pool pointers, N, bs,
    plan)``."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    kv, ks = _unpack_pages(pages_k)
    vv, vs = _unpack_pages(pages_v)
    quant = ks is not None
    S, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if kv.dim() != 4 or (H, D) != tuple(kv.shape[2:]) \
            or vv.shape != kv.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs pools "
                         f"{tuple(kv.shape)}, {tuple(vv.shape)}")
    N, bs = kv.shape[:2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_HEAD_DIMS}")
    if tables.dim() != 2 or tables.shape[0] != S or any(
            tuple(t.shape) != (S,) for t in per_slot.values()):
        raise ValueError(f"{name}: tables {tuple(tables.shape)} / "
                         + ", ".join(f"{k} {tuple(t.shape)}"
                                     for k, t in per_slot.items())
                         + f" do not match S={S}")
    check_dtype(name, torch.float32, q=q)
    kind = _pool_kind(name, kv, vv, quant)
    plan = paged_plan(tables.shape[1], bs, D, Q, kind)
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"{name}: block size {bs} too large for head dim "
                         f"{D}: {plan.smem} bytes of shared memory")
    if H > 65535 or plan.parts > 65535 or S * Q * H >= 2 ** 31:
        raise ValueError(f"{name}: H and the partition count must be <= "
                         f"65535 and S*Q*H below 2**31")
    pools = {"pages_k": kv, "pages_v": vv}
    if quant:
        pools.update(scales_k=ks, scales_v=vs)
        for key in ("scales_k", "scales_v"):
            if tuple(pools[key].shape) != (N, bs, H):
                raise ValueError(f"{name}: {key} {tuple(pools[key].shape)} "
                                 f"must be {(N, bs, H)}")
        check_dtype(name, torch.float32, scales_k=ks, scales_v=vs)
    check_dtype(name, torch.int32, tables=tables, **per_slot)
    check_cuda(name, q.device, q=q, tables=tables, **pools, **per_slot)
    # 16-byte loads and cp.async copies, 4-byte copies of the scales
    for key, t in {"q": q, **pools}.items():
        align = 4 if key.startswith("scales") else 16
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {key} is not {align}-byte aligned")
    return kind, [t.data_ptr() for t in pools.values()], N, bs, plan


def paged_decode_attention(q, pages_k, pages_v, tables, lengths,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode-shaped (q_len = 1) attention over one layer's paged KV pool,
    f32, bf16 or the quantized ``(int8 values, scales)`` tuple (widened or
    dequantized in the kernel). ``q [S, H, D]``; ``lengths`` counts the
    valid tokens including the one just scattered; 0 marks an inactive
    slot (zero output). CUDA tensors launch ``paged_decode``
    (``paged_decode_bf16`` for bf16 pools, ``paged_decode_int8`` for int8
    ones): partials over fixed partitions of the context and their merge
    (a bf16 pool's max pass before them), counted as one launch; the
    wrapper reads no per-slot value on the host."""
    _check_pool_pair("paged_decode_attention", pages_k, pages_v)
    if q.device.type == "cpu":
        return paged_decode_plain(q, pages_k, pages_v, tables, lengths,
                                  scale)
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} must "
                         f"be [S, H, D]")
    kind, pools, N, bs, plan = _check_paged(
        "paged_decode_attention", q, pages_k, pages_v, tables, 1,
        lengths=lengths)
    S, H, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    ws = torch.empty(plan.workspace_numel(S, H), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):          # launch on q's card
        _launch("paged_decode" + _POOL_SUFFIX[kind],
                q.data_ptr(), *pools, tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), ws.data_ptr(), S, H, D, N, bs,
                tables.shape[1], plan.part, scale, stream_ptr(q))
    return out


def paged_span_attention(q, pages_k, pages_v, tables, start, n,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Multi-query (q_len = Q) attention over one layer's paged KV pool,
    causal within the span: row ``j`` of slot ``s`` sits at position
    ``start[s] + j`` and sees positions ``<= start[s] + j``. ``q [S, Q,
    H, D]``; ``start``/``n`` ``[S]`` int32 — rows ``>= n[s]`` are padding
    (the kernel writes zeros there, the plain version attends them; the
    caller ignores them), ``n == 0`` marks an inactive slot (zeros). Pools
    f32, bf16 or ``(int8 values, scales)``. CUDA tensors launch
    ``paged_span`` (``paged_span_bf16``, ``paged_span_int8``: partials and
    merge, and a bf16 pool's max pass, counted as one), whose row ``j`` is
    bit-equal to :func:`paged_decode_attention` at length ``start + j +
    1``; ``Q`` is at most :data:`SPAN_MAX_Q`."""
    _check_pool_pair("paged_span_attention", pages_k, pages_v)
    if q.device.type == "cpu":
        return paged_span_plain(q, pages_k, pages_v, tables, start, n, scale)
    if q.dim() != 4:
        raise ValueError(f"paged_span_attention: q {tuple(q.shape)} must be "
                         f"[S, Q, H, D]")
    S, Q, H, D = q.shape
    if not 1 <= Q <= SPAN_MAX_Q:
        raise ValueError(f"paged_span_attention: a span of {Q} query rows; "
                         f"the kernel takes 1 to {SPAN_MAX_Q}")
    kind, pools, N, bs, plan = _check_paged(
        "paged_span_attention", q, pages_k, pages_v, tables, Q,
        start=start, n=n)
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    ws = torch.empty(plan.workspace_numel(S, H), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        _launch("paged_span" + _POOL_SUFFIX[kind], q.data_ptr(),
                *pools, tables.data_ptr(), start.data_ptr(), n.data_ptr(),
                out.data_ptr(), ws.data_ptr(), S, Q, H, D, N, bs,
                tables.shape[1], plan.part, scale, stream_ptr(q))
    return out
