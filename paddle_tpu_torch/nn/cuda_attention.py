"""Attention kernels of the port — the port of
``paddle_tpu/nn/pallas_attention.py``'s flash forward and backward and its
paged decode.

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

Layouts are the JAX package's: ``[B, H, T, D]`` for flash, LSE and delta
``[B, H, T]``; ``q [S, H, D]``, one layer's pools ``[N, bs, H, D]``,
``tables [S, MB]``, ``lengths [S]`` for paged decode. The kernels take
float32 (the path's projections accumulate in f32) and ``D`` in {64, 128}.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..utils import cuda_build

__all__ = ["FlashAttentionFunction", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "flash_bwd_dq", "flash_bwd_dq_plain",
           "paged_decode_attention", "paged_decode_plain", "launch_counts",
           "reset_launch_counts", "KERNELS"]

_NEG = -1e30
_HEAD_DIMS = (64, 128)

# kernel name -> csrc source stem
KERNELS = {"flash_fwd": "flash_fwd", "paged_decode": "paged_decode",
           "flash_bwd_dq": "flash_bwd", "flash_bwd_dkv": "flash_bwd"}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_dtype(name: str, dtype: torch.dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, the "
                             f"kernel takes {dtype}")


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


def _probs(q, k, segments, lse, causal, scale) -> torch.Tensor:
    """``p = exp(q.k^T * scale - LSE)`` with masked pairs at 0, f32."""
    return torch.exp(_scores(q, k, segments, causal, scale) - lse[..., None])


def flash_attention_plain(q, k, v, segments=None, causal: bool = False,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O [B, H, T, D], LSE [B, H, T] f32)`` with the kernel's
    conventions: masked scores are ``-inf``, the row max is floored at
    ``-1e30`` and the row sum clamped at ``1e-30``, so a row with no
    visible key (segment id 0) gives zeros and an LSE of about ``-1e30``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, segments, causal, scale)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_dq_plain(q, k, v, segments, do, lse, delta,
                       causal: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``dq = scale * (p * (dO.v^T - delta)) . k`` — the ``flash_bwd_dq``
    kernel's function, from whole tensors."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _probs(q, k, segments, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
            ).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, segments, do, lse, delta,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` with ``dk = scale * ds^T . q`` and ``dv = p^T . dO`` —
    the ``flash_bwd_dkv`` kernel's function, from whole tensors."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = _probs(q, k, segments, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32, ``[B, H, T]``."""
    return (do.float() * o.float()).sum(-1)


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


def _check_flash(name: str, q, k, v, segments, same=None, rows=None):
    """Validate the flash kernels' operands for a launch on ``q``'s card:
    ``k``, ``v`` and ``same`` shaped like ``q``, ``rows`` ``[B, H, T]``,
    all f32 and contiguous on one device, ``segments`` ``[B, T]`` int32.
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
    _check_dtype(name, torch.float32, q=q, **same, **rows)
    _check_cuda(name, q.device, q=q, **same, **rows)
    if segments is None:
        return None
    if tuple(segments.shape) != (B, T):
        raise ValueError(f"{name}: segments {tuple(segments.shape)} != "
                         f"{(B, T)}")
    _check_dtype(name, torch.int32, segments=segments)
    _check_cuda(name, q.device, segments=segments)
    return segments.data_ptr()


def _launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point with ``args``; raise if the
    launch was refused, else count it."""
    fn = _kernel_fn(name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _launches[name] += 1


def flash_attention_fwd(q, k, v, segments=None, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention forward over ``[B, H, T, D]`` returning ``(O,
    LSE)``; ``segments`` ``[B, T]`` int32 packed-sequence ids (1-based,
    0 = padding) confine attention within each sub-sequence, shared
    across heads. Any ``T`` is taken; tiles past ``T`` are masked."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segments, causal, scale)
    seg_ptr = _check_flash("flash_attention", q, k, v, segments)
    B, H, T, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):          # launch on q's card
        _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg_ptr, out.data_ptr(), lse.data_ptr(), B, H, T, D, scale,
                int(causal), _stream_ptr(q))
    return out, lse


def flash_bwd_dq(q, k, v, segments, do, lse, delta, causal: bool = False,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dq of the flash forward (the ``flash_bwd_dq`` kernel), given the
    forward's ``LSE`` and ``delta = rowsum(dO * O)``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, segments, do, lse, delta, causal,
                                  scale)
    seg_ptr = _check_flash("flash_bwd_dq", q, k, v, segments, {"do": do},
                           {"lse": lse, "delta": delta})
    B, H, T, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg_ptr, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), B, H, T, D, scale, int(causal),
                _stream_ptr(q))
    return dq


def flash_bwd_dkv(q, k, v, segments, do, lse, delta, causal: bool = False,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of the flash forward (the ``flash_bwd_dkv`` kernel),
    given the forward's ``LSE`` and ``delta = rowsum(dO * O)``."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, segments, do, lse, delta,
                                   causal, scale)
    seg_ptr = _check_flash("flash_bwd_dkv", q, k, v, segments, {"do": do},
                           {"lse": lse, "delta": delta})
    B, H, T, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg_ptr, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, T, D, scale,
                int(causal), _stream_ptr(q))
    return dk, dv


def flash_attention_bwd(q, k, v, segments, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` from its saved
    ``O`` and ``LSE`` and the upstream gradient ``dO``. CPU tensors run
    :func:`flash_attention_bwd_plain`; CUDA tensors compute ``delta`` with
    one PyTorch reduction and launch ``flash_bwd_dq`` and
    ``flash_bwd_dkv``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, segments, o, lse, do,
                                         causal, scale)
    _check_flash("flash_attention_bwd", q, k, v, segments, {"o": o,
                                                            "do": do},
                 {"lse": lse})
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, segments, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, segments, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd: the forward saves ``q, k, v,
    segments, O, LSE`` (as the JAX ``custom_vjp``'s ``_fwd`` does) and the
    backward is :func:`flash_attention_bwd`. ``segments``, ``causal`` and
    ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segments, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, segments, causal, scale)
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


_ARGTYPES = {
    # pointers, then B H T D / S H D N bs MB, then scale, causal, stream
    "flash_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_bwd_dq": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_bwd_dkv": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "paged_decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
}


def _kernel_fn(name: str):
    """Kernel ``name``'s C entry point ``<name>_f32``, typed."""
    fn = getattr(cuda_build.load(KERNELS[name]), f"{name}_f32")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def paged_decode_plain(q, pages_k, pages_v, tables, lengths,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``[S, H, D]``: each slot's query against its table's pages in
    position order, positions ``>= lengths`` masked, length 0 giving
    zeros — the kernel's conventions (row max floored at ``-1e30``, sum
    clamped at ``1e-30``)."""
    S, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    MB = tables.shape[1]
    bs = pages_k.shape[1]
    idx = tables.long()
    k = pages_k[idx].reshape(S, MB * bs, H, D).float()
    v = pages_v[idx].reshape(S, MB * bs, H, D).float()
    s = torch.einsum("shd,swhd->shw", q.float(), k) * scale
    live = torch.arange(MB * bs, device=q.device)[None] < lengths[:, None]
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("shw,swhd->shd", p, v) / l).to(q.dtype)


def paged_decode_attention(q, pages_k, pages_v, tables, lengths,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode-shaped (q_len = 1) attention over one layer's paged KV
    pool. ``lengths`` counts the valid tokens including the one just
    scattered; 0 marks an inactive slot (zero output). Quantized
    ``(values, scales)`` pools are not supported yet."""
    if isinstance(pages_k, tuple) or isinstance(pages_v, tuple):
        raise NotImplementedError("paged_decode_attention: quantized "
                                  "(int8, scales) pools are not ported")
    if q.device.type == "cpu":
        return paged_decode_plain(q, pages_k, pages_v, tables, lengths,
                                  scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    S, H, D = q.shape
    N, bs, Hk, Dk = pages_k.shape
    if (H, D) != (Hk, Dk) or pages_v.shape != pages_k.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} vs "
                         f"pools {tuple(pages_k.shape)}, "
                         f"{tuple(pages_v.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    if tables.dim() != 2 or tables.shape[0] != S \
            or tuple(lengths.shape) != (S,):
        raise ValueError(f"paged_decode_attention: tables "
                         f"{tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match S={S}")
    MB = tables.shape[1]
    # K and V tiles, scores and the cross-group reduction in 48 KB of
    # shared memory (no opt-in needed)
    smem = 4 * (2 * bs * D + ((bs + 3) & ~3) + 128 * 4)
    if smem > 48 * 1024:
        raise ValueError(f"paged_decode_attention: block size {bs} too "
                         f"large for head dim {D}")
    if S > 65535 or H > 65535:
        raise ValueError("paged_decode_attention: S and H must be <= 65535")
    _check_dtype("paged_decode_attention", torch.float32, q=q,
                 pages_k=pages_k, pages_v=pages_v)
    _check_dtype("paged_decode_attention", torch.int32, tables=tables,
                 lengths=lengths)
    _check_cuda("paged_decode_attention", q.device, q=q, pages_k=pages_k,
                pages_v=pages_v, tables=tables, lengths=lengths)
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):          # launch on q's card
        _launch("paged_decode", q.data_ptr(), pages_k.data_ptr(),
                pages_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), S, H, D, N, bs, MB, scale, _stream_ptr(q))
    return out

