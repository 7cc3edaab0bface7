"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the smoke run does not reach: ragged T, one-token T, D =
128, causal with segments, a given scale, block sizes 8/16/32, empty and
full slots, and the wrappers' input checks; for the flash backward also
the autograd seam (no backward launch under ``torch.no_grad()``, and
gradients through ``FlashAttentionFunction`` against autograd of the
plain forward); for the split-context paged kernels, lengths and spans
on and across partition boundaries at block sizes 8/16/32, a slot whose
span fills the table, reruns bit-equal for all four entries, the span's
Q = 1 and per-row bit-equality with the paged decode (across a boundary
too), the int8 and bf16 branches of both (bf16: within ATOL plus the
rounding slack of ``paged_rounding_slack``, p rounded as the plain
version rounds it, the refusal of mixed pools, bf16 queries and pools off
a 16-byte boundary), no host synchronisation inside an entry
and the plan's shared memory against the kernel's own; for the 1x1-conv
weight gradient and the fused LayerNorm-matmul, ragged edge shapes, the
wrappers' refusals, bit-equal reruns and a small ResNet trained through
the kernel against the convolution path, and shapes that reach each tile
instance and each copy width of their shared mainloop (``x[1:]`` views,
a base pointer 4 bytes off 16, K and M off the 32-row k-tile); for the
flash backward T at each tile size of its plan -1, exactly and +1, T =
2048 on both instances, each instance with 16- and 4-byte copies, the
stored ds over a buffer of NaN, and the plan's shared memory against
the kernels' own; for the flash forward T at its tile sizes -1, exactly
and +1, a negative scale, T = 2048 on both instances, each instance with
16- and 4-byte copies (views 4 bytes off 16), reruns bit-equal, and the
plan's shared memory against the kernel's own; for the serving programs
as CUDA graphs, five engine modes (greedy, speculation with chunked
prefill, int8, sampled with and without speculation) against the eager
bodies or an unwarmed engine, launch counts under replay, replays that
run no Python and a capture that fails; for the bf16 weight gradient
``conv1x1_dw_bf16``, M and channels off every tile, split and copy
width, each instance of its two routes (wgmma on 16-byte copies;
mma.sync on 4-byte copies and the plain 2-byte loads of views at an odd
element offset) at the largest M of a ResNet-50 step, at a ragged M and
ragged channels and on a view off its allocation, M = 0, reruns
bit-equal, the refusal of mixed dtypes, and a small ResNet trained
through it under ``bfloat16_compute`` (every launch on the wgmma route);
and the policy product (cuBLAS, bf16 operands, an
f32 output, the cotangent split in two bf16 halves) against its CPU
version; and the bf16 branches of the flash kernels (forward, dq, dk/dv)
and of ``ln_matmul`` against their plain versions in bf16 ulps (every
entry within one ulp of the largest, at most ``BF16_SHARE`` of the
entries off), at T off every tile size, on each instance with 16- and
4-byte copies (``ln_matmul_bf16`` also plain 2-byte loads), the stored
bf16 ds over a buffer of NaN, reruns bit-equal, autograd through
``flash_attention`` on bf16 leaves, the plans' shared memory, and the
refusals of mixed dtypes and of bf16 views 2 bytes off 4; the ``wgmma``
routes of ``flash_fwd_bf16`` (D 64 and 128, causal or not, segments, T
off the 64-key tiles, both instances; the LSE, the unrounded control
failing the gate) and of ``ln_matmul_bf16`` (both strip instances, K
past them on ``mma.sync``, with and without scale and bias), each call's
route read from the route counters (views 4 bytes off 16 go by
``mma.sync``); the ``wgmma`` route of the bf16 backward (dk/dv storing ds
over NaN, dq from it and recomputing, D 64 and 128, causal or not,
segments, T off the 64-row tiles, both instances, the unrounded control
failing the gate, launches by route, views by ``mma.sync``) and its
delta kernel; and the three ``wgmma`` forms of ``csrc/wgmma_bf16.cuh``
the new kernels rest on (K-major operands from shared memory, A from
registers, K-major A with MN-major B) against ``torch.mm`` in f32; and
the ``Trainer``'s host pipeline: the stager's copies from pinned buffers
on its own stream, behind an event, and ``pipeline_depth`` 3 bit-equal
to the serial loop (parameters, Adam state, costs), plain, grouped and
accumulating.
Every test needs an
NVIDIA GPU (marker ``cuda``) and skips without one; run them on the card
with ``python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py``
(the JAX harness in ``tests/conftest.py`` is not needed there).
Tolerance: atol 1e-4 — f32 on both sides, summed in different orders."""

import math
import pathlib
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.nn import cuda_conv as cc
from paddle_tpu_torch.nn import fused_ln as fl
from paddle_tpu_torch.nn.gemm_f32 import LARGE, SMALL, copy_width

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _segments(B, T):
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        cut = [0, T // 3 + b, (2 * T) // 3, T - 5 - b]
        for i in range(3):
            seg[b, cut[i]:cut[i + 1]] = i + 1
    return seg.cuda()


@pytest.mark.parametrize("B,H,T,D,causal,segs,scale", [
    (1, 2, 100, 64, True, False, None),       # T not a tile multiple
    (2, 3, 130, 128, False, True, None),
    (2, 2, 200, 64, True, True, None),
    (1, 1, 1, 64, False, False, None),
    (1, 2, 64, 128, True, False, 0.3),
    # T at the key tile (32) and the query tiles (32, 128) -1, exactly, +1
    (1, 3, 31, 64, True, True, None), (1, 3, 32, 128, True, False, None),
    (1, 3, 33, 128, False, True, None), (2, 2, 127, 64, True, False, None),
    (2, 2, 128, 128, True, True, None), (2, 2, 129, 64, False, False, None),
    # a negative scale: the masks must hold with the max taken after it
    (1, 2, 96, 64, True, True, -0.2),
    # T = 2048 causal on the small (B*H = 2) and the large (B*H = 40) one
    (1, 2, 2048, 128, True, False, None), (5, 8, 2048, 64, True, False, None),
])
def test_flash_kernel_matches_plain(gen, B, H, T, D, causal, segs, scale):
    q, k, v = (torch.randn(B, H, T, D, generator=gen, device="cuda")
               for _ in range(3))
    seg = _segments(B, T) if segs else None
    before = ca.launch_counts()["flash_fwd"]
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal, scale)
    assert ca.launch_counts()["flash_fwd"] == before + 1
    o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal, scale)
    torch.cuda.synchronize()
    assert (o - o_ref).abs().max().item() <= ATOL
    assert (lse - lse_ref).abs().max().item() <= ATOL
    again = ca.flash_attention_fwd(q, k, v, seg, causal, scale)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def _boundary_lengths(bs, MB):
    """Decode lengths 0 and 1, on and across the plan's partition
    boundaries, a slot filling the table, and a few block edges."""
    P = ca.paged_plan(MB, bs, 64, 1).part
    W = MB * bs
    return torch.tensor([0, 1, bs, bs + 1, W, 3 * bs - 1, P - 1, P, P + 1,
                         2 * P + bs + 1], dtype=torch.int32,
                        device="cuda").clamp(max=W)


@pytest.mark.parametrize("D,bs", [(64, 8), (64, 32), (128, 16), (128, 8),
                                  (64, 16), (128, 32)])
def test_paged_kernel_matches_plain(gen, D, bs):
    """Lengths on and across partition boundaries at bs 8, 16 and 32, a
    slot filling the table, shared blocks; reruns bit-equal."""
    H, MB = 3, 320 // bs                       # 2.5 partitions of context
    lengths = _boundary_lengths(bs, MB)
    S = lengths.numel()
    N = S * MB + 1
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32)
    tables[5, :2] = tables[4, :2]              # shared blocks
    q = torch.randn(S, H, D, generator=gen, device="cuda")
    pk = torch.randn(N, bs, H, D, generator=gen, device="cuda")
    pv = torch.randn(N, bs, H, D, generator=gen, device="cuda")
    out = ca.paged_decode_attention(q, pk, pv, tables, lengths)
    ref = ca.paged_decode_plain(q, pk, pv, tables, lengths)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= ATOL
    assert out[0].abs().max().item() == 0.0
    again = ca.paged_decode_attention(q, pk, pv, tables, lengths)
    assert torch.equal(out, again)             # no atomics


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 2, 64, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        ca.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3)
        ca.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="head dim"):
        ca.flash_attention_fwd(q[..., :32].contiguous(),
                               q[..., :32].contiguous(),
                               q[..., :32].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        ca.flash_attention_fwd(q, q.cpu(), q)
    qd = torch.randn(1, 2, 64, device="cuda")
    pk = torch.randn(5, 16, 2, 64, device="cuda")
    tables = torch.ones(1, 2, dtype=torch.int32, device="cuda")
    lengths = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="both be plain"):
        ca.paged_decode_attention(qd, (pk, pk[..., 0]), pk, tables, lengths)
    with pytest.raises(ValueError, match="dtype"):
        ca.paged_decode_attention(qd, pk, pk, tables.long(), lengths)
    big = torch.randn(2, 512, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="block size"):
        ca.paged_decode_attention(qd, big, big, tables, lengths)
    # the plan's shared memory: int8 pools at D 128 and bs 256
    q128 = torch.randn(1, 2, 128, device="cuda")
    big8 = torch.zeros(2, 256, 2, 128, dtype=torch.int8, device="cuda")
    sc = torch.ones(2, 256, 2, device="cuda")
    with pytest.raises(ValueError, match="block size"):
        ca.paged_decode_attention(q128, (big8, sc), (big8, sc), tables,
                                  lengths)
    # an int8 pool off a 16-byte boundary (16-byte cp.async copies)
    raw = torch.zeros(5 * 16 * 2 * 64 + 4, dtype=torch.int8, device="cuda")
    off = raw[4:].view(5, 16, 2, 64)
    s8 = torch.ones(5, 16, 2, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        ca.paged_decode_attention(qd, (off, s8), (off, s8), tables, lengths)


def test_engine_tokens_paged_equal_xla_on_card(gen):
    import paddle_tpu_torch as pt
    model = pt.TransformerLM(101, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=256, max_len=64, use_flash=True,
                             generator=gen)
    prompts = [[int(t) for t in torch.randint(0, 101, (n,), generator=gen,
                                              device="cuda").cpu()]
               for n in (3, 17, 40, 9)]
    toks = {}
    for impl in ("paged", "xla"):
        eng = pt.DecodeEngine(model, max_slots=3, block_size=8,
                              attention=impl)
        sched = pt.ContinuousBatchingScheduler(eng)
        reqs = [sched.submit(p, 12) for p in prompts]
        sched.run()
        toks[impl] = [r.tokens for r in reqs]
    assert toks["paged"] == toks["xla"]
    ref = pt.TransformerLM(101, dim=128, num_layers=2, num_heads=2,
                           ffn_hidden=256, max_len=64, device="cuda")
    ref.load_state_dict(model.state_dict())
    ids = torch.tensor([prompts[2]], device="cuda")
    with torch.no_grad():
        assert (model(ids) - ref(ids)).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,H,T,D,causal,segs", [
    (1, 2, 1, 64, True, False),               # one token
    (2, 2, 63, 64, True, False),              # T one short of a tile
    (2, 3, 65, 128, False, False),            # T one past a tile
    (2, 2, 200, 128, True, True),             # causal with segments
    (1, 2, 130, 64, False, True),
    # T at each tile size of the plan's instances -1, exactly, +1:
    # streamed tiles of 16 and 32 rows, resident tiles of 32 and 64
    (1, 3, 15, 128, True, False), (1, 3, 16, 64, True, True),
    (1, 3, 17, 128, False, True), (1, 3, 31, 64, True, False),
    (1, 3, 32, 128, True, True), (1, 3, 33, 64, False, False),
    (2, 2, 64, 128, True, False), (5, 28, 63, 128, True, False),
    (5, 28, 64, 64, True, True), (5, 28, 65, 128, True, True),
    # T = 2048 causal at small B*H: the small and the large instance
    (1, 2, 2048, 128, True, False), (1, 5, 2048, 128, True, False),
    # D 64 and 128 with segments and padding tails on both instances
    (2, 2, 300, 64, False, True), (4, 20, 300, 64, True, True),
    (3, 12, 300, 128, False, True),
])
def test_flash_bwd_kernels_match_plain(gen, B, H, T, D, causal, segs):
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                   for _ in range(4))
    seg = _segments(B, T) if segs else None
    if seg is not None:
        do = do * (seg > 0)[:, None, :, None]
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
    before = ca.launch_counts()
    got = ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal)
    after = ca.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= ATOL
    again = ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


def _flat(gen, shape, offset, dtype=torch.float32):
    """A contiguous tensor on the card whose base pointer lies ``offset``
    values past a fresh allocation (16-byte aligned at 0)."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("B,H,T,D,tile", [
    (3, 3, 1000, 128, 0), (1, 2, 300, 128, 1),
    (3, 6, 1000, 64, 0), (1, 3, 97, 64, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_bwd_each_tile_and_copy_width(gen, B, H, T, D, tile, offset):
    """Every instance the plan can pick, with 16-byte copies (aligned
    operands) and 4-byte ones (every operand 4 bytes off 16), causal with
    segments: within ATOL of the plain version, bit-equal reruns, one
    counted launch each."""
    q, k, v, do = (_flat(gen, (B, H, T, D), offset) for _ in range(4))
    seg = _segments(B, T)
    do.mul_((seg > 0)[:, None, :, None])
    assert ca.flash_bwd_plan(B, H, T, D, True).tile == tile
    assert copy_width(q, k, v, do) == (1 if offset else 4)
    o, lse = ca.flash_attention_fwd(q, k, v, seg, True)
    delta = (do * o).sum(-1)
    args = (q, k, v, seg, do, lse, delta, True)
    before = ca.launch_counts()
    dq = ca.flash_bwd_dq(*args)
    dk, dv = ca.flash_bwd_dkv(*args)
    after = ca.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = (ca.flash_bwd_dq_plain(*args), *ca.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv), want):
        assert (g - w).abs().max().item() <= ATOL
    assert torch.equal(ca.flash_bwd_dq(*args), dq)
    assert all(torch.equal(a, b) for a, b in
               zip(ca.flash_bwd_dkv(*args), (dk, dv)))


@pytest.mark.parametrize("B,H,T,D,causal", [(2, 3, 200, 64, True),
                                             (2, 2, 128, 128, False),
                                             (3, 12, 300, 128, True)])
def test_flash_bwd_stored_ds_reads_no_unwritten_entry(gen, B, H, T, D,
                                                      causal):
    """dk/dv stores ds in a buffer that holds NaN everywhere, and dq reads
    it back: the entries dk/dv never wrote (skipped tiles: other segments,
    padding, the causal cone) keep their NaN and must not reach dq.
    Against the plain version and the recomputing dq within ATOL, one
    counted launch each; the whole backward stores ds at these shapes and
    agrees bit for bit."""
    assert ca.flash_bwd_plan(B, H, T, D, causal).stored_ds
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                   for _ in range(4))
    seg = _segments(B, T)
    do = do * (seg > 0)[:, None, :, None]
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
    delta = (do * o).sum(-1)
    args = (q, k, v, seg, do, lse, delta, causal)
    ds = torch.full((B * H, T, T), float("nan"), device="cuda")
    before = ca.launch_counts()
    dk, dv = ca.flash_bwd_dkv(*args, ds=ds)
    dq = ca.flash_bwd_dq(*args, ds=ds)
    after = ca.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal)
    alone = ca.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert torch.isnan(ds).any()             # some entries left unwritten
    for g, w in zip((dq, dk, dv), want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= ATOL
    assert (dq - alone).abs().max().item() <= ATOL
    whole = ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(whole, (dq, dk, dv)))


@pytest.mark.parametrize("B,H,T,D,tile", [
    (3, 12, 500, 128, 0), (1, 2, 300, 128, 1),
    (4, 17, 500, 64, 0), (1, 3, 97, 64, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_fwd_each_tile_and_copy_width(gen, B, H, T, D, tile, offset):
    """Every instance the forward's plan can pick, with 16-byte copies
    (aligned operands) and 4-byte ones (every operand a view 4 bytes off
    16, ``buf[1:].view(...)``), causal with segments: O and LSE within
    ATOL of the plain version, bit-equal reruns, one counted launch."""
    q, k, v = (_flat(gen, (B, H, T, D), offset) for _ in range(3))
    seg = _segments(B, T)
    assert ca.flash_fwd_plan(B, H, T, D, True).tile == tile
    assert copy_width(q, k, v) == (1 if offset else 4)
    before = ca.launch_counts()["flash_fwd"]
    o, lse = ca.flash_attention_fwd(q, k, v, seg, True)
    assert ca.launch_counts()["flash_fwd"] == before + 1
    o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, True)
    torch.cuda.synchronize()
    assert (o - o_ref).abs().max().item() <= ATOL
    assert (lse - lse_ref).abs().max().item() <= ATOL
    again = ca.flash_attention_fwd(q, k, v, seg, True)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_flash_fwd_plan_shared_memory_is_the_kernels(gen):
    """The forward plan's shared-memory figure is the kernel's own, for
    every instance at both head dims."""
    from paddle_tpu_torch.utils import cuda_build
    import ctypes
    fn = cuda_build.load("flash_fwd").flash_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    for D, tiles in ca._FWD_TILES.items():
        for i, t in enumerate(tiles):
            assert fn(D, i) == ca._fwd_smem(D, t)
    assert fn(96, 0) == -1 and fn(128, 2) == -1


def test_flash_bwd_plan_shared_memory_is_the_kernels(gen):
    """The plan's shared-memory figure is the kernels' own, for every
    instance at both head dims."""
    from paddle_tpu_torch.utils import cuda_build
    import ctypes
    fn = cuda_build.load("flash_bwd").flash_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    for D, tiles in ca._BWD_TILES.items():
        for i, t in enumerate(tiles):
            assert fn(D, i) == ca._bwd_smem(D, t)
    assert fn(96, 0) == -1 and fn(128, 2) == -1


def test_flash_bwd_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 2, 64, 64, generator=gen, device="cuda")
    o, lse = ca.flash_attention_fwd(q, q, q)
    before = ca.launch_counts()
    with pytest.raises(ValueError, match="dtype"):
        h = q.half()
        ca.flash_attention_bwd(h, h, h, None, h, lse, h)
    with pytest.raises(ValueError, match="head dim"):
        w = torch.randn(1, 2, 64, 96, generator=gen, device="cuda")
        ca.flash_attention_bwd(w, w, w, None, w, lse, w)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3)
        ca.flash_attention_bwd(q, q, q, None, o, lse, t)
    with pytest.raises(ValueError, match="contiguous"):
        ca.flash_bwd_dq(q, q, q, None, q, lse, lse[..., ::2].repeat(
            1, 1, 2).transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        ca.flash_bwd_dkv(q, q, q, None, q, lse[:, :1].contiguous(), lse)
    with pytest.raises(ValueError, match="segments"):
        ca.flash_bwd_dq(q, q, q, torch.ones(1, 63, dtype=torch.int32,
                                             device="cuda"), q, lse, lse)
    with pytest.raises(ValueError, match="dtype"):
        ca.flash_bwd_dkv(q, q, q, torch.ones(1, 64, dtype=torch.int64,
                                              device="cuda"), q, lse, lse)
    with pytest.raises(ValueError, match="B\\*H"):
        w = torch.zeros(1, 65536, 1, 64, device="cuda")
        r = torch.zeros(1, 65536, 1, device="cuda")
        ca.flash_bwd_dq(w, w, w, None, w, r, r)
    # a stored-ds buffer: [B*H, T, T] f32, 16-byte aligned, T % 4 == 0
    with pytest.raises(ValueError, match="ds"):
        ca.flash_bwd_dkv(q, q, q, None, q, lse, lse,
                         ds=torch.empty(2, 64, 63, device="cuda"))
    with pytest.raises(ValueError, match="aligned"):
        ca.flash_bwd_dq(q, q, q, None, q, lse, lse,
                        ds=torch.empty(2 * 64 * 64 + 1,
                                       device="cuda")[1:].view(2, 64, 64))
    with pytest.raises(ValueError, match="dtype"):
        ca.flash_bwd_dq(q, q, q, None, q, lse, lse,
                        ds=torch.empty(2, 64, 64, device="cuda").half())
    with pytest.raises(ValueError, match="T % 4"):
        w = torch.randn(1, 2, 62, 64, generator=gen, device="cuda")
        r = torch.zeros(1, 2, 62, device="cuda")
        ca.flash_bwd_dkv(w, w, w, None, w, r, r,
                         ds=torch.empty(2, 62, 62, device="cuda"))
    after = ca.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"]
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"]


def test_no_grad_flash_launches_no_backward(gen):
    q = torch.randn(1, 2, 64, 64, generator=gen, device="cuda",
                    requires_grad=True)
    ca.reset_launch_counts()
    with torch.no_grad():
        out = ca.flash_attention(q, q, q, None, True)
    assert out.grad_fn is None
    assert ca.launch_counts() == {**{n: 0 for n in ca.KERNELS},
                                  "flash_fwd": 1}


@pytest.mark.parametrize("causal,segs", [(True, False), (True, True),
                                         (False, True)])
def test_function_gradients_match_autograd_of_plain(gen, causal, segs):
    B, H, T, D = 2, 2, 96, 64
    base = [torch.randn(B, H, T, D, generator=gen, device="cuda")
            for _ in range(4)]
    seg = _segments(B, T) if segs else None
    do = base[3] if seg is None else base[3] * (seg > 0)[:, None, :, None]
    grads = {}
    for impl in ("kernel", "plain"):
        q, k, v = (t.clone().requires_grad_() for t in base[:3])
        if impl == "kernel":
            out = ca.flash_attention(q, k, v, seg, causal)
            assert type(out.grad_fn).__name__ == \
                "FlashAttentionFunctionBackward"
        else:
            out = ca.flash_attention_plain(q, k, v, seg, causal)[0]
        out.backward(do)
        grads[impl] = [t.grad for t in (q, k, v)]
    torch.cuda.synchronize()
    for g, w in zip(grads["kernel"], grads["plain"]):
        assert (g - w).abs().max().item() <= ATOL


def _span_case(gen, S, H, D, bs, MB, quant):
    """Pools of ``S * MB + 1`` blocks (int8 with f32 row scales when
    ``quant``), each slot's table a disjoint random run of blocks."""
    N = S * MB + 1
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32)
    pools = []
    for _ in range(2):
        raw = torch.randn(N, bs, H, D, generator=gen, device="cuda")
        if quant:
            amax = raw.abs().amax(-1)
            scale = amax.clamp_min(1e-8) / 127.0
            pools.append((torch.round(raw / scale[..., None]).clamp(
                -127, 127).to(torch.int8), scale))
        else:
            pools.append(raw)
    return pools[0], pools[1], tables


@pytest.mark.parametrize("Q,D,quant", [(1, 64, False), (5, 64, False),
                                       (128, 64, False), (5, 128, False),
                                       (128, 128, False), (5, 64, True),
                                       (128, 128, True)])
def test_paged_span_kernel_matches_plain_and_decode_rows(gen, Q, D, quant):
    """At bs 8, 16 and 32: starts mid-block, at a block boundary, at 0,
    across a partition boundary and at the table's end (a span filling
    it), ``n`` below ``Q`` and ``n == 0`` with a stale start; live rows
    within ATOL of the plain version, reruns bit-equal, and each row
    bit-equal to the paged decode at ``start + j + 1``, across the
    boundary too."""
    S, H = 6, 3
    name = "paged_span_int8" if quant else "paged_span"
    for bs in (8, 16, 32):
        MB = 384 // bs                         # three partitions
        P = ca.paged_plan(MB, bs, D, Q).part
        pk, pv, tables = _span_case(gen, S, H, D, bs, MB, quant)
        cap = MB * bs
        start = torch.tensor([3, 32, 0, cap - Q, 17, P - 2],
                             dtype=torch.int32, device="cuda") \
            .clamp(0, cap - Q)
        n = torch.tensor([Q, max(1, Q - 2), Q, Q, 0, Q], dtype=torch.int32,
                         device="cuda")
        q = torch.randn(S, Q, H, D, generator=gen, device="cuda")
        before = ca.launch_counts()[name]
        out = ca.paged_span_attention(q, pk, pv, tables, start, n)
        assert ca.launch_counts()[name] == before + 1
        ref = ca.paged_span_plain(q, pk, pv, tables, start, n)
        torch.cuda.synchronize()
        for s in range(S):
            live = int(n[s])
            assert (out[s, :live] - ref[s, :live]).abs().max().item() \
                <= ATOL if live else out[s].abs().max().item() == 0.0
        assert torch.equal(out, ca.paged_span_attention(q, pk, pv, tables,
                                                        start, n))
        for j in range(Q):
            lengths = torch.where(n > j, start + j + 1, 0).to(torch.int32)
            single = ca.paged_decode_attention(q[:, j].contiguous(), pk, pv,
                                               tables, lengths)
            live = n > j
            assert torch.equal(out[live, j], single[live]), \
                f"bs {bs} row {j}"


def test_paged_span_rows_before_position_zero_give_zeros(gen):
    """A span starting before position 0: its rows at negative positions
    see no key and give zeros, as the plain version does; the others
    match it."""
    pk, pv, tables = _span_case(gen, 2, 2, 64, 16, 16, False)
    q = torch.randn(2, 5, 2, 64, generator=gen, device="cuda")
    start = torch.tensor([-3, 126], dtype=torch.int32, device="cuda")
    n = torch.tensor([5, 5], dtype=torch.int32, device="cuda")
    out = ca.paged_span_attention(q, pk, pv, tables, start, n)
    ref = ca.paged_span_plain(q, pk, pv, tables, start, n)
    torch.cuda.synchronize()
    assert out[0, :3].abs().max().item() == 0.0
    assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.parametrize("D,bs", [(64, 16), (128, 8), (64, 8), (128, 32)])
def test_paged_decode_int8_kernel_matches_plain(gen, D, bs):
    """Lengths on and across partition boundaries, a slot filling the
    table; reruns bit-equal."""
    H, MB = 3, 320 // bs
    lengths = _boundary_lengths(bs, MB)
    S = lengths.numel()
    pk, pv, tables = _span_case(gen, S, H, D, bs, MB, True)
    q = torch.randn(S, H, D, generator=gen, device="cuda")
    before = ca.launch_counts()["paged_decode_int8"]
    out = ca.paged_decode_attention(q, pk, pv, tables, lengths)
    assert ca.launch_counts()["paged_decode_int8"] == before + 1
    ref = ca.paged_decode_plain(q, pk, pv, tables, lengths)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= ATOL
    assert out[0].abs().max().item() == 0.0
    again = ca.paged_decode_attention(q, pk, pv, tables, lengths)
    assert torch.equal(out, again)             # no atomics


def _bf16_close(out, ref, unrounded, slack):
    """A bf16-pool kernel against its plain version: within ATOL beyond
    each entry's rounding slack, and rounding p as the plain version does
    (its mean distance to it under a tenth of the plain version's own
    distance to the unrounded function)."""
    diff = (out - ref).abs()
    assert (diff - slack).max().item() <= ATOL
    assert diff.mean().item() <= 0.1 * (unrounded - ref).abs().mean().item()


@pytest.mark.parametrize("D,bs", [(64, 16), (128, 8), (64, 8), (128, 32),
                                  (64, 7)])
def test_paged_decode_bf16_kernel_matches_plain(gen, D, bs):
    """bf16 pools: lengths on and across partition boundaries, a slot
    filling the table (bs 7: partitions of 133 positions, the stored
    scores' rows padded to 136); reruns bit-equal."""
    H, MB = 3, 320 // bs
    lengths = _boundary_lengths(bs, MB)
    S = lengths.numel()
    pk, pv, tables = _span_case(gen, S, H, D, bs, MB, False)
    pk, pv = pk.bfloat16(), pv.bfloat16()
    q = torch.randn(S, H, D, generator=gen, device="cuda")
    before = ca.launch_counts()["paged_decode_bf16"]
    out = ca.paged_decode_attention(q, pk, pv, tables, lengths)
    assert ca.launch_counts()["paged_decode_bf16"] == before + 1
    ref = ca.paged_decode_plain(q, pk, pv, tables, lengths)
    slack = ca.paged_rounding_slack(q[:, None], pk, pv, tables,
                                    (lengths - 1).clamp(min=0),
                                    (lengths > 0).int())[:, 0]
    _bf16_close(out, ref, ca.paged_decode_plain(q, pk.float(), pv.float(),
                                                tables, lengths), slack)
    assert out[0].abs().max().item() == 0.0
    assert torch.equal(out, ca.paged_decode_attention(q, pk, pv, tables,
                                                      lengths))


@pytest.mark.parametrize("Q,D", [(1, 64), (5, 64), (128, 64), (5, 128),
                                 (128, 128)])
def test_paged_span_bf16_kernel_matches_plain_and_decode_rows(gen, Q, D):
    """bf16 pools at bs 7, 8, 16 and 32, the spans of the f32 test: live rows
    against the plain version, reruns bit-equal, each row bit-equal to
    ``paged_decode_bf16`` at ``start + j + 1``, across the partition
    boundary too."""
    S, H = 6, 3
    for bs in (7, 8, 16, 32):
        MB = 384 // bs
        P = ca.paged_plan(MB, bs, D, Q, ca.POOL_BF16).part
        pk, pv, tables = _span_case(gen, S, H, D, bs, MB, False)
        pk, pv = pk.bfloat16(), pv.bfloat16()
        cap = MB * bs
        start = torch.tensor([3, 32, 0, cap - Q, 17, P - 2],
                             dtype=torch.int32, device="cuda") \
            .clamp(0, cap - Q)
        n = torch.tensor([Q, max(1, Q - 2), Q, Q, 0, Q], dtype=torch.int32,
                         device="cuda")
        q = torch.randn(S, Q, H, D, generator=gen, device="cuda")
        before = ca.launch_counts()["paged_span_bf16"]
        out = ca.paged_span_attention(q, pk, pv, tables, start, n)
        assert ca.launch_counts()["paged_span_bf16"] == before + 1
        ref = ca.paged_span_plain(q, pk, pv, tables, start, n)
        live = torch.arange(Q, device="cuda")[None] < n[:, None]
        _bf16_close(out[live], ref[live], ca.paged_span_plain(
            q, pk.float(), pv.float(), tables, start, n)[live],
            ca.paged_rounding_slack(q, pk, pv, tables, start, n)[live])
        assert out[4].abs().max().item() == 0.0       # n == 0
        assert torch.equal(out, ca.paged_span_attention(q, pk, pv, tables,
                                                        start, n))
        for j in range(Q):
            lengths = torch.where(n > j, start + j + 1, 0).to(torch.int32)
            single = ca.paged_decode_attention(q[:, j].contiguous(), pk, pv,
                                               tables, lengths)
            rows = n > j
            assert torch.equal(out[rows, j], single[rows]), \
                f"bs {bs} row {j}"


def test_bf16_paged_wrappers_refuse_what_the_kernels_do_not_take(gen):
    """Mixed pools (one bf16, one f32), bf16 queries and a bf16 pool off a
    16-byte boundary are refused before any launch."""
    pk, pv, tables = _span_case(gen, 2, 2, 64, 16, 4, False)
    hk, hv = pk.bfloat16(), pv.bfloat16()
    q1 = torch.randn(2, 2, 64, generator=gen, device="cuda")
    q5 = torch.randn(2, 5, 2, 64, generator=gen, device="cuda")
    lengths = torch.tensor([5, 30], dtype=torch.int32, device="cuda")
    start = torch.zeros(2, dtype=torch.int32, device="cuda")
    n = torch.full((2,), 5, dtype=torch.int32, device="cuda")
    before = ca.launch_counts()
    with pytest.raises(ValueError, match="mixed pools"):
        ca.paged_decode_attention(q1, hk, pv, tables, lengths)
    with pytest.raises(ValueError, match="mixed pools"):
        ca.paged_span_attention(q5, pk, hv, tables, start, n)
    with pytest.raises(ValueError, match="dtype"):
        ca.paged_decode_attention(q1.bfloat16(), hk, hv, tables, lengths)
    with pytest.raises(ValueError, match="dtype"):
        ca.paged_span_attention(q5.bfloat16(), hk, hv, tables, start, n)
    raw = torch.zeros(hk.numel() + 4, dtype=torch.bfloat16, device="cuda")
    off = raw[4:].view(hk.shape)                  # 8 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ca.paged_decode_attention(q1, off, off, tables, lengths)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ca.paged_span_attention(q5, off, off, tables, start, n)
    assert ca.launch_counts() == before


def test_paged_plan_shared_memory_is_the_kernels(gen):
    """The plan's shared-memory figures are the kernels' own layouts: the
    partials kernel's (bf16 pools: the max pass) and the bf16 pools' main
    pass."""
    from paddle_tpu_torch.utils import cuda_build
    import ctypes
    lib = cuda_build.load("paged_span")
    fn, pv = lib.paged_smem_bytes, lib.paged_pv_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    pv.argtypes = [ctypes.c_int] * 3
    fn.restype = pv.restype = ctypes.c_int
    for D in (64, 128):
        for bs in (7, 8, 12, 16, 32, 128):
            for Q in (1, 5, 128):
                for pool in (ca.POOL_F32, ca.POOL_INT8, ca.POOL_BF16):
                    plan = ca.paged_plan(64, bs, D, Q, pool)
                    assert fn(D, plan.rows, plan.part, pool) == plan.smem
                plan = ca.paged_plan(64, bs, D, Q, ca.POOL_BF16)
                assert pv(D, plan.rows, plan.part) == plan.pv_smem


def test_paged_entries_do_not_synchronise(gen):
    """The six entries read no per-slot value on the host: under
    ``set_sync_debug_mode("error")`` a synchronising call would raise."""
    S, H, D, bs, MB = 4, 2, 64, 16, 16
    plain = _span_case(gen, S, H, D, bs, MB, False)
    quant = _span_case(gen, S, H, D, bs, MB, True)
    half = (plain[0].bfloat16(), plain[1].bfloat16(), plain[2])
    lengths = torch.tensor([0, 5, 200, 256], dtype=torch.int32,
                           device="cuda")
    start = torch.tensor([0, 120, 250, 7], dtype=torch.int32, device="cuda")
    n = torch.tensor([5, 5, 5, 0], dtype=torch.int32, device="cuda")
    q1 = torch.randn(S, H, D, generator=gen, device="cuda")
    q5 = torch.randn(S, 5, H, D, generator=gen, device="cuda")
    for pk, pv, tables in (plain, quant, half):   # build outside the check
        ca.paged_decode_attention(q1, pk, pv, tables, lengths)
        ca.paged_span_attention(q5, pk, pv, tables, start, n)
    torch.cuda.synchronize()
    before = ca.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pk, pv, tables in (plain, quant, half):
            ca.paged_decode_attention(q1, pk, pv, tables, lengths)
            ca.paged_span_attention(q5, pk, pv, tables, start, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = ca.launch_counts()
    for name in ("paged_decode", "paged_decode_int8", "paged_decode_bf16",
                 "paged_span", "paged_span_int8", "paged_span_bf16"):
        assert after[name] == before[name] + 1


def test_span_wrappers_refuse_what_the_kernel_does_not_take(gen):
    pk, pv, tables = _span_case(gen, 2, 2, 64, 16, 4, False)
    q = torch.randn(2, 5, 2, 64, generator=gen, device="cuda")
    start = torch.zeros(2, dtype=torch.int32, device="cuda")
    n = torch.full((2,), 5, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        ca.paged_span_attention(q.double(), pk, pv, tables, start, n)
    with pytest.raises(ValueError, match="dtype"):
        ca.paged_span_attention(q, pk, pv, tables, start.long(), n)
    with pytest.raises(ValueError, match="contiguous"):
        ca.paged_span_attention(q.transpose(0, 1).contiguous().transpose(
            0, 1), pk, pv, tables, start, n)
    big = torch.randn(2, ca.SPAN_MAX_Q + 1, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="query rows"):
        ca.paged_span_attention(big, pk, pv, tables, start, n)
    qk, qv, _ = _span_case(gen, 2, 2, 64, 16, 4, True)
    with pytest.raises(ValueError, match="scales_k"):
        ca.paged_span_attention(q, (qk[0], qk[1][:, :8].contiguous()), qv,
                                tables, start, n)
    with pytest.raises(ValueError, match="dtype"):
        ca.paged_span_attention(q, (qk[0].float(), qk[1]), qv, tables,
                                start, n)
    with pytest.raises(ValueError, match="both be plain"):
        ca.paged_span_attention(q, qk, pv, tables, start, n)
    with pytest.raises(ValueError, match="do not match"):
        ca.paged_span_attention(q, pk, pv, tables, start[:1].contiguous(),
                                n)


def test_engine_spec_chunk_int8_on_card(gen):
    """Speculative verify, chunked prefill and int8 pools through the
    kernels: speculation gives the plain engine's tokens, the int8 engine's
    paged and xla paths agree, and the span kernel launched."""
    import paddle_tpu_torch as pt
    model = pt.TransformerLM(101, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=256, max_len=64, generator=gen)
    prompts = [[int(t) for t in torch.randint(0, 101, (n,), generator=gen,
                                              device="cuda").cpu()]
               for n in (3, 17, 40, 9)]
    prompts[3] = prompts[3][:4] * 2

    def run(**kw):
        eng = pt.DecodeEngine(model, max_slots=3, block_size=8, **kw)
        sched = pt.ContinuousBatchingScheduler(eng)
        reqs = [sched.submit(p, 12) for p in prompts]
        sched.run()
        return [r.tokens for r in reqs]

    ca.reset_launch_counts()
    base = run()
    assert run(speculative=3, prefill_chunk=16) == base
    assert ca.launch_counts()["paged_span"] > 0
    assert run(kv_dtype="int8", prefill_chunk=16) == \
        run(kv_dtype="int8", prefill_chunk=16, attention="xla")
    counts = ca.launch_counts()
    assert counts["paged_span_int8"] > 0 and counts["paged_decode_int8"] > 0


def _eager_bodies(eng):
    """``eng`` with every call run through its programs' bodies eagerly on
    the same static buffers (the functions its graphs capture)."""
    for prog in (eng._prefill, eng._tick):
        def launch(_prog=prog, **values):
            _prog.inputs.stage(**values)
            _prog.eager_out = _prog.run_eager()

        prog.launch = launch
        prog.fetch = lambda _prog=prog: _prog.eager_out.cpu().numpy()
    return eng


GRAPH_MODES = [{}, {"speculative": 3, "prefill_chunk": 16},
               {"kv_dtype": "int8", "prefill_chunk": 16},
               {"sampling": {"temperature": 0.8, "top_k": 20,
                             "top_p": 0.9, "seed": 3}},
               {"sampling": {"seed": 4}, "speculative": 3}]


@pytest.mark.parametrize("kw", GRAPH_MODES)
def test_engine_graphs_on_card(gen, kw):
    """The serving programs as CUDA graphs: built once through churn,
    launches counted as replays times the capture's, greedy tokens equal
    to the eager bodies' bit for bit, sampled tokens equal across a warmed
    and an unwarmed engine of one seed, the pools back at their start."""
    import paddle_tpu_torch as pt
    model = pt.TransformerLM(101, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=256, max_len=64, use_flash=True,
                             generator=gen)
    prompts = [[int(t) for t in torch.randint(0, 101, (n,), generator=gen,
                                              device="cuda").cpu()]
               for n in (3, 17, 40, 9, 25)]

    def engine():
        args = dict(kw)
        if "sampling" in args:
            args["sampling"] = pt.SamplingConfig(**args["sampling"])
        return pt.DecodeEngine(model, max_slots=3, block_size=8, **args)

    def serve(eng):
        sched = pt.ContinuousBatchingScheduler(eng)
        reqs = [sched.submit(p, 12) for p in prompts]
        sched.run()
        return [r.tokens for r in reqs]

    eng = engine()
    free0 = eng.cache.free_blocks
    assert eng.warmup()["compile_counts"] == {"prefill": 1, "tick": 1}
    progs = (eng._prefill, eng._tick)
    before = [p.replays for p in progs]
    ca.reset_launch_counts()
    got = serve(eng)
    counts = ca.launch_counts()
    reps = [p.replays - b for p, b in zip(progs, before)]
    assert reps == [eng.prefill_chunks, eng.ticks]
    assert counts == {k: sum(r * p.captured[k] for r, p in zip(reps, progs))
                      for k in ca.KERNELS}
    assert sum(counts.values()) > 0
    assert eng.compile_counts() == {"prefill": 1, "tick": 1}
    assert eng.cache.free_blocks == free0 and not eng.cache.allocator._rc
    if "sampling" in kw:
        assert serve(engine()) == got              # not warmed
    else:
        assert serve(_eager_bodies(engine())) == got


def test_engine_graph_replays_run_no_python_and_failures_raise(gen):
    """After the tick's capture its replays call no Python of the model;
    a body that cannot be captured (a host read) raises, with no eager
    path behind it."""
    import paddle_tpu_torch as pt
    model = pt.TransformerLM(101, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=256, max_len=64, generator=gen)
    eng = pt.DecodeEngine(model, max_slots=2, block_size=8)
    eng.warmup()
    eng.admit(0, [1, 2, 3, 4, 5], reserve_len=12)

    def refuse(*a, **k):
        raise AssertionError("the model ran eagerly after the capture")

    model.decode_step = refuse
    try:
        for _ in range(3):
            eng.decode_tick()
    finally:
        del model.decode_step
    # a failed capture in a process of its own: it may leave the card's
    # context unfit for the tests after it
    code = (
        "import torch, paddle_tpu_torch as pt\n"
        "m = pt.TransformerLM(101, dim=128, num_layers=2, num_heads=2, "
        "ffn_hidden=256, max_len=64)\n"
        "fn = m.decode_step\n"
        "m.decode_step = lambda *a, **k: (float(a[0].sum()), "
        "fn(*a, **k))[1]\n"
        "eng = pt.DecodeEngine(m, max_slots=2, block_size=8)\n"
        "try:\n"
        "    eng.warmup()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', type(e).__name__)\n"
        "    raise SystemExit(3)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 3, out.stdout + out.stderr


def _rel_err(got, want):
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


@pytest.mark.parametrize("M,cin,cout", [
    (1, 3, 10), (34, 8, 8), (34, 3, 10), (160, 64, 24), (6144, 10, 3),
    (5000, 130, 70), (100352, 64, 64), (3000, 300, 1000)])
def test_conv1x1_dw_kernel_matches_plain(gen, M, cin, cout):
    x = torch.randn(M, cin, generator=gen, device="cuda")
    dy = torch.randn(M, cout, generator=gen, device="cuda")
    before = cc.launch_counts()["conv1x1_dw"]
    got = cc.conv1x1_dw(x, dy)
    assert cc.launch_counts()["conv1x1_dw"] == before + 1
    want = cc.conv1x1_dw_plain(x, dy)
    torch.cuda.synchronize()
    assert got.shape == (cin, cout) and got.dtype == torch.float32
    assert _rel_err(got, want) <= ATOL
    assert torch.equal(cc.conv1x1_dw(x, dy), got)      # no atomics


def _operand(gen, rows, cols, layout):
    """A contiguous ``[rows, cols]`` f32 operand on the card: fresh, the
    view ``t[1:]`` of a tensor one row longer, or a view of a flat buffer
    one float in (its base pointer 4 bytes off 16)."""
    if layout == "x[1:]":
        return torch.randn(rows + 1, cols, generator=gen, device="cuda")[1:]
    if layout == "flat+1":
        buf = torch.randn(rows * cols + 1, generator=gen, device="cuda")
        return buf[1:].view(rows, cols)
    return torch.randn(rows, cols, generator=gen, device="cuda")


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("M,cin,cout,xl,dyl,tile,vec", [
    (3000, 256, 256, "", "", LARGE, 4),
    (2000, 130, 134, "", "", LARGE, 1),
    (1000, 64, 64, "", "", SMALL, 4),
    (777, 6, 70, "", "", SMALL, 1),
    (1001, 128, 128, "x[1:]", "x[1:]", LARGE, 4),
    (1001, 6, 64, "x[1:]", "", SMALL, 1),
    (900, 128, 192, "flat+1", "", LARGE, 1),
    (900, 64, 64, "", "flat+1", SMALL, 1)])
def test_conv1x1_dw_each_tile_and_copy_width(gen, M, cin, cout, xl, dyl,
                                             tile, vec):
    """Every (tile, copy width) instance of the kernel, M off the 32-row
    k-tile: within ATOL of the plain version, bit-equal reruns, one
    counted launch."""
    x = _operand(gen, M, cin, xl)
    dy = _operand(gen, M, cout, dyl)
    assert x.is_contiguous() and dy.is_contiguous()
    assert cc._plan(M, cin, cout, _sms())[0] == tile
    assert copy_width(x, dy) == vec
    before = cc.launch_counts()["conv1x1_dw"]
    got = cc.conv1x1_dw(x, dy)
    assert cc.launch_counts()["conv1x1_dw"] == before + 1
    want = cc.conv1x1_dw_plain(x, dy)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= ATOL
    assert torch.equal(cc.conv1x1_dw(x, dy), got)


def test_conv1x1_dw_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x = torch.randn(64, 8, generator=gen, device="cuda")
    dy = torch.randn(64, 16, generator=gen, device="cuda")
    before = cc.launch_counts()["conv1x1_dw"]
    for bad in [(x.double(), dy.double()), (x.half(), dy),
                (x.cpu(), dy), (x, dy.cpu()), (x, dy[:32]),
                (x.T.contiguous().T, dy), (x[:, None], dy)]:
        with pytest.raises(ValueError):
            cc.conv1x1_dw(*bad)
    assert cc.launch_counts()["conv1x1_dw"] == before


@pytest.mark.parametrize("M,K,N,affine", [
    (128, 32, 256, ""), (128, 32, 256, "s"), (128, 32, 256, "sb"),
    (100, 70, 130, "sb"), (3, 5, 7, "b"), (1, 1, 1, "")])
def test_ln_matmul_kernel_matches_plain(gen, M, K, N, affine):
    x = torch.randn(M, K, generator=gen, device="cuda") * 3 + 1
    w = torch.randn(K, N, generator=gen, device="cuda")
    scale = torch.randn(K, generator=gen, device="cuda") \
        if "s" in affine else None
    bias = torch.randn(K, generator=gen, device="cuda") \
        if "b" in affine else None
    before = fl.launch_counts()["ln_matmul"]
    got = fl.fused_ln_matmul(x, w, scale, bias)
    assert fl.launch_counts()["ln_matmul"] == before + 1
    want = fl.ln_matmul_reference(x, w, scale, bias)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= ATOL
    assert torch.equal(fl.fused_ln_matmul(x, w, scale, bias), got)


@pytest.mark.parametrize("M,K,N,affine,xl,tile,vec", [
    (4096, 96, 2048, "", "", LARGE, 4),
    (4096, 100, 2048, "sb", "", LARGE, 4),
    (4096, 70, 2048, "sb", "", LARGE, 1),
    (4096, 64, 2048, "s", "x[1:]", LARGE, 4),
    (300, 100, 200, "s", "", SMALL, 4),
    (130, 70, 129, "b", "", SMALL, 1),
    (1025, 64, 96, "sb", "x[1:]", SMALL, 4),
    (257, 64, 96, "sb", "flat+1", SMALL, 1)])
def test_ln_matmul_each_tile_and_copy_width(gen, M, K, N, affine, xl, tile,
                                            vec):
    """Every (tile, copy width) instance of the product, K off the 32-wide
    k-tile: within ATOL of the plain version, bit-equal reruns, one
    counted launch (statistics pass and product together)."""
    x = _operand(gen, M, K, xl)
    x.mul_(3).add_(1)                    # in place: keeps the view's offset
    w = torch.randn(K, N, generator=gen, device="cuda")
    scale = torch.randn(K, generator=gen, device="cuda") \
        if "s" in affine else None
    bias = torch.randn(K, generator=gen, device="cuda") \
        if "b" in affine else None
    assert x.is_contiguous()
    assert fl._plan(M, N, _sms()) == tile
    assert copy_width(x, w, scale, bias) == vec
    before = fl.launch_counts()["ln_matmul"]
    got = fl.fused_ln_matmul(x, w, scale, bias)
    assert fl.launch_counts()["ln_matmul"] == before + 1
    want = fl.ln_matmul_reference(x, w, scale, bias)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= ATOL
    assert torch.equal(fl.fused_ln_matmul(x, w, scale, bias), got)


def test_ln_matmul_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x = torch.randn(64, 32, generator=gen, device="cuda")
    w = torch.randn(32, 48, generator=gen, device="cuda")
    s = torch.randn(32, generator=gen, device="cuda")
    before = fl.launch_counts()["ln_matmul"]
    for args, kw in [((x.double(), w.double()), {}), ((x, w.cpu()), {}),
                     ((x.cpu(), w), {}), ((x, w, s.cpu()), {}),
                     ((x, w, s[:16]), {}), ((x.T.contiguous().T, w), {}),
                     ((x, w[:16]), {}), ((x, w), {"block_m": 48})]:
        with pytest.raises(ValueError):
            fl.fused_ln_matmul(*args, **kw)
    assert fl.launch_counts()["ln_matmul"] == before


def test_resnet_trains_through_conv1x1_dw_on_card(gen):
    """A small Bottleneck ResNet: gradients under "pallas" against the
    convolution path (cuDNN, TF32 off), 12 launches per step (c1, c3 and
    the shortcut of four blocks), and two momentum steps that lower the
    loss."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import Bottleneck, ResNet
    torch.backends.cudnn.allow_tf32 = False
    model = ResNet(Bottleneck, [1, 1, 1, 1], 10, generator=gen)
    x = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    y = torch.randint(0, 10, (8,), generator=gen, device="cuda")
    state = {k: v.clone() for k, v in model.named_buffers()}
    grads = {}
    prev = pt.set_conv1x1_impl("conv")
    try:
        for impl in ("conv", "pallas"):
            pt.set_conv1x1_impl(impl)
            for k, v in model.named_buffers():
                v.copy_(state[k])
            model.zero_grad(set_to_none=True)
            pt.softmax_cross_entropy(model(x, train=True), y).mean() \
                .backward()
            grads[impl] = {n: p.grad.clone()
                           for n, p in model.named_parameters()}
        for n, want in grads["conv"].items():
            got = grads["pallas"][n]
            rel = ((got - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
            assert rel <= 1e-3, n
        tr = pt.Trainer(model, lambda out, b: pt.softmax_cross_entropy(
            out, b["y"]), pt.momentum(0.1, 0.9))
        tr.init()
        cc.reset_launch_counts()
        losses = []
        tr.train(lambda: iter([{"x": x, "y": y}] * 3),
                 event_handler=lambda e: losses.append(e.cost)
                 if isinstance(e, pt.train.EndIteration) else None,
                 log_period=0)
        assert cc.launch_counts()["conv1x1_dw"] == 12 * 3
        assert losses[-1] < losses[0]
    finally:
        pt.set_conv1x1_impl(prev)


# -- conv1x1_dw_bf16: bf16 operands, f32 sums (the bfloat16_compute path) --

def _bf16_operand(gen, rows, cols, layout):
    """A contiguous ``[rows, cols]`` bf16 operand on the card: fresh, the
    view ``t[1:]`` of a tensor one row longer, or a view of a flat buffer
    ``k`` values in (``"flat+k"``: its base pointer 2k bytes off the
    buffer's: 2 bytes off 4 for k = 1, 4 off 16 for k = 2, 16-byte aligned
    for k = 8)."""
    if layout == "x[1:]":
        return torch.randn(rows + 1, cols, generator=gen,
                           device="cuda").bfloat16()[1:]
    if layout.startswith("flat+"):
        k = int(layout[5:])
        buf = torch.randn(rows * cols + k, generator=gen,
                          device="cuda").bfloat16()
        return buf[k:].view(rows, cols)
    return torch.randn(rows, cols, generator=gen, device="cuda").bfloat16()


def _check_bf16_dw(x, dy):
    from paddle_tpu_torch.nn import gemm_bf16
    before, routes = cc.launch_counts(), cc.route_counts()
    got = cc.conv1x1_dw(x, dy)
    after = cc.launch_counts()
    assert after["conv1x1_dw_bf16"] == before["conv1x1_dw_bf16"] + 1
    assert after["conv1x1_dw"] == before["conv1x1_dw"]
    route = gemm_bf16.route(gemm_bf16.copy_width(x, dy))
    routes[route] += 1
    assert cc.route_counts() == routes
    want = cc.conv1x1_dw_plain(x, dy)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel_err(got, want) <= ATOL
    assert torch.equal(cc.conv1x1_dw(x, dy), got)      # no atomics


@pytest.mark.parametrize("M,cin,cout", [
    (1, 3, 10), (34, 8, 8), (34, 3, 10), (160, 64, 24), (6144, 10, 3),
    (5000, 130, 70), (100352, 64, 64), (3000, 300, 1000), (0, 8, 16)])
def test_conv1x1_dw_bf16_kernel_matches_plain(gen, M, cin, cout):
    """M off every tile and split size, channels off every copy width:
    within ATOL of the plain version (f32 sums of exact products in
    another order), bit-equal reruns, one counted bf16 launch."""
    _check_bf16_dw(_bf16_operand(gen, M, cin, ""),
                   _bf16_operand(gen, M, cout, ""))


@pytest.mark.parametrize("M,cin,cout,xl,dyl,tile,vec", [
    (3000, 256, 256, "", "", LARGE, 8),
    (2000, 130, 134, "", "", LARGE, 2),
    (2001, 129, 128, "", "", LARGE, 1),
    (1000, 64, 64, "", "", SMALL, 8),
    (777, 6, 70, "", "", SMALL, 2),
    (777, 7, 70, "", "", SMALL, 1),
    (1001, 128, 128, "x[1:]", "x[1:]", LARGE, 8),
    (1001, 6, 64, "x[1:]", "", SMALL, 2),
    (900, 128, 192, "flat+1", "", LARGE, 1),
    (900, 64, 64, "", "flat+1", SMALL, 1)])
def test_conv1x1_dw_bf16_each_tile_and_copy_width(gen, M, cin, cout, xl, dyl,
                                                  tile, vec):
    """Every (tile, copy width) instance: the wgmma route's 16-byte copies
    and the mma.sync route's 4-byte ``cp.async`` and plain 2-byte loads
    that views at an odd element offset and odd channel counts take, M
    off the 32-row and the 64-row k-tile."""
    x = _bf16_operand(gen, M, cin, xl)
    dy = _bf16_operand(gen, M, cout, dyl)
    assert x.is_contiguous() and dy.is_contiguous()
    plan = cc._launch_plan(x, dy, _sms())
    assert (plan[0], plan[2]) == (tile, vec)
    _check_bf16_dw(x, dy)


@pytest.mark.parametrize("route,tile,vec,M,cin,cout,xl,dyl", [
    ("wgmma", LARGE, 8, 401408, 256, 128, "", ""),
    ("wgmma", LARGE, 8, 4097, 136, 200, "", ""),
    ("wgmma", LARGE, 8, 1001, 128, 192, "flat+8", "x[1:]"),
    ("wgmma", SMALL, 8, 401408, 64, 64, "", ""),
    ("wgmma", SMALL, 8, 4099, 72, 56, "", ""),
    ("wgmma", SMALL, 8, 999, 64, 8, "x[1:]", "flat+8"),
    ("mma_sync", LARGE, 2, 401408, 130, 134, "", ""),
    ("mma_sync", LARGE, 2, 2001, 130, 138, "", ""),
    ("mma_sync", LARGE, 2, 1001, 128, 192, "flat+2", ""),
    ("mma_sync", LARGE, 1, 401408, 129, 128, "", ""),
    ("mma_sync", LARGE, 1, 2001, 131, 133, "", ""),
    ("mma_sync", LARGE, 1, 900, 128, 192, "flat+1", ""),
    ("mma_sync", SMALL, 2, 401408, 66, 70, "", ""),
    ("mma_sync", SMALL, 2, 777, 6, 70, "", ""),
    ("mma_sync", SMALL, 2, 1001, 64, 64, "flat+2", ""),
    ("mma_sync", SMALL, 1, 401408, 63, 64, "", ""),
    ("mma_sync", SMALL, 1, 777, 7, 71, "", ""),
    ("mma_sync", SMALL, 1, 900, 64, 64, "", "flat+1")])
def test_conv1x1_dw_bf16_each_route_and_instance(gen, route, tile, vec, M,
                                                 cin, cout, xl, dyl):
    """Each instance of each route at the largest M of a ResNet-50 step
    (401,408 rows), at a ragged M with ragged channel counts, and on a
    view off the allocation (16 bytes for wgmma, 4 or 2 for mma.sync):
    the plan's pick from shapes and pointers, within ATOL of the plain
    version, bit-equal reruns, one launch counted under its route."""
    from paddle_tpu_torch.nn import gemm_bf16
    x = _bf16_operand(gen, M, cin, xl)
    dy = _bf16_operand(gen, M, cout, dyl)
    plan = cc._launch_plan(x, dy, _sms())
    assert (gemm_bf16.route(plan[2]), plan[0], plan[2]) == (route, tile, vec)
    _check_bf16_dw(x, dy)


def test_conv1x1_dw_bf16_wrapper_refuses_mixed_dtypes(gen):
    x = torch.randn(64, 8, generator=gen, device="cuda")
    dy = torch.randn(64, 16, generator=gen, device="cuda")
    before = cc.launch_counts()
    for bad in [(x.bfloat16(), dy), (x, dy.bfloat16()),
                (x.bfloat16(), dy.half()), (x.bfloat16().cpu(), dy.bfloat16()),
                (x.bfloat16(), dy.bfloat16()[:32]),
                (x.bfloat16().T.contiguous().T, dy.bfloat16())]:
        with pytest.raises(ValueError):
            cc.conv1x1_dw(*bad)
    assert cc.launch_counts() == before


def test_policy_product_on_card_matches_cpu(gen):
    """The policy product on the card (cuBLAS, bf16 operands, f32 output;
    the f32 cotangent split into two bf16 halves) against its CPU
    version: the forward to f32 summation order; each gradient, which
    both round to bf16 as JAX's VJP does, to one bf16 ulp plus what the
    split leaves out before that rounding (``g - hi - lo`` is at most
    2^-18 of ``|g|``, and the f32 sums add their own rounding: 2^-15 of
    the sum of the terms' magnitudes, where a sum cancels)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn.policy_dot import policy_dot
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    x = torch.randn(4, 64, 96, generator=gen, device="cuda",
                    requires_grad=True)
    w = torch.randn(96, 80, generator=gen, device="cuda", requires_grad=True)
    gy = torch.randn(4, 64, 80, generator=gen, device="cuda")
    xc = x.detach().cpu().requires_grad_()
    wc = w.detach().cpu().requires_grad_()
    with pt.use_policy(pt.bfloat16_compute):
        y = policy_dot(x, w)
        yc = policy_dot(xc, wc)
    y.backward(gy)
    yc.backward(gy.cpu())
    assert y.dtype == torch.float32
    assert _rel_err(y.cpu(), yc) <= 1e-6
    xb, wb, g = xc.detach().bfloat16().float(), \
        wc.detach().bfloat16().float(), gy.cpu()
    mags = ((x.grad.cpu(), xc.grad, g.abs() @ wb.abs().T),
            (w.grad.cpu(), wc.grad, (xb.abs().reshape(-1, 96).T
                                     @ g.abs().reshape(-1, 80))))
    for got, want, mag in mags:
        assert torch.equal(want, want.bfloat16().float())
        assert ((got - want).abs()
                <= 2 ** -7 * want.abs() + 2 ** -15 * mag).all()


def test_resnet_trains_through_conv1x1_dw_bf16_on_card(gen):
    """A small Bottleneck ResNet under bfloat16_compute and "pallas": 12
    bf16 dW launches a step and no f32 one, f32 parameters, and three
    momentum steps that lower the loss."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import Bottleneck, ResNet
    torch.backends.cudnn.allow_tf32 = False
    model = ResNet(Bottleneck, [1, 1, 1, 1], 10, generator=gen)
    x = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    y = torch.randint(0, 10, (8,), generator=gen, device="cuda")
    prev = pt.set_conv1x1_impl("pallas")
    try:
        tr = pt.Trainer(model, lambda out, b: pt.softmax_cross_entropy(
            out, b["y"]), pt.momentum(0.1, 0.9))
        tr.init()
        cc.reset_launch_counts()
        losses = []
        with pt.use_policy(pt.bfloat16_compute):
            tr.train(lambda: iter([{"x": x, "y": y}] * 3),
                     event_handler=lambda e: losses.append(e.cost)
                     if isinstance(e, pt.train.EndIteration) else None,
                     log_period=0)
        assert cc.launch_counts() == {"conv1x1_dw": 0,
                                      "conv1x1_dw_bf16": 12 * 3}
        assert cc.route_counts() == {"wgmma": 12 * 3, "mma_sync": 0}
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert losses[-1] < losses[0]
    finally:
        pt.set_conv1x1_impl(prev)


# ---------------------------------------------------------------------------
# bf16 operands of the flash kernels and of ln_matmul
# ---------------------------------------------------------------------------

# Outputs rounded to bf16, held in bf16 ulps: every entry within one ulp
# of the tensor's largest |plain| entry, and at most BF16_SHARE of the
# entries above BF16_NOISE of the largest off at all. Kernel and plain
# version sum the same exact bf16 products in f32 in other orders and
# their exponentials differ in the last bits, so a value that straddles a
# rounding boundary (p, ds, y or the output itself) may land one ulp
# apart; an entry near zero then moves by more than its own ulp, never by
# more than one of the largest. Entries under BF16_NOISE of the largest
# are f32 rounding noise: a query row that sees one key has dp - delta = 0
# up to the order of two D-term sums, so its ds and its dq row are noise
# about 1e-8 of the largest dq, different in any two programs (on the
# card, 2-9% of dq at T = 15-96 with segments; none above the floor).
# Measured on the card at T 256-2048: 0.03-0.27% of the entries off; p
# left unrounded puts 13-42% off.
BF16_SHARE = 0.01
BF16_NOISE = 2.0 ** -16


def _bf16_ulp(t):
    """One bf16 ulp of ``t``'s largest |entry|."""
    m = t.float().abs().max().item()
    return 0.0 if m == 0 else 2.0 ** (math.frexp(m)[1] - 8)


def _bf16_gate(got, want):
    assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
    w = want.float()
    d = (got.float() - w).abs()
    assert d.max().item() <= _bf16_ulp(want)
    above = w.abs() > BF16_NOISE * w.abs().max()
    assert ((d > 0) & above).float().mean().item() <= BF16_SHARE


def _flash_bf16_case(gen, B, H, T, D, causal, segs, scale=None, offset=0):
    """Forward and backward of the bf16 kernels against the plain versions
    on the kernels' own O and LSE: one counted launch each, bf16 outputs
    within the gate, the LSE within ATOL, reruns bit-equal."""
    q, k, v, do = (_flat(gen, (B, H, T, D), offset, torch.bfloat16) for _ in range(4))
    seg = _segments(B, T) if segs else None
    if seg is not None:
        do.mul_((seg > 0)[:, None, :, None].bfloat16())
    before, routes = ca.launch_counts(), ca.route_counts("flash_fwd_bf16")
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal, scale)
    route = "wgmma" if q.data_ptr() % 16 == 0 else "mma_sync"
    assert ca.route_counts("flash_fwd_bf16")[route] == routes[route] + 1
    got = ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal, scale)
    after = ca.launch_counts()
    for name in ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                 "flash_bwd_dkv_bf16"):
        assert after[name] == before[name] + 1, name
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name], name
    o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal, scale)
    want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal,
                                        scale)
    torch.cuda.synchronize()
    _bf16_gate(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= ATOL
    for g, w in zip(got, want):
        _bf16_gate(g, w)
    again = ca.flash_attention_fwd(q, k, v, seg, causal, scale)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert all(torch.equal(a, b) for a, b in zip(
        got, ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal,
                                    scale)))
    return q, k, v, do, seg, o, lse


@pytest.mark.parametrize("B,H,T,D,causal,segs,scale", [
    (1, 2, 100, 64, True, False, None),       # T not a tile multiple
    (2, 3, 130, 128, False, True, None),
    (1, 1, 1, 64, False, False, None),        # one token
    # T at the tiles of both plans (16, 32, 64, 128) -1, exactly, +1
    (1, 3, 15, 128, True, True, None), (1, 3, 16, 64, True, False, None),
    (1, 3, 31, 64, False, True, None), (1, 3, 33, 128, True, False, None),
    (2, 2, 63, 64, True, True, None), (2, 2, 64, 128, False, False, None),
    (2, 2, 65, 64, True, True, None), (2, 2, 127, 128, True, False, None),
    (2, 2, 129, 64, False, True, None),
    (1, 2, 96, 64, True, True, -0.2),         # a negative scale
    (1, 2, 64, 128, True, False, 0.3),
    # T = 2048 causal on the small and the large instances
    (1, 2, 2048, 128, True, False, None), (5, 8, 2048, 64, True, False, None),
    (5, 28, 64, 64, True, True, None), (4, 20, 300, 128, True, True, None),
])
def test_flash_bf16_kernels_match_plain(gen, B, H, T, D, causal, segs,
                                        scale):
    _flash_bf16_case(gen, B, H, T, D, causal, segs, scale)


@pytest.mark.parametrize("B,H,T,D,fwd_tile,bwd_tile", [
    (3, 12, 500, 128, 0, 0), (1, 2, 300, 128, 1, 1),
    (4, 17, 500, 64, 0, 0), (1, 3, 97, 64, 1, 1)])
@pytest.mark.parametrize("offset", [0, 2])
def test_flash_bf16_each_tile_and_copy_width(gen, B, H, T, D, fwd_tile,
                                             bwd_tile, offset):
    """Every bf16 instance either plan can pick, with 16-byte copies
    (aligned operands) and 4-byte ones (views 4 bytes off 16), causal with
    segments."""
    bf = torch.bfloat16
    assert ca.flash_fwd_plan(B, H, T, D, True, bf).tile == fwd_tile
    assert ca.flash_bwd_plan(B, H, T, D, True, bf).tile == bwd_tile
    q = _flat(gen, (B, H, T, D), offset, torch.bfloat16)
    assert ca.flash_copy_width(q) == (2 if offset else 8)
    assert ca.flash_fwd_plan(B, H, T, D, True, bf, ca.flash_copy_width(
        q)).route == ("mma_sync" if offset else "wgmma")
    _flash_bf16_case(gen, B, H, T, D, True, True, offset=offset)


@pytest.mark.parametrize("B,H,T,D,causal", [(2, 3, 200, 64, True),
                                             (2, 2, 128, 128, False),
                                             (3, 12, 296, 128, True)])
def test_flash_bf16_stored_ds_reads_no_unwritten_entry(gen, B, H, T, D,
                                                       causal):
    """dk/dv stores its bf16 ds in a buffer of NaN and dq reads it back:
    unwritten entries (skipped tiles) must not reach dq, which must equal
    the recomputing dq bit for bit (both multiply ds rounded to bf16) and
    the whole backward's (on its own delta, ``flash_bwd_delta``). The
    segments run 32 rows each, so that the 64-row tiles of the wgmma
    kernels skip whole tiles, not only the causal cone, and leave entries
    unwritten."""
    bf = torch.bfloat16
    assert ca.flash_bwd_plan(B, H, T, D, causal, bf).stored_ds
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    seg = (torch.arange(T, device="cuda") // 32 + 1).int().expand(
        B, T).contiguous()
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
    delta = ca.flash_bwd_delta(o, do)
    args = (q, k, v, seg, do, lse, delta, causal)
    ds = torch.full((B * H, T, T), float("nan"), device="cuda").bfloat16()
    dk, dv = ca.flash_bwd_dkv(*args, ds=ds)
    dq = ca.flash_bwd_dq(*args, ds=ds)
    alone = ca.flash_bwd_dq(*args)
    want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal)
    torch.cuda.synchronize()
    assert torch.isnan(ds.float()).any()
    for g, w in zip((dq, dk, dv), want):
        assert torch.isfinite(g.float()).all()
        _bf16_gate(g, w)
    _bf16_gate(dq, alone)
    whole = ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(whole, (dq, dk, dv)))


def test_flash_bf16_plans_shared_memory_is_the_kernels(gen):
    """The bf16 plans' shared-memory figures are the kernels' own."""
    from paddle_tpu_torch.utils import cuda_build
    import ctypes
    for src, entry, tiles, smem in (
            ("flash_fwd", "flash_fwd_bf16_smem_bytes", ca._FWD_TILES_BF16,
             ca._fwd_smem),
            ("flash_bwd", "flash_bwd_bf16_smem_bytes", ca._BWD_TILES_BF16,
             ca._bwd_smem)):
        fn = getattr(cuda_build.load(src), entry)
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        for D, ts in tiles.items():
            for i, t in enumerate(ts):
                assert fn(D, i) == smem(D, t, torch.bfloat16)
        assert fn(96, 0) == -1 and fn(128, 2) == -1
    fn = cuda_build.load("flash_fwd").flash_fwd_wgmma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    for D, ts in ca._FWD_TILES_WGMMA.items():
        for i, t in enumerate(ts):
            assert fn(D, i) == ca._fwd_smem(D, t, torch.bfloat16, "wgmma")
    assert fn(96, 0) == -1 and fn(128, 2) == -1
    fn = cuda_build.load("flash_bwd").flash_bwd_wgmma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for D, ts in ca._BWD_TILES_WGMMA.items():
        for i, t in enumerate(ts):
            assert fn(D, i, 0) == ca._bwd_smem(D, t, torch.bfloat16, "wgmma")
            assert fn(D, i, 1) == ca._bwd_ds_smem(D, t)
            plan_t = ca.flash_bwd_plan(1 if i else 64, 8, 512, D, True,
                                       torch.bfloat16)
            assert plan_t.tile == i and (plan_t.smem, plan_t.ds_smem) == (
                fn(D, i, 0), fn(D, i, 1))
    assert fn(96, 0, 0) == -1 and fn(128, 2, 1) == -1
    fn = cuda_build.load("ln_matmul").ln_matmul_wgmma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    for i, t in enumerate(fl.WGMMA_LN):
        for K in (8, 512, t.k_max):
            assert fn(K, i) == fl._ln_wg_smem(t.rows, t.stages, K)
        assert fn(t.k_max + 1, i) == -1
    assert fn(512, 2) == -1


def test_flash_bf16_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 2, 64, 64, generator=gen, device="cuda").bfloat16()
    o, lse = ca.flash_attention_fwd(q, q, q)
    before = ca.launch_counts()
    with pytest.raises(ValueError, match="mixed"):
        ca.flash_attention_fwd(q, q.float(), q)
    with pytest.raises(ValueError, match="mixed"):
        ca.flash_attention_bwd(q, q, q, None, o, lse, o.float())
    with pytest.raises(ValueError, match="mixed"):
        ca.flash_bwd_dq(q, q, q.float(), None, q, lse, lse)
    with pytest.raises(ValueError, match="2 bytes"):
        odd = _flat(gen, (1, 2, 64, 64), 1, torch.bfloat16)
        ca.flash_attention_fwd(odd, q, q)
    with pytest.raises(ValueError, match="dtype"):
        ca.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="dtype"):
        ca.flash_bwd_dkv(q, q, q, None, q, lse.bfloat16(), lse)
    # a stored ds in q's dtype, its rows whole 16-byte pieces
    with pytest.raises(ValueError, match="dtype"):
        ca.flash_bwd_dkv(q, q, q, None, q, lse, lse,
                         ds=torch.empty(2, 64, 64, device="cuda"))
    with pytest.raises(ValueError, match="T % 8"):
        w = torch.randn(1, 2, 60, 64, generator=gen,
                        device="cuda").bfloat16()
        r = torch.zeros(1, 2, 60, device="cuda")
        ca.flash_bwd_dq(w, w, w, None, w, r, r,
                        ds=torch.empty(2, 60, 60, device="cuda").bfloat16())
    after = ca.launch_counts()
    assert after == before


@pytest.mark.parametrize("causal,segs", [(True, False), (True, True),
                                         (False, True)])
def test_flash_bf16_function_gradients_match_plain(gen, causal, segs):
    """bf16 leaves through ``flash_attention`` under autograd: one launch
    of each bf16 kernel, O within the gate of the plain forward, bf16
    gradients within the gate of the plain backward on the O and LSE the
    forward saved."""
    B, H, T, D = 2, 2, 96, 64
    base = [torch.randn(B, H, T, D, generator=gen, device="cuda").bfloat16()
            for _ in range(4)]
    seg = _segments(B, T) if segs else None
    do = base[3] if seg is None else \
        base[3] * (seg > 0)[:, None, :, None].bfloat16()
    q, k, v = (t.clone().requires_grad_() for t in base[:3])
    ca.reset_launch_counts()
    out = ca.flash_attention(q, k, v, seg, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    o, lse = out.grad_fn.saved_tensors[4:6]
    out.backward(do)
    counts = ca.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {
        "flash_fwd_bf16": 1, "flash_bwd_dq_bf16": 1, "flash_bwd_dkv_bf16": 1,
        "flash_bwd_delta_bf16": 1}
    o_ref, _ = ca.flash_attention_plain(*base[:3], seg, causal)
    want = ca.flash_attention_bwd_plain(*base[:3], seg, o, lse, do, causal)
    torch.cuda.synchronize()
    _bf16_gate(out.detach(), o_ref)
    for t, w in zip((q, k, v), want):
        _bf16_gate(t.grad, w)


def _ln_bf16_case(gen, M, K, N, affine, xl="", affine_dtype=torch.bfloat16):
    """``affine_dtype``: scale's and bias's dtype, or a (scale, bias)
    pair of them (the wrapper widens a bf16 one to f32)."""
    sd, bd = affine_dtype if isinstance(affine_dtype, tuple) \
        else (affine_dtype, affine_dtype)
    x = _bf16_operand(gen, M, K, xl)
    x.mul_(3).add_(1)                   # in place: keeps the view's offset
    w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
         ).bfloat16()
    scale = (1 + 0.3 * torch.randn(K, generator=gen, device="cuda")).to(
        sd) if "s" in affine else None
    bias = (0.3 * torch.randn(K, generator=gen, device="cuda")).to(
        bd) if "b" in affine else None
    before = fl.launch_counts()
    got = fl.fused_ln_matmul(x, w, scale, bias)
    after = fl.launch_counts()
    assert after["ln_matmul_bf16"] == before["ln_matmul_bf16"] + 1
    assert after["ln_matmul"] == before["ln_matmul"]
    want = fl.ln_matmul_reference(x, w, scale, bias)
    torch.cuda.synchronize()
    _bf16_gate(got, want)
    assert torch.equal(fl.fused_ln_matmul(x, w, scale, bias), got)
    return x, w


@pytest.mark.parametrize("M,K,N,affine,affine_dtype", [
    (128, 32, 256, "", torch.bfloat16), (128, 32, 256, "sb", torch.bfloat16),
    (128, 64, 256, "sb", torch.float32), (100, 70, 130, "s", torch.float32),
    (3, 5, 7, "b", torch.bfloat16), (1, 1, 1, "", torch.bfloat16),
    (4096, 512, 2048, "sb", torch.bfloat16),
    (300, 72, 200, "sb", (torch.bfloat16, torch.float32)),
    (300, 72, 200, "sb", (torch.float32, torch.bfloat16))])
def test_ln_matmul_bf16_kernel_matches_plain(gen, M, K, N, affine,
                                             affine_dtype):
    _ln_bf16_case(gen, M, K, N, affine, affine_dtype=affine_dtype)


@pytest.mark.parametrize("M,K,N,affine,xl,tile,vec", [
    (4096, 96, 2048, "", "", LARGE, 8),
    (4096, 100, 2048, "sb", "", LARGE, 2),
    (4096, 70, 2048, "sb", "flat+1", LARGE, 1),
    (4096, 64, 2048, "s", "flat+2", LARGE, 2),
    (300, 104, 200, "s", "", SMALL, 8),
    (130, 70, 129, "b", "", SMALL, 1),
    (1025, 64, 96, "sb", "x[1:]", SMALL, 8),
    (257, 64, 96, "sb", "flat+2", SMALL, 2)])
def test_ln_matmul_bf16_each_tile_and_copy_width(gen, M, K, N, affine, xl,
                                                 tile, vec):
    """Every (tile, copy width) instance of the bf16 product: 16-byte,
    4-byte and plain 2-byte copies (odd rows, views 2 bytes off 4)."""
    from paddle_tpu_torch.nn import gemm_bf16
    x, w = _ln_bf16_case(gen, M, K, N, affine, xl)
    assert gemm_bf16.copy_width(x, w) == vec
    plan = fl.ln_bf16_plan(M, K, N, vec, _sms())
    if vec == 8:          # 16-byte copies: the wgmma route, by K
        assert (plan.route, plan.tile) == ("wgmma", 0)
    else:                 # the mma.sync instance of this (tile, width)
        assert (plan.route, plan.tile, plan.vec) == ("mma_sync", tile, vec)
        assert fl._plan(M, N, _sms()) == tile


def test_ln_matmul_bf16_wrapper_refuses_mixed_dtypes(gen):
    x = torch.randn(64, 32, generator=gen, device="cuda")
    w = torch.randn(32, 48, generator=gen, device="cuda")
    s = torch.randn(32, generator=gen, device="cuda")
    before = fl.launch_counts()
    for args in [(x.bfloat16(), w), (x, w.bfloat16()),
                 (x.bfloat16(), w.half()), (x, w, s.bfloat16()),
                 (x.bfloat16(), w.bfloat16(), s.double()),
                 (x.bfloat16(), w.bfloat16(), s.bfloat16().cpu())]:
        with pytest.raises(ValueError):
            fl.fused_ln_matmul(*args)
    assert fl.launch_counts() == before


# ---------------------------------------------------------------------------
# the wgmma routes of flash_fwd_bf16 and ln_matmul_bf16, and the forms of
# csrc/wgmma_bf16.cuh they are built on
# ---------------------------------------------------------------------------

def _bf16_gate_and_control(got, want, control):
    """``got`` within the bf16 gate of ``want``, and ``control`` (the plain
    version with p or y left unrounded) outside it: the gate sees where
    the kernel rounds."""
    _bf16_gate(got, want)
    with pytest.raises(AssertionError):
        _bf16_gate(control, want)


@pytest.mark.parametrize("B,H,T,D,causal,segs", [
    (2, 3, 100, 64, True, False),      # T off the 64-key tiles
    (2, 3, 100, 128, False, True),
    (1, 4, 257, 128, True, True),
    (1, 4, 300, 64, False, False),
    (2, 2, 64, 128, True, False), (2, 2, 65, 64, False, True),
    (3, 12, 500, 128, True, True),     # the 128-row instance
    (4, 17, 500, 64, False, False),
    (1, 2, 2048, 128, True, False),    # the 64-row instance, long
    (8, 4, 1024, 128, True, False)])
def test_flash_fwd_bf16_wgmma_matches_plain(gen, B, H, T, D, causal, segs):
    """16-byte aligned bf16 operands go by the wgmma route (TMA zero-fills
    the rows past T; the masks hold there): O within the bf16 gate of the
    plain version with the unrounded control failing it, the LSE within
    ATOL, a bit-equal rerun, one launch counted on its route."""
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, H, T, D, generator=gen, device="cuda").to(bf)
               for _ in range(3))
    seg = _segments(B, T) if segs else None
    ca.reset_launch_counts()
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
    assert ca.launch_counts()["flash_fwd_bf16"] == 1
    assert ca.route_counts("flash_fwd_bf16") == {"wgmma": 1, "mma_sync": 0}
    plan = ca.flash_fwd_plan(B, H, T, D, causal, bf)
    assert plan.route == "wgmma"
    o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal)
    control = ca.flash_attention_plain(q.float(), k.float(), v.float(), seg,
                                       causal)[0].to(bf)
    torch.cuda.synchronize()
    _bf16_gate_and_control(o, o_ref, control)
    assert (lse - lse_ref).abs().max().item() <= ATOL
    again = ca.flash_attention_fwd(q, k, v, seg, causal)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_bf16_routes_by_alignment(gen, D):
    """Aligned q, k, v go by wgmma; any of them 4 bytes off 16 by mma.sync
    (TMA cannot load it), under the same gate; the launch counter adds one
    per call on either route."""
    bf = torch.bfloat16
    shape = (2, 4, 200, D)
    aligned = [_flat(gen, shape, 0, bf) for _ in range(3)]
    for views, route in (((0, 0, 0), "wgmma"), ((2, 0, 0), "mma_sync"),
                         ((0, 2, 0), "mma_sync"), ((0, 0, 2), "mma_sync"),
                         ((8, 8, 8), "wgmma")):
        q, k, v = (_flat(gen, shape, off, bf) if off else t
                   for off, t in zip(views, aligned))
        ca.reset_launch_counts()
        o, lse = ca.flash_attention_fwd(q, k, v, None, True)
        assert ca.launch_counts()["flash_fwd_bf16"] == 1
        assert ca.route_counts("flash_fwd_bf16")[route] == 1, views
        o_ref, lse_ref = ca.flash_attention_plain(q, k, v, None, True)
        torch.cuda.synchronize()
        _bf16_gate(o, o_ref)
        assert (lse - lse_ref).abs().max().item() <= ATOL


def _bwd_bf16_wgmma_case(gen, B, H, T, D, causal, segs, offset=0):
    """The bf16 backward on operands ``offset`` values past a 16-byte
    boundary: its delta (``flash_bwd_delta_bf16``) within ATOL of the
    plain version relative to the largest |plain|; dk/dv storing ds and
    dq both ways (from the stored ds, recomputing), each within the bf16
    gate of its plain version with the unrounded control failing it,
    bit-equal on a rerun; each launch counted once on the planned
    route."""
    bf = torch.bfloat16
    q, k, v, do = (_flat(gen, (B, H, T, D), offset, bf) for _ in range(4))
    seg = _segments(B, T) if segs else None
    if seg is not None:
        do.mul_((seg > 0)[:, None, :, None].to(bf))
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
    route = "wgmma" if offset % 8 == 0 else "mma_sync"
    plan = ca.flash_bwd_plan(B, H, T, D, causal, bf,
                             ca.flash_copy_width(q, k, v, do))
    assert plan.route == route
    ca.reset_launch_counts()
    delta = ca.flash_bwd_delta(o, do)
    want_delta = ca._delta(o, do)
    args = (q, k, v, seg, do, lse, delta, causal)
    ds = torch.full((B * H, T, T), float("nan"), device="cuda").to(bf) \
        if plan.stored_ds else None
    dk, dv = ca.flash_bwd_dkv(*args, ds=ds)
    dq = ca.flash_bwd_dq(*args, ds=ds)
    alone = ca.flash_bwd_dq(*args)
    assert ca.launch_counts()["flash_bwd_delta_bf16"] == 1
    for name, n in (("flash_bwd_dkv_bf16", 1), ("flash_bwd_dq_bf16", 2)):
        assert ca.route_counts(name) == {route: n, ({"wgmma", "mma_sync"}
                                                     - {route}).pop(): 0}
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal)
    control = ca.flash_attention_bwd_plain(qf, kf, vf, seg, o.float(), lse,
                                           dof, causal)
    torch.cuda.synchronize()
    assert (delta - want_delta).abs().max().item() <= ATOL * max(
        1.0, want_delta.abs().max().item())
    for got, w, c in zip((dq, dk, dv), want, control):
        assert torch.isfinite(got.float()).all()
        _bf16_gate_and_control(got, w, c.to(bf))
    _bf16_gate_and_control(alone, want[0], control[0].to(bf))
    again = ca.flash_bwd_dkv(*args, ds=ds)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(ca.flash_bwd_dq(*args, ds=ds), dq)
    assert torch.equal(ca.flash_bwd_dq(*args), alone)


@pytest.mark.parametrize("B,H,T,D,causal,segs", [
    (2, 3, 100, 64, True, False),      # T off the 64-row tiles, no ds
    (2, 3, 100, 128, False, True),
    (1, 4, 257, 128, True, True),
    (1, 4, 296, 64, False, False),     # T % 8 == 0 off the tiles: ds
    (2, 2, 64, 128, True, False), (2, 2, 65, 64, False, True),
    (3, 12, 500, 128, True, True),     # the 128-row instance
    (3, 12, 504, 128, True, True),     # the same, storing ds
    (4, 17, 496, 64, False, False),
    (1, 2, 2048, 128, True, False),    # the 64-row instance, long
    (8, 4, 1024, 128, True, False)])
def test_flash_bwd_bf16_wgmma_matches_plain(gen, B, H, T, D, causal, segs):
    """16-byte aligned bf16 operands go by the wgmma route (TMA zero-fills
    the rows past T; the masks hold there): dk, dv and dq (from a stored
    ds over NaN and recomputing) within the bf16 gate with the unrounded
    control failing it, bit-equal reruns, launches counted by route."""
    large = ca.flash_bwd_plan(B, H, T, D, causal, torch.bfloat16).tile == 0
    assert large == (B * H * -(-T // 128) >= ca._SMS)
    _bwd_bf16_wgmma_case(gen, B, H, T, D, causal, segs)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("offset", [0, 2, 8])
def test_flash_bwd_bf16_routes_by_alignment(gen, D, offset):
    """Operands on 16-byte boundaries go by wgmma, views 4 bytes off 16 by
    mma.sync on 4-byte copies (TMA cannot load them), under the same gate
    and counts, with segments, causal, T off the tiles and storing ds."""
    _bwd_bf16_wgmma_case(gen, 2, 3, 200, D, True, True, offset)


def test_flash_bwd_delta_bf16_on_views(gen):
    """The delta kernel reads 4 bytes at a time: a view 4 bytes off 16
    and an aligned tensor give the plain version's sums within ATOL."""
    bf = torch.bfloat16
    for D in (64, 128):
        o = _flat(gen, (2, 3, 77, D), 2, bf)
        do = _flat(gen, (2, 3, 77, D), 0, bf)
        got = ca.flash_bwd_delta(o, do)
        want = ca._delta(o, do)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= ATOL * max(
            1.0, want.abs().max().item())


def test_flash_bwd_delta_bf16_refuses_what_it_cannot_read(gen):
    """Called directly, the delta kernel refuses before it launches: a dO
    of another shape (it would read past dO's end), a view 2 bytes off 4
    (a misaligned 4-byte load), a non-contiguous view, f32 operands and a
    head dim the kernel has no instance for."""
    bf = torch.bfloat16
    shape = (1, 2, 64, 64)
    o = _flat(gen, shape, 0, bf)
    do = _flat(gen, shape, 0, bf)
    odd = _flat(gen, shape, 1, bf)
    assert odd.data_ptr() % 4 == 2
    cases = {
        "shorter dO": (o, _flat(gen, (1, 2, 32, 64), 0, bf)),
        "2 bytes off 4": (odd, do),
        "dO 2 bytes off 4": (o, odd),
        "not contiguous": (o, _flat(gen, (1, 2, 64, 64), 0, bf)
                           .transpose(1, 2).contiguous().transpose(1, 2)),
        "f32": (o.float(), do.float()),
        "head dim 32": (_flat(gen, (1, 2, 64, 32), 0, bf),
                        _flat(gen, (1, 2, 64, 32), 0, bf))}
    ca.reset_launch_counts()
    for label, (a, b) in cases.items():
        with pytest.raises(ValueError):
            ca.flash_bwd_delta(a, b)
        assert ca.launch_counts()["flash_bwd_delta_bf16"] == 0, label


@pytest.mark.parametrize("M,K,N,affine,route,tile", [
    (4096, 512, 2048, "sb", "wgmma", 0),
    (4096, 512, 512, "", "wgmma", 0),
    (1000, 640, 296, "s", "wgmma", 0),      # the 128-row strip's last K
    (2048, 1024, 1024, "sb", "wgmma", 1),   # the 64-row strip
    (2048, 1024, 1024, "", "wgmma", 1),
    (700, 1280, 136, "b", "wgmma", 1),
    (1024, 2048, 512, "sb", "mma_sync", 1),  # past both strips
    (300, 72, 200, "sb", "wgmma", 0)])
def test_ln_matmul_bf16_wgmma_matches_plain(gen, M, K, N, affine, route,
                                            tile):
    """16-byte aligned x and w whose rows hold multiples of 8 values: the
    wgmma route while K fits a strip (128 rows up to K 640, 64 rows up to
    1280), else mma.sync on 4-byte copies; within the bf16 gate with the
    unrounded control failing it, a bit-equal rerun, one launch on the
    planned route."""
    from paddle_tpu_torch.nn import gemm_bf16
    bf = torch.bfloat16
    x = (torch.randn(M, K, generator=gen, device="cuda") * 3 + 1).to(bf)
    w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5).to(bf)
    scale = (1 + 0.3 * torch.randn(K, generator=gen, device="cuda")).to(
        bf) if "s" in affine else None
    bias = (0.3 * torch.randn(K, generator=gen, device="cuda")).to(
        bf) if "b" in affine else None
    plan = fl.ln_bf16_plan(M, K, N, gemm_bf16.copy_width(x, w), _sms())
    assert (plan.route, plan.tile) == (route, tile)
    fl.reset_launch_counts()
    got = fl.fused_ln_matmul(x, w, scale, bias)
    assert fl.launch_counts()["ln_matmul_bf16"] == 1
    assert fl.route_counts()[route] == 1
    want = fl.ln_matmul_reference(x, w, scale, bias)
    control = fl.ln_matmul_reference(
        x.float(), w.float(), None if scale is None else scale.float(),
        None if bias is None else bias.float()).to(bf)
    torch.cuda.synchronize()
    _bf16_gate_and_control(got, want, control)
    assert torch.equal(fl.fused_ln_matmul(x, w, scale, bias), got)


def test_ln_matmul_bf16_routes_by_alignment(gen):
    """x or w 4 bytes off 16 goes by mma.sync, aligned ones by wgmma."""
    K, N = 256, 384
    for xl, wl, route in (("", "", "wgmma"), ("flat+2", "", "mma_sync"),
                          ("", "flat+2", "mma_sync"), ("flat+8", "", "wgmma"),
                          ("x[1:]", "", "wgmma")):
        x = _bf16_operand(gen, 500, K, xl)
        w = _bf16_operand(gen, K, N, wl)
        fl.reset_launch_counts()
        got = fl.fused_ln_matmul(x, w)
        assert fl.route_counts()[route] == 1, (xl, wl)
        torch.cuda.synchronize()
        _bf16_gate(got, fl.ln_matmul_reference(x, w))


def _form(name, a, b, N):
    import ctypes
    from paddle_tpu_torch.utils import cuda_build
    fn = getattr(cuda_build.load("wgmma_forms"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d = torch.full((64, N), float("nan"), device="cuda")
    assert fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), N,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return d


@pytest.mark.parametrize("N", [64, 128])
def test_wgmma_kmajor_ss_form_matches_torch_mm(gen, N):
    """``mma_ss<N, 0, 0>`` on two K-major operands through ``desc_k128``
    (k16 steps 32 bytes into the swizzled row): D = A . B^T for A [64, 64]
    and B [N, 64], against ``torch.mm`` in f32 of the same bf16 values
    (exact products; the sums of 64 in another order, truncated by the
    tensor cores: within 1e-5 of the largest entry)."""
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    b = torch.randn(N, 64, generator=gen, device="cuda").bfloat16()
    d = _form("wgmma_ss_kmajor_f32", a, b, N)
    want = a.float() @ b.float().t()
    assert (d - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("N", [64, 128])
def test_wgmma_kmajor_a_mn_b_form_matches_torch_mm(gen, N):
    """``mma_ss<N, 0, 1>``: A [64, 64] K-major from shared memory through
    ``desc_k128`` (ds in the bf16 backward's dq), B [64, N] MN-major
    through ``desc_sw128`` (K there): D = A . B against ``torch.mm`` in
    f32, within 1e-5 of the largest entry."""
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    b = torch.randn(64, N, generator=gen, device="cuda").bfloat16()
    d = _form("wgmma_ss_mn_b_f32", a, b, N)
    want = a.float() @ b.float()
    assert (d - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("N", [64, 128])
def test_wgmma_register_a_form_matches_torch_mm(gen, N):
    """``mma_rs<N, 1>``: A [64, 64] from registers in mma.sync's m16n8k16
    fragment, B [64, N] MN-major through ``desc_sw128``: D = A . B against
    ``torch.mm`` in f32, within 1e-5 of the largest entry."""
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    b = torch.randn(64, N, generator=gen, device="cuda").bfloat16()
    d = _form("wgmma_rs_f32", a, b, N)
    want = a.float() @ b.float()
    assert (d - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# -- the Trainer's host pipeline on the card -------------------------------

def _loop_trainer(**kw):
    import numpy as np
    import paddle_tpu_torch as pt
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = pt.TransformerLM(97, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=128, max_len=128, use_flash=True,
                             device="cuda", generator=gen)
    tr = pt.Trainer(model, lambda out, b: pt.softmax_cross_entropy(
        out.reshape(-1, 97), b["y"].reshape(-1)), pt.adam(1e-3),
        device="cuda", **kw)
    tr.init()
    rng = np.random.RandomState(0)
    batches = [{"x": rng.randint(0, 97, (4, 128)).astype(np.int32),
                "y": rng.randint(0, 97, (4, 128)).astype(np.int32)}
               for _ in range(7)]
    return tr, batches


def test_stager_copies_on_its_stream_from_pinned_buffers(gen):
    import numpy as np
    tr, batches = _loop_trainer(steps_per_call=2, grad_accum=2,
                                pipeline_depth=2)
    tr._copy_stream = torch.cuda.Stream()
    sg = tr._stage_group_work((batches[:4], 0, True))
    assert sg.boundary and sg.crc is not None
    (unit,) = sg.units
    assert unit.event is not None and unit.host
    assert all(h.is_pinned() for h in unit.host)
    unit.event.synchronize()
    for key, t in unit.batches.items():
        assert t.is_cuda and tuple(t.shape[:2]) == (2, 2)
        want = np.stack([b[key] for b in batches[:4]]).reshape(t.shape)
        assert np.array_equal(t.cpu().numpy(), want)
    # the call waits on the copy's event and marks its tensors
    _, m_eff, losses, stats, step, _ = tr._run_staged(0, unit)
    assert m_eff == 2 and step == 2 and losses.shape == (2,)
    assert stats is None                     # no evaluator
    assert torch.isfinite(losses).all()


@pytest.mark.parametrize("K,M", [(1, 1), (3, 1), (2, 2)])
def test_pipeline_depth_bit_identical_on_the_card(gen, K, M):
    runs = []
    for W in (1, 3):
        tr, batches = _loop_trainer(steps_per_call=K, grad_accum=M,
                                    pipeline_depth=W)
        costs = []
        tr.train(lambda: iter(batches), num_passes=2, log_period=0,
                 event_handler=lambda e: costs.append(getattr(e, "cost",
                                                              None)))
        runs.append((costs, [p.detach().clone()
                             for p in tr.model.parameters()],
                     [t.clone() for t in tr.train_state.opt_state.m.values()]
                     + [t.clone()
                        for t in tr.train_state.opt_state.v.values()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        assert torch.equal(a, b)
