"""The bf16 flash backward's ``wgmma`` route on the CPU: its plan
(``flash_bwd_plan`` at the 16-byte copy width: route by alignment, each
instance's shared memory against its stages, resident rows and ``D``, a
function of the shape alone), the tile walk of its three kernels
(``csrc/flash_bwd.cu``: dk/dv, dq from the stored ds, dq recomputing),
written out here in Python, as a ``hypothesis`` property against the
visibility it must keep, with the stored ds that dq reads on it, and the
kernels' arithmetic written out in numpy (f32 chains over 64 of D and over
each 64-row tile, p and ds rounded to bf16, the scale at the write; the
delta kernel's sum) against JAX's ``_flash_backward`` in interpret mode.

Tolerance of the arithmetic against JAX: the bf16 gate of
``test_torch_bf16_operands.py``, every entry of dq, dk and dv within one
bf16 ulp of the tensor's largest entry, and at most 1% of the entries
above 2^-16 of the largest off at all (the card's gate, chip_smoke.py's
BF16_NOISE): both sum the same exact bf16 products in f32 in other
orders, so a p or ds that straddles a rounding boundary may round to the
neighbouring bf16 value, and a query row that sees one key has dp -
delta = 0 up to the order of two sums, its ds and dq row f32 noise about
1e-8 of the largest dq. The tensor cores' truncating adds cannot be
emulated here; the card tests hold them. delta: within 2^-20 of the
largest |O dO| row sum (f32 sums of D exact products in two orders)."""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu_torch.nn import cuda_attention as ca

BF16 = torch.bfloat16
MAX_SMEM = 232448          # dynamic shared memory a block may opt into
INT_MAX, INT_MIN = 2 ** 31 - 1, -2 ** 31
ULP, OFF_SHARE, NOISE = 2.0 ** -7, 0.01, 2.0 ** -16
BS = 64                    # streamed rows a tile
LOG2E = np.float32(1.4426950408889634)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_instances_fit_their_shared_memory(D):
    """``CfgBW``: 1024 bytes to reach the swizzle's period, the two
    resident ``rows x D`` bf16 matrices, per stage two ``64 x D`` ones and
    1024 bytes of row vectors, for the one-warpgroup instance at D 128
    dk/dv's stash of P (32 floats a consumer thread), ``2 stages + 1``
    mbarriers; dq from the stored ds:
    per stage a ``rows x 64`` ds tile, a K tile and the row vectors, then
    the block's segment ids and ``2 ds_stages`` mbarriers. Every slab and
    stage on a 1024-byte boundary; one block an SM."""
    for t in ca._BWD_TILES_WGMMA[D]:
        consumers = 2 * t.rows                 # 128 threads a warpgroup
        stash = 4 * consumers * 32 if (D, t.rows) == (128, 64) else 0
        smem = ca._bwd_smem(D, t, BF16, "wgmma")
        assert smem == (1024 + 2 * 2 * t.rows * D
                        + t.stages * (2 * 2 * BS * D + 1024) + stash
                        + 8 * (2 * t.stages + 1))
        ds = ca._bwd_ds_smem(D, t)
        assert ds == (1024 + t.ds_stages * (2 * t.rows * BS + 2 * BS * D
                                            + 1024)
                      + 4 * t.rows + 16 * t.ds_stages)
        assert max(smem, ds) <= MAX_SMEM and t.blocks_per_sm == 1
        assert t.rows in (64, 128) and t.stream_rows == BS
        for nbytes in (t.rows * 128, BS * 128, 2 * 2 * BS * D + 1024,
                       2 * t.rows * BS + 2 * BS * D + 1024):
            assert nbytes % 1024 == 0
        assert 2 <= t.stages <= t.ds_stages
    assert ca._bwd_tiles(BF16, "wgmma") is ca._BWD_TILES_WGMMA
    assert ca._bwd_tiles(BF16) is ca._BWD_TILES_BF16


@pytest.mark.parametrize("B,H,T,D", [
    (1, 1, 1, 64), (1, 1, 15, 128), (2, 3, 33, 64), (8, 4, 2048, 128),
    (2, 8, 512, 128), (1, 8, 1024, 64), (3, 3, 1000, 128), (1, 2, 2047, 64),
    (7, 5, 4097, 128), (33, 4, 2048, 128), (4, 20, 300, 128)])
def test_wgmma_plan_covers_t_and_depends_on_the_shape_alone(B, H, T, D):
    """16-byte copies (width 8, the default) take the wgmma route: its
    instance by the wave rule, ``rows / 64`` consumer warpgroups and a
    producer warpgroup, the grid covering T, the stored ds by the
    mma.sync route's rule; a function of the shapes, dtype and width
    alone, causal or not."""
    plan = ca.flash_bwd_plan(B, H, T, D, True, BF16)
    assert plan == ca.flash_bwd_plan(B, H, T, D, True, BF16, 8)
    assert plan == ca.flash_bwd_plan(B, H, T, D, False, BF16, 8)
    assert plan.route == "wgmma"
    t = ca._BWD_TILES_WGMMA[D][plan.tile]
    assert (plan.rows, plan.stream_rows, plan.stages, plan.blocks_per_sm) \
        == (t.rows, t.stream_rows, t.stages, t.blocks_per_sm)
    assert plan.warps == 4 * (plan.rows // 64 + 1)
    assert plan.tiles * plan.rows >= T > (plan.tiles - 1) * plan.rows
    assert plan.grid == B * H * plan.tiles
    assert plan.smem == ca._bwd_smem(D, t, BF16, "wgmma")
    assert plan.ds_smem == ca._bwd_ds_smem(D, t)
    large = ca._BWD_TILES_WGMMA[D][0]
    n_large = B * H * -(-T // large.rows)
    assert plan.tile == (0 if n_large >= ca._SMS else 1)
    assert plan.stored_ds == ca.flash_bwd_plan(B, H, T, D, True, BF16,
                                               2).stored_ds
    assert plan.stored_ds == (T % 8 == 0
                              and 2 * B * H * T * T <= ca._DS_BUDGET)
    # f32 operands have one route, whatever the width
    assert ca.flash_bwd_plan(B, H, T, D, True).route == "mma_sync"
    assert ca.flash_bwd_plan(B, H, T, D, True).ds_smem == 0


@pytest.mark.parametrize("label,shape,tile,grid", [
    ("training", (8, 4, 2048, 128), 0, 512),
    ("segments", (2, 8, 512, 128), 1, 128),
    ("serving", (1, 8, 1024, 64), 1, 128)])
def test_main_path_shapes(label, shape, tile, grid):
    """The training shape takes the large instance (512 blocks of 128
    resident rows), with a stored ds of 256 MiB; the other two would give
    64 large blocks and take the small one (128 blocks of 64 rows)."""
    plan = ca.flash_bwd_plan(*shape, True, BF16)
    assert (plan.route, plan.tile, plan.grid) == ("wgmma", tile, grid), label
    assert plan.stored_ds


def _bf16_at(offset):
    return torch.zeros(64 + offset, dtype=BF16)[offset:]


@pytest.mark.parametrize("offsets,width,route", [
    ((0, 0, 0, 0), 8, "wgmma"), ((2, 0, 0, 0), 2, "mma_sync"),
    ((0, 2, 0, 0), 2, "mma_sync"), ((0, 0, 6, 0), 2, "mma_sync"),
    ((0, 0, 0, 4), 2, "mma_sync"), ((8, 8, 8, 8), 8, "wgmma"),
    ((1, 0, 0, 0), 0, None)])
def test_bwd_route_follows_the_operands_alignment(offsets, width, route):
    """q, k, v and dO all on 16-byte boundaries take wgmma (TMA loads only
    from them); any one of them 4 bytes off (a view) takes mma.sync on
    4-byte copies; 2 bytes off 4 no kernel takes (the wrappers refuse
    it)."""
    ts = [_bf16_at(o) for o in offsets]
    assert ca.flash_copy_width(*ts) == width
    if route is not None:
        plan = ca.flash_bwd_plan(2, 2, 64, 64, True, BF16, width)
        assert plan.route == route
        assert plan.ds_smem == (0 if route == "mma_sync" else
                                ca._bwd_ds_smem(64, ca._BWD_TILES_WGMMA[64]
                                                [plan.tile]))


def test_bwd_route_counts_start_at_zero_and_reset():
    ca.reset_launch_counts()
    for name in ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        assert ca.route_counts(name) == {"wgmma": 0, "mma_sync": 0}
    ca._routes["flash_bwd_dkv_bf16"]["wgmma"] += 2
    assert ca.route_counts("flash_bwd_dkv_bf16")["wgmma"] == 2
    assert ca.route_counts("flash_bwd_dq_bf16")["wgmma"] == 0
    assert ca.route_counts("flash_fwd_bf16") == {"wgmma": 0, "mma_sync": 0}
    ca.reset_launch_counts()
    assert ca.route_counts("flash_bwd_dkv_bf16") == {"wgmma": 0,
                                                     "mma_sync": 0}
    assert ca.launch_counts()["flash_bwd_delta_bf16"] == 0
    assert ca.KERNELS["flash_bwd_delta_bf16"] == "flash_bwd"
    with pytest.raises(KeyError):
        ca.route_counts("flash_bwd_delta_bf16")


# ---------------------------------------------------------------------------
# the tile walk of the wgmma kernels, and the stored ds
# ---------------------------------------------------------------------------

def _seg_range(seg, row0, n, T):
    ids = seg[row0:min(row0 + n, T)]
    return (int(ids.min()), int(ids.max())) if len(ids) else (INT_MAX,
                                                              INT_MIN)


def _meet(a, b):
    return a[0] <= b[1] and a[1] >= b[0] and a[1] > 0 and b[1] > 0


def _walk(kernel, seg, T, causal, rows):
    """``{block: [tiles]}`` that one of the kernels visits, producer and
    consumers alike: dk/dv's blocks own key rows and walk query tiles
    from the one holding their first key under causal masking; dq's (from
    the stored ds or recomputing) own query rows and walk key tiles up to
    the one holding their last row; both skip tiles whose segment ids
    cannot meet the block's (``next_tile``)."""
    n_st = -(-T // BS)
    out = {}
    for blk in range(-(-T // rows)):
        r0 = blk * rows
        if kernel == "dkv":
            first, end = (r0 // BS if causal else 0), n_st
        else:
            first = 0
            end = min((r0 + rows - 1) // BS + 1, n_st) if causal else n_st
        own = None if seg is None else _seg_range(seg, r0, rows, T)
        out[blk] = [t for t in range(first, end) if seg is None
                    or _meet(own, _seg_range(seg, t * BS, BS, T))]
    return out


def _inside(seg, causal, first_key, first_query):
    """A warpgroup's unmasked case: no segments, and under causal masking
    its 64 keys at or before its first query (dk/dv: keys own, queries
    streamed; dq: the reverse)."""
    return seg is None and (not causal or first_key + 63 <= first_query)


def _visible(seg, T, causal):
    vis = np.ones((T, T), bool)
    if causal:
        vis = np.tril(vis)
    if seg is not None:
        vis &= (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    return vis


@st.composite
def _cases(draw):
    T = draw(st.integers(1, 320))
    causal = draw(st.booleans())
    seg = None
    if draw(st.booleans()):
        seg = np.zeros(T, np.int32)
        pos, sid = 0, 1
        tail = draw(st.integers(0, T // 3))              # padding tail
        while pos < T - tail:
            n = draw(st.integers(1, 150))
            seg[pos:min(pos + n, T - tail)] = sid
            pos, sid = pos + n, sid + 1
        if draw(st.booleans()):        # ids in any order, not packed
            seg = np.array(draw(st.permutations(list(seg))), np.int32) \
                if T <= 64 else seg[::-1].copy()
    return T, causal, seg


@settings(max_examples=60, deadline=None)
@given(_cases(), st.sampled_from([64, 128]))
def test_each_kernel_visits_every_visible_pair_once(case, D):
    """Every visible (query, key) pair lies in exactly one (block, tile)
    that each kernel visits, once, with tiles in increasing order; the
    unmasked case only where every pair of the warpgroup's 64 x 64 part
    is visible."""
    T, causal, seg = case
    vis = _visible(seg, T, causal)
    for t in ca._BWD_TILES_WGMMA[D]:
        for kernel in ("dkv", "dq"):
            walk = _walk(kernel, seg, T, causal, t.rows)
            visits = Counter((blk, s) for blk, seq in walk.items()
                             for s in seq)
            assert max(visits.values(), default=1) == 1
            assert all(seq == sorted(seq) for seq in walk.values())
            for q, k in zip(*np.nonzero(vis)):
                own = k if kernel == "dkv" else q
                other = q if kernel == "dkv" else k
                assert visits[own // t.rows, other // BS] == 1
            for blk, seq in walk.items():
                for s in seq:
                    for wg in range(t.rows // 64):
                        r0 = blk * t.rows + 64 * wg
                        rows = slice(r0, min(r0 + 64, T))
                        cols = slice(s * BS, min(s * BS + BS, T))
                        if kernel == "dkv":
                            inside = _inside(seg, causal, r0, s * BS)
                            part = vis[cols, rows]
                        else:
                            inside = _inside(seg, causal, s * BS, r0)
                            part = vis[rows, cols]
                        if inside:
                            assert part.all()


@settings(max_examples=60, deadline=None)
@given(_cases(), st.sampled_from([64, 128]), st.integers(0, 1),
       st.integers(0, 1))
def test_dq_reads_only_what_dkv_wrote(case, D, dkv_tile, dq_tile):
    """The stored ds over a buffer that is not cleared: dk/dv writes
    ds[q][k] of every pair in T of each 64 x 64 part its warpgroups take
    (masked pairs as zeros); dq from it reads each part it takes whole
    where its warpgroup's pairs are all visible, and elsewhere keeps only
    the visible entries (the others are zeroed in shared memory before
    the product; entries past T land as zeros from TMA). So dq never uses
    an entry that dk/dv left unwritten, whichever instance each kernel
    took, and every visible pair's entry is written."""
    T, causal, seg = case
    vis = _visible(seg, T, causal)
    tiles = ca._BWD_TILES_WGMMA[D]
    written = np.zeros((T, T), bool)               # [query, key]
    rows = tiles[dkv_tile].rows
    for blk, seq in _walk("dkv", seg, T, causal, rows).items():
        for s in seq:
            written[s * BS:s * BS + BS, blk * rows:blk * rows + rows] = True
    assert written[vis].all()
    rows = tiles[dq_tile].rows
    for blk, seq in _walk("dq", seg, T, causal, rows).items():
        for s in seq:
            for wg in range(rows // 64):
                r0 = blk * rows + 64 * wg
                part = (slice(r0, min(r0 + 64, T)),
                        slice(s * BS, min(s * BS + BS, T)))
                used = np.ones_like(vis[part]) if _inside(
                    seg, causal, s * BS, r0) else vis[part]
                assert written[part][used].all()


# ---------------------------------------------------------------------------
# the kernels' arithmetic against JAX
# ---------------------------------------------------------------------------

def _bf16(x):
    """float32 rounded to bf16 (to nearest even) and widened back, as
    ``cvt.rn.bf16x2.f32`` rounds p and ds."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16(
    ).float().numpy()


def _chains(a, b, k_axis_len):
    """``a @ b`` over the contraction in chains of 64 (one wgmma chain a
    64-row k-block), each chain's sum exact then rounded to f32, the chains
    added in f32 in order (a fresh partial per k-block)."""
    acc = None
    for c in range(0, k_axis_len, 64):
        part = (a[..., c:c + 64].astype(np.float64)
                @ b[..., c:c + 64, :].astype(np.float64)).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def _delta_model(o, do):
    """``flash_bwd_delta_kernel``'s sum: a warp a row, lane l taking the
    bf16 pairs l, l + 32 (D 128) by FFMA, low value first, then a
    butterfly over the lanes."""
    *lead, D = o.shape
    o2 = o.reshape(-1, D // 64, 32, 2).astype(np.float32)
    d2 = do.reshape(-1, D // 64, 32, 2).astype(np.float32)
    acc = np.zeros(o2.shape[0:1] + (32,), np.float32)
    for w in range(D // 64):
        for e in range(2):
            acc = (acc.astype(np.float64) + o2[:, w, :, e].astype(np.float64)
                   * d2[:, w, :, e]).astype(np.float32)   # exact product
    for off in (16, 8, 4, 2, 1):
        acc = (acc + acc[:, np.arange(32) ^ off]).astype(np.float32)
    return acc[:, 0].reshape(lead)


def _wgmma_backward(q, k, v, do, lse, delta, seg, causal, scale):
    """(dq, dk, dv) as the wgmma kernels form them, over whole tensors
    (their tile order matters only through the chains): s and dp over D
    in chains of 64, p = 2^(s scale log2 e - LSE log2 e), masked pairs 0,
    ds = p (dp - delta) in f32; dv and dk from p and ds rounded to bf16,
    dq from ds rounded to bf16, each over its streamed rows in chains of
    64 (one a tile); the scale at the write; outputs rounded to bf16."""
    T, D = q.shape[2], q.shape[3]
    s = _chains(q, np.swapaxes(k, -1, -2), D)
    dp = _chains(do, np.swapaxes(v, -1, -2), D)
    vis = np.broadcast_to(_visible(None, T, causal), s.shape)
    if seg is not None:
        vis = vis & ((seg[:, :, None] == seg[:, None, :])
                     & (seg[:, :, None] > 0))[:, None]
    mlse = (-lse * LOG2E).astype(np.float32)[..., None]
    x = (s.astype(np.float64) * np.float32(scale * LOG2E)
         + mlse).astype(np.float32)               # one FFMA
    with np.errstate(over="ignore"):       # masked padding rows
        p = np.where(vis, np.exp2(x), np.float32(0)).astype(np.float32)
    ds = (p * (dp - delta[..., None]).astype(np.float32)).astype(np.float32)
    pb, dsb = _bf16(p), _bf16(ds)
    dv = _chains(np.swapaxes(pb, -1, -2), do, T)
    dk = (_chains(np.swapaxes(dsb, -1, -2), q, T) * np.float32(scale))
    dq = (_chains(dsb, k, T) * np.float32(scale))
    return tuple(_bf16(a.astype(np.float32)) for a in (dq, dk, dv))


def _close(got, want):
    w = np.asarray(want, np.float32)
    d = np.abs(got - w)
    top = np.abs(w).max()
    assert d.max() <= ULP * top, (d.max(), top)
    off = ((d > 0) & (np.abs(w) > NOISE * top)).mean()
    assert off <= OFF_SHARE, off


def _packed(B, T):
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        a, c = T // 2 - 8 * b, T - 8 - 4 * b
        seg[b, :a], seg[b, a:c] = 1, 2
    return seg


@pytest.mark.parametrize("shape,causal,with_segments", [
    ((1, 2, 200, 64), True, False), ((2, 2, 130, 128), False, True),
    ((1, 2, 96, 128), True, True)])
def test_wgmma_arithmetic_matches_jax(shape, causal, with_segments):
    """The kernels' sums and rounding points, written out, against JAX's
    ``_flash_backward`` in interpret mode on the same bf16 values, and
    against the port's plain versions (``flash_attention_bwd_plain``), at
    the bf16 gate; the delta kernel's sum against JAX's and the plain
    version's."""
    B, H, T, D = shape
    rng = np.random.RandomState(11)
    q, k, v, do = (_bf16(rng.randn(*shape)) for _ in range(4))
    seg = _packed(B, T) if with_segments else None
    if seg is not None:
        do = do * (seg > 0)[:, None, :, None]
    scale = D ** -0.5
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    jseg = None if seg is None else jnp.asarray(seg)
    out, lse = jpa._flash_forward(*jb[:3], jseg, causal, scale, None, None,
                                  True)
    want = jpa._flash_backward(*jb[:3], jseg, out, lse, jb[3], causal,
                               scale, None, None, True)
    o = np.asarray(out, np.float32)
    lse = np.array(lse, np.float32)
    delta = _delta_model(o, do)
    plain = ca._delta(*(torch.from_numpy(a).bfloat16() for a in (o, do)))
    jdelta = np.asarray(jnp.sum(jb[3].astype(jnp.float32)
                                * out.astype(jnp.float32), axis=-1))
    top = np.abs(o * do).sum(-1).max()
    for other in (plain.numpy(), jdelta):
        assert np.abs(delta - other).max() <= 2.0 ** -20 * top
    got = _wgmma_backward(q, k, v, do, lse, delta, seg, causal, scale)
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v, o, do)]
    ref = ca.flash_attention_bwd_plain(
        *tb[:3], None if seg is None else torch.from_numpy(seg), tb[3],
        torch.from_numpy(lse), tb[4], causal, scale)
    for name, g, w, r in zip("qkv", got, want, ref):
        _close(g, w)
        _close(g, r.float().numpy())
