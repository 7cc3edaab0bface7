"""The launch plan of ``ln_matmul_bf16`` (``csrc/ln_matmul.cu``) on the
CPU: ``fused_ln.ln_bf16_plan``, a pure function of the shapes, the copy
width and the SM count. 16-byte aligned operands whose rows hold a
multiple of 8 values (copy width 8) take the ``wgmma`` route while ``K``
is within an instance's reach: a block holds a strip of ``x`` rows (all
of ``K``) in shared memory, 128 rows up to ``K`` 640, 64 rows up to 1280
(each strip with four 16 KB stages of ``w`` and its rows' statistics
within the 232,448 bytes a block may use), and walks its share of the
``N`` tiles; past 1280, and for views at a 2- or 4-byte offset,
``mma.sync`` (4-byte copies or plain loads). Checked here: the instances' ``K`` limits against the source's
own sizes, shared memory, the grid covering ``M`` and ``N`` in one wave
where the strips allow, the route and copy width, the route counter.
Pure Python; the card tests hold the kernels themselves."""

import re
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings, strategies as st

from paddle_tpu_torch.nn import fused_ln as fl
from paddle_tpu_torch.nn import gemm_bf16
from paddle_tpu_torch.nn.gemm_f32 import TILES

MAX_SMEM = 232448
SMS = 132
SRC = Path(fl.__file__).resolve().parents[1] / "csrc" / "ln_matmul.cu"


def test_instances_match_the_source_and_reach_their_k():
    src = SRC.read_text()
    inst = {n: (int(r), int(s)) for n, r, s in re.findall(
        r"using (LnLarge|LnSmall) = LnW<(\d+), (\d+)>;", src)}
    assert (inst["LnLarge"], inst["LnSmall"]) == tuple(
        (t.rows, t.stages) for t in fl.WGMMA_LN)
    assert re.search(r"BN = 128, BK = 64, STAGES = STAGES_;", src)
    assert [t.k_max for t in fl.WGMMA_LN] == [640, 1280]
    for t in fl.WGMMA_LN:
        assert t.k_max % 64 == 0
        # with 8 bytes a row of static shared memory (its statistics)
        static = 8 * t.rows
        assert fl._ln_wg_smem(t.rows, t.stages, t.k_max) + static <= MAX_SMEM
        assert fl._ln_wg_smem(t.rows, t.stages, t.k_max + 1) + static \
            > MAX_SMEM
        # the strip's slabs and the stages start on 1024-byte periods
        assert t.rows * 128 % 1024 == 0 and fl._LN_STAGE % 1024 == 0


@pytest.mark.parametrize("M,K,N,tile,rows,splits", [
    (16384, 512, 2048, 0, 128, 1),      # the kernels line: one wave
    (16384, 512, 512, 0, 128, 1),
    (4096, 512, 2048, 0, 128, 4),
    (4096, 1024, 2048, 1, 64, 2),
    (300, 72, 200, 0, 128, 2),
    (1, 8, 8, 0, 128, 1),
    (64, 640, 4096, 0, 128, 32),
    (64, 641, 4096, 1, 64, 32),
    (100000, 1280, 256, 1, 64, 1)])
def test_wgmma_plan(M, K, N, tile, rows, splits):
    plan = fl.ln_bf16_plan(M, K, N, 8, SMS)
    assert plan.route == "wgmma" and plan.vec == 8
    assert (plan.tile, plan.rows, plan.splits) == (tile, rows, splits)
    assert plan.cols == 128
    assert plan.smem == fl._ln_wg_smem(rows, 4, K) <= MAX_SMEM
    assert plan.grid == (splits, -(-M // rows))


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 300000), st.integers(1, 1280), st.integers(1, 20000),
       st.sampled_from([132, 114, 8]))
def test_wgmma_grid_covers_m_and_n_in_one_wave(M, K, N, sms):
    """Strips cover M; N's tiles split into equal shares, every share
    non-empty, no more blocks than one wave unless the strips alone
    exceed it; the plan is a function of its arguments."""
    plan = fl.ln_bf16_plan(M, K, N, 8, sms)
    assert plan.route == "wgmma"
    t = fl.WGMMA_LN[plan.tile]
    assert K <= t.k_max and (plan.tile == 0) == (K <= fl.WGMMA_LN[0].k_max)
    strips = plan.grid[1]
    assert strips * t.rows >= M > (strips - 1) * t.rows
    n_tiles = -(-N // 128)
    assert 1 <= plan.splits <= n_tiles
    shares = [n_tiles * (s + 1) // plan.splits - n_tiles * s // plan.splits
              for s in range(plan.splits)]
    assert sum(shares) == n_tiles and min(shares) >= 1
    assert plan.splits * strips <= max(sms, strips)
    assert plan == fl.ln_bf16_plan(M, K, N, 8, sms)


@pytest.mark.parametrize("M,K,N,width,vec,tile", [
    (16384, 1281, 2048, 8, 2, 0),      # past the strips' reach
    (4096, 2048, 2048, 8, 2, 0),
    (4096, 100, 2048, 2, 2, 0),
    (300, 104, 200, 2, 2, 1),
    (130, 70, 129, 1, 1, 1)])
def test_mma_sync_route(M, K, N, width, vec, tile):
    plan = fl.ln_bf16_plan(M, K, N, width, SMS)
    assert (plan.route, plan.vec, plan.tile) == ("mma_sync", vec, tile)
    t = TILES[tile]
    assert (plan.rows, plan.cols, plan.splits) == (t.rows, t.cols, 1)
    assert plan.grid == (-(-N // t.cols), -(-M // t.rows))
    assert plan.tile == fl._plan(M, N, SMS)


def _bf16(rows, cols, offset=0):
    return torch.zeros(rows * cols + offset, dtype=torch.bfloat16)[
        offset:].view(rows, cols)


@pytest.mark.parametrize("x,w,route", [
    (_bf16(64, 64), _bf16(64, 128), "wgmma"),
    (_bf16(64, 64, 8), _bf16(64, 128), "wgmma"),
    (_bf16(64, 64, 2), _bf16(64, 128), "mma_sync"),
    (_bf16(64, 64), _bf16(64, 128, 4), "mma_sync"),
    (_bf16(64, 70), _bf16(70, 128), "mma_sync"),
    (_bf16(64, 64), _bf16(64, 100), "mma_sync"),
    (_bf16(64, 64, 1), _bf16(64, 128), "mma_sync")])
def test_route_follows_alignment(x, w, route):
    plan = fl.ln_bf16_plan(x.shape[0], x.shape[1], w.shape[1],
                           gemm_bf16.copy_width(x, w), SMS)
    assert plan.route == route


def test_route_counts_start_at_zero_and_reset():
    fl.reset_launch_counts()
    assert fl.route_counts() == {"wgmma": 0, "mma_sync": 0}
    fl._routes["mma_sync"] += 1
    assert fl.route_counts()["mma_sync"] == 1
    fl.reset_launch_counts()
    assert fl.route_counts() == {"wgmma": 0, "mma_sync": 0}
    assert fl.launch_counts() == {"ln_matmul": 0, "ln_matmul_bf16": 0}
