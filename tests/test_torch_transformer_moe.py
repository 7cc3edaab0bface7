"""The port's mixture-of-experts TransformerLM and ``remat`` against the JAX
model on bridged weights (f32, CPU), and MoE serving against the JAX
engine.

- logits, the summed aux loss and every parameter's gradient of ``mean
  CE + 0.01 aux`` (``jax.grad`` against autograd), atol 1e-5 on logits
  and 2e-5 on gradients: the same f32 math through two layers, summed in
  other orders, with identical routing;
- ``remat="dots"``/``"full"`` against plain: losses and gradients within
  1e-5 of each gradient's largest entry (JAX's own
  ``test_transformer_remat_scan_matches_plain`` bound), the flash
  forward run once a block under ``"dots"`` (its outputs saved) and twice
  under ``"full"``; under ``bfloat16_compute`` with the backward taken
  outside the policy (the recompute keeps its forward's policy); JAX's
  remat model on the same weights; the refusals
  (remat with dropout in training, an unknown remat, residual_sharding)
  with JAX's messages;
- served tokens equal to the JAX engine's (greedy, ``speculative=3``,
  ``prefill_chunk=6``, int8 pools) with more requests than slots and
  three slots against four experts, so a tick's capacity is one token an
  expert and routing drops tokens (checked). The JAX engine gets copies
  of its tables and lengths each tick (ROADMAP, Queue 3). Token
  comparisons are exact."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.models.transformer import remat_policy as jremat_policy
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              TransformerLM, bfloat16_compute,
                              load_jax_params, softmax_cross_entropy,
                              use_policy)
from paddle_tpu_torch.models.transformer import remat_policy
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.nn.moe import MoEFFN

V, W, DIM, LAYERS, HEADS, FFN, E = 64, 32, 32, 2, 4, 48, 4
BS = 4
CFG = dict(dim=DIM, num_layers=LAYERS, num_heads=HEADS, ffn_hidden=FFN,
           max_len=W, use_flash=True, moe_experts=E)


def _jmodel(**kw):
    return JTransformerLM(vocab=V, **{**CFG, **kw})


@pytest.fixture(scope="module")
def models():
    jm = _jmodel()
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W), jnp.int32))
    tm = TransformerLM(V, **CFG, device="cpu")
    load_jax_params(tm, vs)
    return jm, vs, tm


def _batch(seed=1, B=2, T=W):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, T)).astype(np.int32),
            rng.randint(0, V, (B, T)).astype(np.int32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _port_loss(tm, ids, tgt):
    logits, aux = tm(torch.from_numpy(ids).long(), train=True,
                     return_aux=True)
    ce = softmax_cross_entropy(logits.reshape(-1, V),
                               torch.from_numpy(tgt).reshape(-1).long())
    return ce.mean() + 0.01 * aux, logits, aux


def _port_grads(tm, ids, tgt):
    tm.zero_grad(set_to_none=True)
    loss, _, _ = _port_loss(tm, ids, tgt)
    loss.backward()
    out = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def test_parameter_tree_is_jax_s(models):
    _, vs, tm = models
    names = {n for n, _ in tm.named_parameters()}
    assert {"blocks.0.ffn.wg", "blocks.0.ffn.w1", "blocks.0.ffn.b1",
            "blocks.0.ffn.w2", "blocks.0.ffn.b2"} <= names
    assert not any("ffn1" in n or "ffn2" in n for n in names)
    (p,) = vs["params"].values()
    assert tuple(tm.blocks[1].ffn.w1.shape) == p["block1"]["ffn"]["w1"].shape
    rm = TransformerLM(V, **CFG, remat="full", device="cpu")
    assert [(n, p.shape) for n, p in rm.named_parameters()] == \
        [(n, p.shape) for n, p in tm.named_parameters()]


def test_logits_aux_and_gradients_match_jax(models):
    jm, vs, tm = models
    ids, tgt = _batch()
    jlogits, jaux = jm.apply(vs, jnp.asarray(ids), return_aux=True)
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(ids).long(), return_aux=True)
    _close(logits, jlogits, 1e-5)
    _close(aux, jaux, 1e-6)
    assert float(aux) > 0                     # summed over the MoE blocks

    from paddle_tpu.nn import costs as jcosts

    def jloss(params):
        lg, ax = jm.apply({"params": params, "state": {}}, jnp.asarray(ids),
                          train=True, return_aux=True)
        ce = jcosts.softmax_cross_entropy(lg.reshape(-1, V),
                                          jnp.asarray(tgt).reshape(-1))
        return jnp.mean(ce) + 0.01 * ax

    jl, jg = jax.value_and_grad(jloss)(vs["params"])
    (jg,) = jg.values()
    loss, grads = _port_grads(tm, ids, tgt)
    assert abs(loss - float(jl)) <= 1e-5
    flat = {".".join(("blocks", k[5:]) if k.startswith("block") else (k,))
            + "." + ".".join(path): v
            for k, sub in jg.items()
            for path, v in _walk(sub)}
    assert set(flat) == set(grads)
    for name, want in flat.items():
        _close(grads[name], want, 2e-5)
    assert float(grads["blocks.0.ffn.wg"].abs().max()) > 0


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture
def count_fwd(monkeypatch):
    calls = [0]
    orig = ca.flash_attention_fwd

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ca, "flash_attention_fwd", counted)
    return calls


@pytest.mark.parametrize("moe", [E, 0])
def test_remat_matches_plain_and_recomputes_as_its_policy_says(
        models, count_fwd, moe):
    _, _, tm = models
    ids, tgt = _batch(2)
    g = torch.Generator().manual_seed(5)
    base = TransformerLM(V, **{**CFG, "moe_experts": moe}, device="cpu",
                         generator=g)
    results, fwd = {}, {}
    for remat in (None, "dots", "full", True):
        m = TransformerLM(V, **{**CFG, "moe_experts": moe}, remat=remat,
                          device="cpu")
        m.load_state_dict(base.state_dict())
        count_fwd[0] = 0
        results[remat] = _port_grads(m, ids, tgt)
        fwd[remat] = count_fwd[0]
    loss0, g0 = results[None]
    for remat in ("dots", "full", True):
        loss, grads = results[remat]
        assert abs(loss - loss0) <= 1e-5 * max(1.0, abs(loss0))
        for n, want in g0.items():
            assert float((grads[n] - want).abs().max()) <= \
                1e-5 * float(want.abs().max()), (remat, n)
    assert fwd[None] == fwd["dots"] == fwd[True] == LAYERS
    assert fwd["full"] == 2 * LAYERS


def test_remat_recomputes_under_the_forward_s_policy():
    """The backward may run where the caller's dtype policy is not
    current (autograd's device thread on the card): a backward taken
    outside ``use_policy(bfloat16_compute)`` must recompute under the
    policy its forward ran under, and give the plain step's gradients."""
    ids, tgt = _batch(4)
    base = TransformerLM(V, **CFG, device="cpu")
    results = {}
    for remat in (None, "dots", "full"):
        m = TransformerLM(V, **CFG, remat=remat, device="cpu")
        m.load_state_dict(base.state_dict())
        with use_policy(bfloat16_compute):
            loss, _, _ = _port_loss(m, ids, tgt)
        loss.backward()                     # outside the policy
        results[remat] = {n: p.grad for n, p in m.named_parameters()}
    for remat in ("dots", "full"):
        for n, want in results[None].items():
            assert float((results[remat][n] - want).abs().max()) <= \
                1e-5 * float(want.abs().max()), (remat, n)


def test_remat_logits_match_jax_remat(models):
    _, vs, tm = models
    ids, _ = _batch(3)
    jr = _jmodel(remat="dots")
    want = jr.apply(vs, jnp.asarray(ids))
    rm = TransformerLM(V, **CFG, remat="dots", device="cpu")
    load_jax_params(rm, vs)
    got = rm(torch.from_numpy(ids).long())           # grad mode: remat runs
    _close(got.detach(), want, 1e-5)


def test_remat_refusals_carry_jax_messages():
    with pytest.raises(ValueError) as jerr:
        jremat_policy("bogus")
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        TransformerLM(V, **CFG, remat="bogus", device="cpu")
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        remat_policy("bogus")
    ids = np.zeros((1, 8), np.int32)
    jd = _jmodel(dropout=0.1, remat="full")
    vs = jd.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    with pytest.raises(AssertionError) as jassert:
        jd.apply(vs, jnp.asarray(ids), train=True,
                 rngs={"dropout": jax.random.PRNGKey(1)})
    td = TransformerLM(V, **CFG, dropout=0.1, remat="full", device="cpu")
    with pytest.raises(ValueError, match=re.escape(str(jassert.value))):
        td(torch.from_numpy(ids).long(), train=True)
    td(torch.from_numpy(ids).long())                 # eval is fine
    with pytest.raises(NotImplementedError):
        TransformerLM(V, **CFG, residual_sharding=lambda x: x, device="cpu")


# ---------------------------------------------------------------------------
# serving the MoE model
# ---------------------------------------------------------------------------

def _jax_tokens(jm, vs, prompts, new, **kw):
    jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=BS,
                         attention="xla", **kw)
    jc = jeng.cache
    jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                jnp.array(np.copy(jc.lengths)))
    js = JScheduler(jeng)
    reqs = [js.submit(list(p), m) for p, m in zip(prompts, new)]
    js.run()
    return [r.tokens for r in reqs]


def _record_drops(tm):
    """Hooks on every MoE layer recording each call's drop rate."""
    drops = []

    def hook(mod, args, out):
        drops.append(float(mod.forward(args[0], return_stats=True)[1]
                           ["drop_rate"]))

    handles = [m.register_forward_hook(hook) for m in tm.modules()
               if isinstance(m, MoEFFN)]
    return drops, handles


MODES = {"greedy": {}, "speculative": {"speculative": 3},
         "chunked": {"prefill_chunk": 6}, "int8": {"kv_dtype": "int8"}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_served_tokens_match_jax_engine_with_drops(models, mode):
    jm, vs, tm = models
    rng = np.random.RandomState(7)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    period = [int(t) for t in rng.randint(0, V, 3)]
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (5, 11, 3)]
    prompts += [pre + [1, 2], period * 4, pre + [5]]
    new = [6, 5, 7, 4, 6, 5]
    kw = MODES[mode]
    want = _jax_tokens(jm, vs, prompts, new, **kw)
    drops, handles = _record_drops(tm)
    try:
        eng = DecodeEngine(tm, max_slots=3, block_size=BS, attention="paged",
                           device="cpu", **kw)
        s = ContinuousBatchingScheduler(eng)
        reqs = [s.submit(list(p), m) for p, m in zip(prompts, new)]
        s.run()
    finally:
        for h in handles:
            h.remove()
    assert [r.tokens for r in reqs] == want
    assert max(drops) > 0                      # routing dropped tokens
    assert eng.compile_counts() == {"prefill": 1, "tick": 1}
