"""The port's schedules, optimizers, softmax cross-entropy and Dropout
against the JAX package's, on the same inputs made with numpy (CPU).

Tolerances: schedules rtol 1e-6 (the JAX ones compute in f32, the port's
in Python floats); optimizers atol 1e-6 on the parameters after 5 steps
fed the same gradients (f32 on both sides, Adam's bias corrections
included); cross-entropy atol 1e-6. Dropout's
mask comes from a torch generator and cannot match JAX's bits, so its
tests check the identity cases, the keep rate and the 1/keep scaling on a
large draw, and determinism under one seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import costs as jcosts
from paddle_tpu.optim import optimizers as jopt
from paddle_tpu.optim import schedules as jsched
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import costs as tcosts
from paddle_tpu_torch.optim import optimizers as topt
from paddle_tpu_torch.optim import schedules as tsched

SCHEDULES = [
    ("constant", (), ()),
    ("poly", (0.1, 0.5), ()),
    ("caffe_poly", (0.0, 2.0, 40), ()),
    ("exponential", (0.5, 10.0), ()),
    ("discexp", (0.5, 7.0), ()),
    ("linear", (0.03, 0.2), ()),
    ("manual", ([5, 20, 33], [1.0, 0.5, 0.25, 0.1]), ()),
    ("warmup_linear", (10,), ()),
    ("cosine_decay", (30, 0.1), ()),
    ("chain", (), ("warmup_linear", (8,), "cosine_decay", (40,))),
]


@pytest.mark.parametrize("name,args,inner", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, args, inner):
    if name == "chain":
        j = jsched.chain(getattr(jsched, inner[0])(*inner[1]),
                         getattr(jsched, inner[2])(*inner[3]))
        t = tsched.chain(getattr(tsched, inner[0])(*inner[1]),
                         getattr(tsched, inner[2])(*inner[3]))
    else:
        j = getattr(jsched, name)(*args)
        t = getattr(tsched, name)(*args)
    for step in range(51):
        got = t(step)
        assert isinstance(got, (int, float))
        np.testing.assert_allclose(got, float(j(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7, err_msg=str(step))


SHAPES = {"w": (7, 5), "b": (5,), "emb": (11, 3)}


def _make(name):
    lr = 0.05
    return {
        "sgd": (jopt.sgd(lr), topt.sgd(lr)),
        "sgd_scheduled": (jopt.sgd(lr, jsched.poly(0.1, 0.5)),
                          topt.sgd(lr, tsched.poly(0.1, 0.5))),
        "momentum": (jopt.momentum(lr), topt.momentum(lr)),
        "nesterov": (jopt.momentum(lr, 0.8, nesterov=True),
                     topt.momentum(lr, 0.8, nesterov=True)),
        "adam": (jopt.adam(lr), topt.adam(lr)),
        "clip_decay_adam": (
            jopt.chain(jopt.clip_by_global_norm(1.0),
                       jopt.weight_decay(1e-2), jopt.adam(lr)),
            topt.chain(topt.clip_by_global_norm(1.0),
                       topt.weight_decay(1e-2), topt.adam(lr))),
    }[name]


@pytest.mark.parametrize("name", ["sgd", "sgd_scheduled", "momentum",
                                  "nesterov", "adam", "clip_decay_adam"])
def test_optimizer_matches_jax_on_the_same_gradients(name):
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    jo, to = _make(name)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = to.init(tp)
    for step, g in enumerate(grads):
        upd, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp, jnp.asarray(step, jnp.int32))
        jp = jopt.apply_updates(jp, upd)
        ts = to.apply({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                      tp, step)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    if name == "adam":
        for slot in ("m", "v"):
            for k in SHAPES:
                got = getattr(ts, slot)[k]
                assert got.dtype == torch.float32
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(getattr(js, slot)[k]),
                    atol=1e-6, rtol=1e-6)


def test_global_norm_and_clip_match_jax():
    rng = np.random.RandomState(1)
    g = {k: (10 * rng.randn(*s)).astype(np.float32)
         for k, s in SHAPES.items()}
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    got = float(topt.global_norm({k: torch.from_numpy(v)
                                  for k, v in g.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    clipped, _ = topt.clip_by_global_norm(2.0).update(
        {k: torch.from_numpy(v) for k, v in g.items()}, (), {}, 0)
    np.testing.assert_allclose(
        float(topt.global_norm(clipped)), 2.0, rtol=1e-6)


def test_softmax_cross_entropy_masks_and_weights_like_jax():
    rng = np.random.RandomState(2)
    logits = (4 * rng.randn(3, 6, 13)).astype(np.float32)
    labels = rng.randint(0, 13, (3, 6)).astype(np.int32)
    labels[0, :2] = -1
    labels[2, 5] = -1
    weight = rng.rand(3, 6).astype(np.float32)
    for w in (None, weight):
        want = np.asarray(jcosts.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if w is None else jnp.asarray(w)))
        got = tcosts.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert (got[labels < 0] == 0).all()
    mask = (labels >= 0).astype(np.float32)
    for how in ("mean", "sum"):
        for m in (None, mask):
            want = float(jcosts.reduce(jnp.asarray(weight),
                                       None if m is None else
                                       jnp.asarray(m), how))
            got = float(tcosts.reduce(torch.from_numpy(weight),
                                      None if m is None else
                                      torch.from_numpy(m), how))
            np.testing.assert_allclose(got, want, rtol=1e-6)
    # the gradient of a masked example is zero
    lt = torch.from_numpy(logits).requires_grad_()
    tcosts.softmax_cross_entropy(lt, torch.from_numpy(labels)).sum() \
        .backward()
    assert not lt.grad[0, :2].any() and lt.grad[1].abs().sum() > 0


def test_dropout_identity_rate_scaling_and_seed():
    x = torch.ones(400, 500)
    d = Dropout(0.3, torch.Generator().manual_seed(0))
    assert d(x) is x and d(x, train=False) is x
    assert Dropout(0.0)(x, train=True) is x
    y = d(x, train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    again = Dropout(0.3, torch.Generator().manual_seed(0))(x, train=True)
    assert torch.equal(y, again)
    assert not torch.equal(y, d(x, train=True))         # the stream moves
    # JAX's inverted dropout has the same keep rate and scaling
    jy = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(0), 0.7,
                                         (400, 500)))
    assert abs(jy.mean() - kept.float().mean().item()) < 0.01


def test_model_dropout_runs_only_in_training():
    import paddle_tpu_torch as pt
    kw = dict(vocab=31, dim=32, num_layers=2, num_heads=2, ffn_hidden=64,
              max_len=16, device="cpu")
    drop = pt.TransformerLM(**kw, dropout=0.2)
    plain = pt.TransformerLM(**kw)
    plain.load_state_dict(drop.state_dict())
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 31, (2, 16)))
    with torch.no_grad():
        want = plain(ids)
        assert torch.equal(drop(ids), want)
        logits, aux = drop(ids, train=True, return_aux=True)
    assert not torch.allclose(logits, want) and float(aux) == 0.0


# The rest of the optimizers and transforms. Each is held against JAX for
# 3 updates on the same parameters and gradients: parameters and every
# state leaf (through export_jax_opt_state, in JAX's tree_leaves order)
# at atol 1e-6 with rtol 1e-6 (f32 on both sides; the port updates its
# state in place, JAX makes new arrays: the same operations, in the same
# order where it matters, with Python-float constants rounded where the
# two frameworks round them).
NEW = {
    "adagrad": (lambda j: j.adagrad(0.05),),
    "decayed_adagrad": (lambda j: j.decayed_adagrad(0.05, rho=0.9),),
    "adadelta": (lambda j: j.adadelta(rho=0.9, lr=0.5),),
    "rmsprop": (lambda j: j.rmsprop(0.01),),
    "rmsprop_momentum": (lambda j: j.rmsprop(0.01, momentum_coef=0.9),),
    "rmsprop_plain": (lambda j: j.rmsprop(0.01, centered=False),),
    "adamax": (lambda j: j.adamax(0.05),),
    "ftrl": (lambda j: j.ftrl(0.1, lambda1=0.05, lambda2=0.01),),
    "lamb": (lambda j: j.lamb(0.01, wd=0.01),),
    "clip_value_l1_adam": (lambda j: j.chain(j.clip_by_value(1.5),
                                             j.l1_decay(1e-3),
                                             j.adam(0.05)),),
    "pruned_momentum": (lambda j: j.static_pruning(j.momentum(0.05), 0.4),),
}


def _run_both(make, steps=3, seed=5):
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    p0["b"][:] = 0.0            # a zero tensor: pruning ties
    grads = [{k: (3 * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    jo, to = make(jopt), make(topt)
    jp = {"m": {k: jnp.asarray(v) for k, v in p0.items()}}
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = to.init(tp)
    for step, g in enumerate(grads):
        upd, js = jo.update({"m": {k: jnp.asarray(v) for k, v in g.items()}},
                            js, jp, jnp.asarray(step, jnp.int32))
        jp = jopt.apply_updates(jp, upd)
        ts = to.apply({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                      tp, step)
    return jp, js, tp, ts


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_optimizer_and_state_match_jax(name):
    from paddle_tpu_torch.utils import bridge
    jp, js, tp, ts = _run_both(NEW[name][0])
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp["m"][k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    exported = bridge.export_jax_opt_state(ts, root="m")
    got = jax.tree_util.tree_leaves(exported)
    want = jax.tree_util.tree_leaves(js)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   atol=1e-6, rtol=1e-6)
    if hasattr(js, "_fields"):
        assert type(ts).__name__ != "tuple" and ts._fields == js._fields

    # the JAX state loads into a fresh port state and exports back equal
    class _TS:
        pass

    holder = _TS()
    holder.opt_state = NEW[name][0](topt).init(
        {k: torch.zeros(s) for k, s in SHAPES.items()})
    bridge.load_jax_opt_state(holder, jax.tree_util.tree_map(np.asarray, js),
                              7)
    assert holder.step == 7
    for a, b in zip(jax.tree_util.tree_leaves(
            bridge.export_jax_opt_state(holder.opt_state, root="m")), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_static_pruning_mask_matches_jax_and_holds_zeros():
    jp, js, tp, ts = _run_both(NEW["pruned_momentum"][0])
    for k, s in SHAPES.items():
        want = np.asarray(js.mask["m"][k])
        np.testing.assert_array_equal(ts.mask[k].numpy(), want)
        n = int(np.prod(s))
        assert (want == 0).sum() == int(0.4 * n)     # exactly k pruned
        assert (tp[k].numpy()[want == 0] == 0).all()   # held at zero
    assert not bool(ts.first) and not bool(js.first)


def test_ema_matches_jax():
    rng = np.random.RandomState(6)
    ps = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
          for _ in range(4)]
    je, te = jopt.polyak_average(0.9), topt.polyak_average(0.9)
    ja = je.init({k: jnp.asarray(v) for k, v in ps[0].items()})
    ta = te.init({k: torch.from_numpy(v) for k, v in ps[0].items()})
    for p in ps[1:]:
        ja = je.update(ja, {k: jnp.asarray(v) for k, v in p.items()})
        ta = te.update(ta, {k: torch.from_numpy(v) for k, v in p.items()})
    for k in SHAPES:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                   atol=1e-6, rtol=1e-6)
