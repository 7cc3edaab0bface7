"""The port's Trainer against the JAX Trainer on bridged weights (f32, CPU):
a TransformerLM of vocab 97, dim 32, 2 layers, 4 heads, T = 32, with the
flash-attention path on both sides (the JAX Pallas kernels in interpret
mode, the port's plain versions through ``FlashAttentionFunction``). The
batches carry masked labels (-1) and per-token weights, so the weighted
mean and the label mask both run.

Tolerances, each with its reason:

- step-0 loss and every parameter's gradient: atol 1e-6 on the loss,
  atol 2e-6 on the gradients (f32, same math summed in other orders);
- parameters after 3 ``sgd`` steps: atol 1e-6 (the update is linear in
  the gradient, so gradient rounding stays at its size);
- parameters after 3 ``adam`` steps: Adam's first updates are nearly
  ``lr * sign(g)``, so an entry whose gradient is near 0 can flip sign on
  a rounding difference. Every entry is held within ``2 * lr * steps``;
  entries whose step-0 gradient has magnitude at least 1e-4 are held to
  atol 1e-6, and the loss curve to atol 1e-6;
- a JAX Adam run continued in the port from its step-2 state (optimizer
  state bridged): atol 1e-6 after the third step.

The JAX Trainer gets a one-device mesh: the test harness forces 8 CPU
devices and would otherwise shard the batch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu import optim as jopt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.train import events as jev
from paddle_tpu.train.trainer import Trainer as JTrainer
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.train import events as tev
from paddle_tpu_torch.train.evaluators import ClassificationError

V, DIM, LAYERS, HEADS, FFN, T, BS = 97, 32, 2, 4, 64, 32, 4
KW = dict(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
          ffn_hidden=FFN, max_len=T, use_flash=True)
STEPS = 3
SGD_LR, ADAM_LR = 0.1, 1e-3


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = rng.randint(0, V, (BS, T)).astype(np.int32)
        y[rng.rand(BS, T) < 0.1] = -1                   # masked labels
        out.append({"x": rng.randint(0, V, (BS, T)).astype(np.int32),
                    "y": y,
                    "weight": rng.randint(0, 3, (BS, T)).astype(np.float32)})
    return out


BATCHES = _batches(STEPS, 0)
TEST_BATCHES = _batches(2, 1)


def _jloss(out, b):
    return jcosts.softmax_cross_entropy(out, b["y"])


def _tloss(out, b):
    return pt.softmax_cross_entropy(out, b["y"])


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def init_vars():
    jm = JTransformerLM(**KW)
    # numpy copies: the JAX Trainer donates the device arrays it is given
    return _copy_tree(jm.init(jax.random.PRNGKey(0),
                              jnp.asarray(BATCHES[0]["x"])))


def _run_jax(init_vars, opt):
    """Train the JAX Trainer for STEPS steps from ``init_vars``; return
    its events, final params, and the state after step 2."""
    tr = JTrainer(JTransformerLM(**KW), _jloss, opt,
                  mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
    tr.init(jax.random.PRNGKey(0), BATCHES[0])
    tr.train_state.params = jax.tree_util.tree_map(jnp.asarray,
                                                   init_vars["params"])
    tr.train_state.opt_state = opt.init(tr.train_state.params)
    events, snap = [], {}

    def handler(e):
        events.append(e)
        if isinstance(e, jev.EndIteration) and e.batch_id == STEPS - 2:
            ts = tr.train_state
            snap.update(params=_copy_tree(ts.params),
                        opt_state=_copy_tree(ts.opt_state),
                        step=int(ts.step))

    tr.train(lambda: iter(BATCHES), event_handler=handler,
             test_reader=lambda: iter(TEST_BATCHES), log_period=0)
    params = _copy_tree(tr.train_state.params)
    return events, params, snap


def _port_model(variables):
    tm = pt.TransformerLM(**KW, device="cpu")
    return pt.load_jax_params(tm, variables)


def _run_port(tm, opt):
    tr = pt.Trainer(tm, _tloss, opt, device="cpu")
    tr.init(BATCHES[0])
    events = []
    tr.train(lambda: iter(BATCHES), event_handler=events.append,
             test_reader=lambda: iter(TEST_BATCHES), log_period=0)
    return tr, events


def _flatten_tree(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_tree(v, prefix + (k,)))
        else:
            out["::".join(prefix + (k,))] = np.asarray(v)
    return out


def _costs(events, kind):
    return [e.cost for e in events if isinstance(e, kind)]


@pytest.fixture(scope="module")
def sgd_runs(init_vars):
    j_events, j_params, _ = _run_jax(init_vars, jopt.sgd(SGD_LR))
    tm = _port_model(init_vars)
    ca.reset_launch_counts()
    tr, t_events = _run_port(tm, pt.sgd(SGD_LR))
    return j_events, j_params, tr, t_events


@pytest.fixture(scope="module")
def adam_runs(init_vars):
    j_events, j_params, snap = _run_jax(init_vars, jopt.adam(ADAM_LR))
    tr, t_events = _run_port(_port_model(init_vars), pt.adam(ADAM_LR))
    return j_events, j_params, snap, tr, t_events


def test_step0_loss_and_every_gradient_match_jax(init_vars):
    jm = JTransformerLM(**KW)
    b = BATCHES[0]

    def loss_of(p):
        out = jm.apply({"params": p}, jnp.asarray(b["x"]), train=True)
        per_ex = _jloss(out, {"y": jnp.asarray(b["y"])})
        w = jnp.asarray(b["weight"])
        return jnp.sum(per_ex * w) / jnp.maximum(jnp.sum(w), 1e-9)

    loss_j, g_j = jax.value_and_grad(loss_of)(init_vars["params"])
    tm = _port_model(init_vars)
    tr = pt.Trainer(tm, _tloss, pt.sgd(0.0), device="cpu")
    tr.init(b)
    loss_t = float(tr.step(tr._to_device(b)))
    np.testing.assert_allclose(loss_t, float(loss_j), atol=1e-6, rtol=0)
    want = _flatten_tree({"params": g_j})
    got = {k: v for k, v in zip(
        pt.export_jax_params(tm),
        (p.grad.numpy() for p in tm.parameters()))}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0,
                                   err_msg=k)
    # the attention projections get their gradient through the flash
    # backward: it is not zero
    assert np.abs(got["params::transformer_lm::block0::attn::wq"]).max() \
        > 1e-4


def test_params_after_three_sgd_steps_match_jax(sgd_runs):
    j_events, j_params, tr, t_events = sgd_runs
    np.testing.assert_allclose(_costs(t_events, tev.EndIteration),
                               _costs(j_events, jev.EndIteration),
                               atol=1e-6, rtol=0)
    want = _flatten_tree({"params": j_params})
    got = pt.export_jax_params(tr.model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert not any(ca.launch_counts().values())


def test_params_after_three_adam_steps_match_jax(adam_runs, init_vars):
    j_events, j_params, _, tr, t_events = adam_runs
    np.testing.assert_allclose(_costs(t_events, tev.EndIteration),
                               _costs(j_events, jev.EndIteration),
                               atol=1e-6, rtol=0)
    jm = JTransformerLM(**KW)
    b = BATCHES[0]

    def loss_of(p):
        out = jm.apply({"params": p}, jnp.asarray(b["x"]), train=True)
        per_ex = _jloss(out, {"y": jnp.asarray(b["y"])})
        w = jnp.asarray(b["weight"])
        return jnp.sum(per_ex * w) / jnp.sum(w)

    g0 = _flatten_tree({"params": jax.grad(loss_of)(init_vars["params"])})
    want = _flatten_tree({"params": j_params})
    got = pt.export_jax_params(tr.model)
    loose = 2 * ADAM_LR * STEPS
    for k in want:
        err = np.abs(got[k] - want[k])
        assert err.max() <= loose, (k, err.max())
        firm = np.abs(g0[k]) >= 1e-4
        assert err[firm].max(initial=0.0) <= 1e-6, (k, err[firm].max())


def test_event_order_and_evaluate_match_jax(sgd_runs):
    j_events, _, tr, t_events = sgd_runs
    assert [type(e).__name__ for e in t_events] == \
        [type(e).__name__ for e in j_events]
    for te, je in zip(t_events, j_events):
        for field in ("pass_id", "batch_id", "step"):
            assert getattr(te, field, None) == getattr(je, field, None)
    t_end, j_end = t_events[-1], j_events[-1]
    assert set(t_end.metrics) == set(j_end.metrics) == {"mean_cost",
                                                        "test_cost"}
    for k in t_end.metrics:
        np.testing.assert_allclose(t_end.metrics[k], j_end.metrics[k],
                                   atol=1e-6, rtol=0)
    cost, metrics = tr.evaluate(lambda: iter(TEST_BATCHES))
    assert cost == t_end.metrics["test_cost"] and metrics == {}
    assert tr.train_state.step == STEPS


def test_adam_state_bridge_round_trip_and_continuation(adam_runs):
    j_events, j_params, snap, _, _ = adam_runs
    tm = _port_model({"params": snap["params"]})
    tr = pt.Trainer(tm, _tloss, pt.adam(ADAM_LR), device="cpu")
    tr.init(BATCHES[0])
    pt.load_jax_opt_state(tr.train_state, snap["opt_state"], snap["step"])
    assert tr.train_state.step == STEPS - 1
    back = pt.export_jax_opt_state(tr.train_state.opt_state)
    assert back._fields == snap["opt_state"]._fields
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(snap["opt_state"])):
        np.testing.assert_array_equal(a, b)
    # continue the JAX run's last step in the port
    loss = float(tr.step(tr._to_device(BATCHES[-1])))
    np.testing.assert_allclose(loss, _costs(j_events, jev.EndIteration)[-1],
                               atol=1e-6, rtol=0)
    want = _flatten_tree({"params": j_params})
    got = pt.export_jax_params(tm)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def test_opt_state_bridge_refuses_a_mismatch(adam_runs):
    _, _, snap, _, _ = adam_runs
    tr = pt.Trainer(_port_model({"params": snap["params"]}), _tloss,
                    pt.sgd(0.1), device="cpu")
    tr.init(BATCHES[0])
    with pytest.raises(ValueError):
        pt.load_jax_opt_state(tr.train_state, snap["opt_state"], 0)
    tr = pt.Trainer(tr.model, _tloss, pt.adam(0.1), device="cpu")
    tr.init(BATCHES[0])
    m = dict(snap["opt_state"].m["transformer_lm"])
    m.pop("ln_f")
    bad = type(snap["opt_state"])({"transformer_lm": m},
                                  snap["opt_state"].v)
    with pytest.raises(ValueError, match="missing"):
        pt.load_jax_opt_state(tr.train_state, bad, 0)


def test_trainer_refuses_knobs_it_does_not_take():
    """The JAX Trainer's multi-GPU arguments raise ``NotImplementedError``
    naming the argument; the observability ones (``telemetry``,
    ``tracer``, ``anomaly``, ``metrics``, ``param_stats_period``) are
    taken, ``anomaly`` only beside ``telemetry``, as JAX's Trainer says;
    ``evaluator`` (ported) is taken; ``donate`` is taken and does nothing;
    ``train`` before ``init`` raises."""
    from paddle_tpu_torch.obs import (AnomalyDetector, MetricsHub,
                                      Telemetry, Tracer)
    tm = pt.TransformerLM(**KW, device="cpu")
    for knob, value in (("mesh", object()), ("param_sharding", object()),
                        ("grad_sync", "bucketed"), ("bucket_mb", 2.0)):
        with pytest.raises(NotImplementedError, match=knob):
            pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu",
                       **{knob: value})
    tel = Telemetry()
    hooks = {"telemetry": tel, "tracer": Tracer(),
             "anomaly": AnomalyDetector("unused"), "metrics": MetricsHub(),
             "param_stats_period": 2}
    tr = pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu", **hooks)
    for knob, value in hooks.items():
        got = tr._param_stats_period if knob == "param_stats_period" \
            else getattr(tr, knob)
        assert got is value, knob
    with pytest.raises(ValueError, match="telemetry"):
        pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu",
                   anomaly=AnomalyDetector("unused"))
    for knob in ("steps_per_call", "grad_accum", "pipeline_depth"):
        with pytest.raises(ValueError):
            pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu", **{knob: 0})
    with pytest.raises(TypeError):
        pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu", checkpoint_dir=2)
    pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu", donate=False)
    ev = ClassificationError()
    assert pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu",
                      evaluator=ev).evaluator is ev
    tr = pt.Trainer(tm, _tloss, pt.sgd(0.1), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        tr.train(lambda: iter(BATCHES))


def test_nan_check_stops_on_a_non_finite_loss():
    tm = pt.TransformerLM(**KW, device="cpu")
    with torch.no_grad():
        tm.ln_f.scale.fill_(float("nan"))
    tr = pt.Trainer(tm, _tloss, pt.sgd(0.1), nan_check=True, device="cpu")
    tr.init(BATCHES[0])
    with pytest.raises(FloatingPointError, match="non-finite loss nan at "
                       "pass 0 batch 0"):
        tr.train(lambda: iter(BATCHES))
