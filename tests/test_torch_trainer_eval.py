"""The port's ``Trainer(evaluator=...)`` against the JAX Trainer with the
same arguments on bridged weights (CPU): a two-layer MLP on weighted
batches, an ``EvaluatorSet`` of ``ClassificationError`` and
``ColumnSumEvaluator``, two passes (``reset`` at each ``BeginPass``)
with a test reader, at ``steps_per_call`` 1 and 2, ``grad_accum`` 2 and
``pipeline_depth`` 2, over 7 batches so the grouped runs have tails.

Compared: every ``EndIteration``'s metrics (the running result after
that step's updates, one update per microbatch), the ``EndPass``
metrics (the pass's result, ``mean_cost``, the test reader's
``test_*``), and ``evaluate()``'s metrics; atol 1e-5 (counts equal; the
column sums are f32 outputs of steps that agree to 1e-6, summed in other
orders). ``host_fetches`` equals the count of the same run without an
evaluator: the stats ride in the losses' copy.

The JAX Trainer gets a one-device mesh: the test harness forces 8 CPU
devices and would otherwise shard the batch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu import optim as jopt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.core.module import Module
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.train import evaluators as J
from paddle_tpu.train.trainer import Trainer as JTrainer
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.train import evaluators as T

D_IN, HIDDEN, CLASSES, BS, N = 12, 16, 5, 16, 7


class JMLP(Module):
    def __init__(self):
        super().__init__()
        self.hidden = jnn.Linear(HIDDEN, act="relu", name="hidden")
        self.out = jnn.Linear(CLASSES, name="out")

    def forward(self, x, train=False):
        return self.out(self.hidden(x))


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = Linear(D_IN, HIDDEN, act="relu", device="cpu")
        self.out = Linear(HIDDEN, CLASSES, device="cpu")

    def forward(self, x, train=False):
        return self.out(self.hidden(x))


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = rng.randint(0, CLASSES, BS).astype(np.int32)
        label[rng.rand(BS) < 0.1] = -1
        out.append({"x": rng.normal(size=(BS, D_IN)).astype(np.float32),
                    "label": label,
                    "weight": rng.randint(0, 3, BS).astype(np.float32)})
    return out


TRAIN, TEST = _batches(N, 0), _batches(3, 1)


def _evaluator(m):
    return m.EvaluatorSet(m.ClassificationError(), m.ColumnSumEvaluator())


@pytest.fixture(scope="module")
def init_vars():
    v = JMLP().init(jax.random.PRNGKey(0), jnp.asarray(TRAIN[0]["x"]))
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)


def _jax_run(init_vars, **kw):
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JTrainer(JMLP(), lambda o, b: jcosts.softmax_cross_entropy(
        o, b["label"]), jopt.adam(1e-2), mesh=mesh,
        evaluator=_evaluator(J), **kw)
    jt.init(jax.random.PRNGKey(0), TRAIN[0])
    jt.train_state.params = jax.tree_util.tree_map(jnp.asarray,
                                                   init_vars["params"])
    jt.train_state.opt_state = jt.optimizer.init(jt.train_state.params)
    events = []
    jt.train(lambda: iter(TRAIN), num_passes=2, event_handler=events.append,
             test_reader=lambda: iter(TEST), log_period=0)
    return events, jt.evaluate(lambda: iter(TEST))


def _port_run(init_vars, evaluator=True, **kw):
    model = TMLP()
    pt.load_jax_params(model, init_vars)
    tr = pt.Trainer(model, lambda o, b: pt.softmax_cross_entropy(
        o, b["label"]), pt.adam(1e-2), device="cpu",
        evaluator=_evaluator(T) if evaluator else None, **kw)
    tr.init()
    events = []
    tr.train(lambda: iter(TRAIN), num_passes=2, event_handler=events.append,
             test_reader=lambda: iter(TEST), log_period=0)
    return events, tr.evaluate(lambda: iter(TEST)), tr.host_fetches


def _metrics(events, kind):
    return [e.metrics for e in events if type(e).__name__ == kind]


def _same(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("kw", [
    {}, {"steps_per_call": 2}, {"grad_accum": 2},
    {"steps_per_call": 2, "grad_accum": 2, "pipeline_depth": 2},
    {"pipeline_depth": 2}],
    ids=["plain", "K2", "M2", "K2M2W2", "plainW2"])
def test_metrics_match_jax_trainer(init_vars, kw):
    jev, (jcost, jmet) = _jax_run(init_vars, **kw)
    tev, (tcost, tmet), fetches = _port_run(init_vars, **kw)
    steps_j, steps_t = _metrics(jev, "EndIteration"), \
        _metrics(tev, "EndIteration")
    assert len(steps_t) == len(steps_j) > 0
    for got, want in zip(steps_t, steps_j):
        _same(got, want)
    passes_j, passes_t = _metrics(jev, "EndPass"), _metrics(tev, "EndPass")
    assert len(passes_t) == len(passes_j) == 2
    for got, want in zip(passes_t, passes_j):
        _same(got, want)
        assert "classification_error" in got and \
            "test_classification_error" in got and "mean_cost" in got
    _same(tmet, jmet)
    assert abs(tcost - jcost) <= 1e-5
    # the stats leave the device in the losses' copies
    _, _, plain_fetches = _port_run(init_vars, evaluator=False, **kw)
    assert fetches == plain_fetches


def test_pass_metrics_are_the_aggregate_of_the_steps(init_vars):
    """Each pass's metrics are the running result after its last step,
    over that pass's batches alone (``reset`` at ``BeginPass``): the
    evaluator ends the run holding one pass's label count."""
    model = TMLP()
    pt.load_jax_params(model, init_vars)
    ev = T.ClassificationError()
    tr = pt.Trainer(model, lambda o, b: pt.softmax_cross_entropy(
        o, b["label"]), pt.adam(1e-2), device="cpu", evaluator=ev,
        steps_per_call=2, grad_accum=2)
    tr.init()
    events = []
    tr.train(lambda: iter(TRAIN), num_passes=2, event_handler=events.append,
             log_period=0)
    steps, passes = _metrics(events, "EndIteration"), \
        _metrics(events, "EndPass")
    per_pass = len(steps) // 2
    for p in range(2):
        last = steps[(p + 1) * per_pass - 1]
        assert passes[p]["classification_error"] == \
            last["classification_error"]
    assert ev._total == sum(int((b["label"] >= 0).sum()) for b in TRAIN)
    for m in steps:
        assert abs(m["classification_error"] + m["accuracy"] - 1) < 1e-12
