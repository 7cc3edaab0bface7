"""The port's grouped loop (``steps_per_call``, ``grad_accum``) and host
pipeline (``pipeline_depth``) against the JAX Trainer with the same
arguments on bridged weights, and against the port's own serial loop
(CPU).

- A two-layer MLP (16 -> 32 relu -> 8) on weighted batches (zero weights
  included) over 11 batches, so every (K, M) with K in {1, 3} and M in
  {1, 2, 3} has a tail (a short call, a step over fewer than M
  microbatches): losses atol 1e-6, parameters atol 1e-6 after ``adam``
  (f32, the same math summed in other orders; every step starts from
  the same place), and the event sequence (type, pass, batch, step)
  equal.
- A TransformerLM (vocab 97, dim 32, 2 layers, the flash path: JAX's
  kernels in interpret mode, the port's plain versions) at K = 3, M = 2:
  the same gates.
- ``pipeline_depth`` in {1, 2, 3}: bit-identical to the serial loop in
  the port (parameters, optimizer state, costs, events), grouped and
  plain, over two passes with a ragged tail.
- ``saving_period`` saves land on call boundaries at the same
  ``next_batch`` positions as the JAX Trainer's, serial and pipelined.
- ``nan_check``: a non-finite loss in a group skips that group's save
  and raises; the plain loop stays serial with it on.

The JAX Trainer gets a one-device mesh: the test harness forces 8 CPU
devices and would otherwise shard the batch.
"""

import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu import optim as jopt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.core.module import Module
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.train import checkpoint as jckpt
from paddle_tpu.train import events as jev
from paddle_tpu.train.trainer import Trainer as JTrainer
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.train import checkpoint as ckpt

D_IN, HIDDEN, CLASSES, BS, N = 16, 32, 8, 32, 11


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


def _batches(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.normal(size=(BS, D_IN)).astype(np.float32),
             "label": rng.randint(0, CLASSES, BS).astype(np.int32),
             "weight": rng.randint(0, 3, BS).astype(np.float32)}
            for _ in range(n)]


BATCHES = _batches()


def _mesh():
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


def _jloss(out, b):
    return jcosts.softmax_cross_entropy(out, b["label"])


def _tloss(out, b):
    return pt.softmax_cross_entropy(out, b["label"])


def _events(tr_train, batches, **kw):
    events = []
    tr_train(lambda: iter(batches), event_handler=events.append,
             log_period=0, **kw)
    return events


def _sig(events):
    return [(type(e).__name__, getattr(e, "pass_id", None),
             getattr(e, "batch_id", None), getattr(e, "step", None))
            for e in events]


def _costs(events):
    return [e.cost for e in events if hasattr(e, "cost")]


@pytest.fixture(scope="module")
def mlp_init():
    jm = JMLP()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(BATCHES[0]["x"]))
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)


def _port(model, variables, **kw):
    pt.load_jax_params(model, variables)
    tr = pt.Trainer(model, kw.pop("loss", _tloss),
                    kw.pop("opt", None) or pt.adam(1e-3), device="cpu", **kw)
    tr.init()
    return tr


@pytest.mark.parametrize("K,M", [(1, 1), (1, 2), (1, 3), (3, 1), (3, 2),
                                 (3, 3)])
def test_grouped_mlp_matches_jax(mlp_init, K, M):
    jt = JTrainer(JMLP(), _jloss, jopt.adam(1e-3), mesh=_mesh(),
                  steps_per_call=K, grad_accum=M)
    jt.init(jax.random.PRNGKey(0), BATCHES[0])
    jt.train_state.params = jax.tree_util.tree_map(jnp.asarray,
                                                   mlp_init["params"])
    jt.train_state.opt_state = jt.optimizer.init(jt.train_state.params)
    je = _events(jt.train, BATCHES)
    tr = _port(TMLP(), mlp_init, steps_per_call=K, grad_accum=M)
    te = _events(tr.train, BATCHES)
    assert _sig(te) == _sig(je)
    np.testing.assert_allclose(_costs(te), _costs(je), atol=1e-6, rtol=0)
    want = pt.checkpoint_tree(tr.train_state, pt.jax_root(tr.model))
    for a, b in zip(jax.tree_util.tree_leaves(want["params"]),
                    jax.tree_util.tree_leaves(jt.train_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    assert tr.train_state.step == int(jt.train_state.step)
    # one loss fetch a call: K steps of M batches, tails split by M
    calls = sum(len(jt._plan_group(len(g), M)) for g in
                [BATCHES[i:i + K * M] for i in range(0, N, K * M)])
    assert tr.host_fetches == calls


def test_grouped_transformer_matches_jax():
    V, T = 97, 32
    kw = dict(vocab=V, dim=32, num_layers=2, num_heads=4, ffn_hidden=64,
              max_len=T, use_flash=True)
    rng = np.random.RandomState(1)
    batches = [{"x": rng.randint(0, V, (4, T)).astype(np.int32),
                "y": rng.randint(0, V, (4, T)).astype(np.int32),
                "weight": rng.randint(0, 3, (4, T)).astype(np.float32)}
               for _ in range(7)]
    jm = JTransformerLM(**kw)
    init = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["x"])))

    def jl(out, b):
        return jcosts.softmax_cross_entropy(out, b["y"])

    jt = JTrainer(jm, jl, jopt.sgd(0.1), mesh=_mesh(), steps_per_call=3,
                  grad_accum=2)
    jt.init(jax.random.PRNGKey(0), batches[0])
    jt.train_state.params = jax.tree_util.tree_map(jnp.asarray,
                                                   init["params"])
    je = _events(jt.train, batches)
    tr = _port(pt.TransformerLM(**kw, device="cpu"), init,
               loss=lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
               opt=pt.sgd(0.1), steps_per_call=3, grad_accum=2)
    te = _events(tr.train, batches)
    assert _sig(te) == _sig(je)
    np.testing.assert_allclose(_costs(te), _costs(je), atol=1e-6, rtol=0)
    got = pt.checkpoint_tree(tr.train_state)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jt.train_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def _port_run(mlp_init, batches, num_passes=1, **kw):
    train_kw = {k: kw.pop(k) for k in ("checkpoint_dir", "saving_period")
                if k in kw}
    tr = _port(TMLP(), mlp_init, **kw)
    events = _events(tr.train, batches, num_passes=num_passes, **train_kw)
    return tr, events


def _state_equal(a, b):
    ta = pt.checkpoint_tree(a.train_state)
    tb = pt.checkpoint_tree(b.train_state)
    for x, y in zip(jax.tree_util.tree_leaves(ta),
                    jax.tree_util.tree_leaves(tb)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("K,M", [(1, 1), (3, 1), (2, 2)])
@pytest.mark.parametrize("W", [2, 3])
def test_pipeline_depth_is_bit_identical_to_serial(mlp_init, K, M, W):
    serial, e1 = _port_run(mlp_init, BATCHES, num_passes=2,
                           steps_per_call=K, grad_accum=M)
    piped, e2 = _port_run(mlp_init, BATCHES, num_passes=2,
                          steps_per_call=K, grad_accum=M, pipeline_depth=W)
    assert e1 == e2             # events are dataclasses: order and fields
    _state_equal(serial, piped)
    assert piped.host_fetches == serial.host_fetches
    if K > 1:
        # one fetch a call, not one a step
        assert serial.host_fetches < serial.train_state.step


def _record_saves(monkeypatch, module):
    saved = []
    real = module.save_checkpoint

    def recording(root, pass_id, tree, **kw):
        it = tree.get("iter", {})
        saved.append((pass_id, int(it.get("next_batch", -1)),
                      int(it.get("completed", -1))))
        return real(root, pass_id, tree, **kw)

    monkeypatch.setattr(module, "save_checkpoint", recording)
    return saved


def test_mid_pass_saves_land_on_call_boundaries(mlp_init, tmp_path,
                                                monkeypatch):
    j_saved = _record_saves(monkeypatch, jckpt)
    t_saved = _record_saves(monkeypatch, ckpt)
    jt = JTrainer(JMLP(), _jloss, jopt.adam(1e-3), mesh=_mesh(),
                  steps_per_call=3)
    jt.init(jax.random.PRNGKey(0), BATCHES[0])
    jt.train(lambda: iter(BATCHES), checkpoint_dir=str(tmp_path / "jax"),
             saving_period=4, log_period=0)
    for W in (1, 2):
        t_saved.clear()
        _port_run(mlp_init, BATCHES, steps_per_call=3, pipeline_depth=W,
                  checkpoint_dir=str(tmp_path / f"port{W}"),
                  saving_period=4)
        # groups end at 3, 6, 9, 11: saves at 6 and 9, then the pass end
        assert t_saved == j_saved == [(0, 6, 0), (0, 9, 0), (0, 0, 1)]


def test_nan_check_skips_the_poisoned_save(mlp_init, tmp_path):
    batches = _batches(8)
    batches[5]["x"][:] = np.nan          # poisons the second group
    for W in (1, 2):
        tr = _port(TMLP(), mlp_init, steps_per_call=2, grad_accum=2,
                   nan_check=True, pipeline_depth=W)
        d = str(tmp_path / f"w{W}")
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            tr.train(lambda: iter(batches), log_period=0, checkpoint_dir=d,
                     saving_period=8)
        # the batch-8 boundary covered the poisoned group: no save
        assert ckpt.latest_pass(d) is None


def test_plain_nan_check_stays_serial_and_raises(mlp_init):
    batches = _batches(4)
    batches[2]["x"][:] = np.nan
    tr = _port(TMLP(), mlp_init, nan_check=True, pipeline_depth=4)
    with pytest.raises(FloatingPointError, match="batch 2"):
        tr.train(lambda: iter(batches), log_period=0)
    assert tr.train_state.step == 3      # raised before the next step


def test_stager_thread_closed_on_a_raising_handler(mlp_init):
    tr = _port(TMLP(), mlp_init, steps_per_call=2, pipeline_depth=2)

    class Boom(Exception):
        pass

    def handler(e):
        if isinstance(e, pt.train.EndIteration) and e.batch_id == 3:
            raise Boom()

    with pytest.raises(Boom):
        tr.train(lambda: iter(BATCHES), event_handler=handler, log_period=0)
    names = [t.name for t in threading.enumerate()]
    assert not any("host_pipeline.stager" in n for n in names), names


def test_dropout_draws_follow_the_step():
    """Dropout's generators are re-seeded from (seed, step[, microbatch])
    before each step, so a run split in two (here: a second ``train``
    call on a fresh model loaded with the first half's state) draws the
    masks of the run in one piece."""
    kw = dict(vocab=31, dim=32, num_layers=2, num_heads=2, ffn_hidden=64,
              max_len=16, dropout=0.3, device="cpu")
    rng = np.random.RandomState(4)
    batches = [{"x": rng.randint(0, 31, (2, 16)).astype(np.int32),
                "y": rng.randint(0, 31, (2, 16)).astype(np.int32)}
               for _ in range(4)]

    def loss(out, b):
        return pt.softmax_cross_entropy(out, b["y"])

    def trainer(model, M=1):
        tr = pt.Trainer(model, loss, pt.adam(1e-3), device="cpu",
                        grad_accum=M)
        tr.init()
        return tr

    whole = trainer(pt.TransformerLM(**kw))
    whole.train(lambda: iter(batches), log_period=0, rng=3)
    first = trainer(pt.TransformerLM(**kw))
    first.train(lambda: iter(batches[:2]), log_period=0, rng=3)
    second = trainer(pt.TransformerLM(**kw))
    second.train_state.step = 0
    second.model.load_state_dict(first.model.state_dict())
    pt.load_jax_opt_state(second.train_state,
                          pt.export_jax_opt_state(first.train_state.opt_state),
                          first.train_state.step)
    # the second half alone, as a resumed pass skips the first half
    second.train(lambda: iter(batches[2:]), log_period=0, rng=3)
    _state_equal(whole, second)
    other = trainer(pt.TransformerLM(**kw))
    other.train(lambda: iter(batches), log_period=0, rng=4)
    assert not torch.equal(other.model.emb.w, whole.model.emb.w)
