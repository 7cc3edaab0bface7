"""Checkpoints across frameworks (CPU): a directory the JAX ``Trainer``
saves restores in the port's ``Trainer``, and one the port saves
restores in the JAX ``Trainer``, for ``adam``, ``sgd`` and
``chain(clip_by_global_norm, adam)`` on a TransformerLM (vocab 97, dim
32, 2 layers, the flash path; the JAX kernels in interpret mode, the
port's plain versions) and for a ResNet-CIFAR with ``momentum``, whose
BatchNorm statistics cross as the ``state`` collection.

Tolerances, each with its reason:

- a restore is exact: parameters, optimizer state, BatchNorm state and
  step are held bit for bit against what was saved;
- the JAX run's 2 steps, saved, restored in the port and continued one
  step there, against JAX's own 3-step run: atol 1e-6 on the parameters
  and the third loss, as ``test_torch_train.py`` holds one port step
  continued from a JAX state (f32, the same math summed in other
  orders);
- the reverse, a port state saved after one port step from JAX's
  1-step state and continued one step by the JAX Trainer: atol 1e-6
  against JAX's own 3-step run (two steps, each within the above);
- the port resuming JAX's interrupted pass from its mid-pass directory:
  atol 1e-6 on the two losses it trains;
- ResNet-CIFAR: JAX's continuation from the port's re-save is bit-equal
  to its continuation from its own save (the same bytes restore the same
  state).

The JAX Trainer gets a one-device mesh: the test harness forces 8 CPU
devices and would otherwise shard the batch.
"""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paddle_tpu import optim as jopt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.train import checkpoint as jckpt
from paddle_tpu.train import events as jev
from paddle_tpu.train.trainer import Trainer as JTrainer
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.train import checkpoint as ckpt

V, DIM, LAYERS, HEADS, FFN, T, BS = 97, 32, 2, 4, 64, 32, 4
KW = dict(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
          ffn_hidden=FFN, max_len=T, use_flash=True)


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = rng.randint(0, V, (BS, T)).astype(np.int32)
        y[rng.rand(BS, T) < 0.1] = -1
        out.append({"x": rng.randint(0, V, (BS, T)).astype(np.int32),
                    "y": y,
                    "weight": rng.randint(0, 3, (BS, T)).astype(np.float32)})
    return out


BATCHES = _batches(3, 0)

OPTS = {
    "adam": (lambda: jopt.adam(1e-3), lambda: pt.adam(1e-3)),
    "sgd": (lambda: jopt.sgd(0.1), lambda: pt.sgd(0.1)),
    "clip_adam": (lambda: jopt.chain(jopt.clip_by_global_norm(1.0),
                                     jopt.adam(1e-3)),
                  lambda: pt.chain(pt.clip_by_global_norm(1.0),
                                   pt.adam(1e-3))),
}


def _mesh():
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


def _jtrainer(opt):
    tr = JTrainer(JTransformerLM(**KW),
                  lambda out, b: jcosts.softmax_cross_entropy(out, b["y"]),
                  opt, mesh=_mesh())
    tr.init(jax.random.PRNGKey(0), BATCHES[0])
    return tr


def _ptrainer(opt):
    tr = pt.Trainer(pt.TransformerLM(**KW, device="cpu"),
                    lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
                    opt, device="cpu")
    tr.init()
    return tr


def _jtrain(tr, batches):
    costs = []
    tr.train(lambda: iter(batches), log_period=0,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, jev.EndIteration) else None)
    return costs


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module", params=sorted(OPTS))
def runs(request, tmp_path_factory):
    """JAX's 3-step run with ``saving_period=1``; its mid-pass directory
    copied after each step (``after1``, ``after2``: the JAX Trainer's own
    writes, with the iterator position), its costs and final parameters.
    One JAX Trainer per optimizer: each instance compiles its step."""
    jopt_fn, topt_fn = OPTS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    ref = _jtrainer(jopt_fn())
    costs = []

    def handler(e):
        if isinstance(e, jev.EndIteration):
            costs.append(e.cost)
            shutil.copytree(str(root / "jaxrun" / "pass-00000"),
                            str(root / f"after{e.batch_id + 1}"
                                / "pass-00000"))

    ref.train(lambda: iter(BATCHES), checkpoint_dir=str(root / "jaxrun"),
              saving_period=1, log_period=0, event_handler=handler)
    want = {"params": [np.array(x) for x in _leaves(ref.train_state.params)],
            "opt_paths": _paths(ref.train_state.opt_state), "costs": costs}
    return topt_fn, ref, want, root


def test_jax_checkpoint_restores_in_the_port_and_continues(runs):
    topt_fn, _, want, root = runs
    tr = _ptrainer(topt_fn())
    tr.restore(str(root / "after2"))
    assert tr.train_state.step == 2
    loaded = jckpt.load_checkpoint(str(root / "after2"))
    back = pt.checkpoint_tree(tr.train_state)
    for coll in ("params", "opt_state"):
        la, lb = _leaves(back[coll]), _leaves(loaded[coll])
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, b)
    costs = []
    tr.train(lambda: iter(BATCHES[2:]), log_period=0,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, pt.train.EndIteration) else None)
    np.testing.assert_allclose(costs, want["costs"][2:], atol=1e-6, rtol=0)
    got = _leaves(pt.checkpoint_tree(tr.train_state)["params"])
    assert len(got) == len(want["params"])
    for a, b in zip(got, want["params"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_resume_crosses_frameworks_mid_pass(runs):
    """The port resumes the JAX run's pass from its directory after step
    1: the iterator position and the batch fingerprint are read as JAX
    wrote them, and the port finishes the pass."""
    topt_fn, _, want, root = runs
    d = str(root / "resumed")
    shutil.copytree(str(root / "after1"), d)
    tr = _ptrainer(topt_fn())
    costs = []
    tr.train(lambda: iter(BATCHES), checkpoint_dir=d,
             saving_period=1, log_period=0, resume=True,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, pt.train.EndIteration) else None)
    assert tr.train_state.step == 3
    np.testing.assert_allclose(costs, want["costs"][1:], atol=1e-6, rtol=0)
    it = ckpt.load_checkpoint(d)["iter"]
    assert int(it["completed"]) == 1


def test_port_checkpoint_restores_in_jax_and_continues(runs):
    topt_fn, ref, want, root = runs
    tr = _ptrainer(topt_fn())
    tr.restore(str(root / "after1"))
    tr.train(lambda: iter(BATCHES[1:2]), log_period=0)
    tr.save(str(root / "port2"), 0)
    ref.restore(str(root / "port2"))        # the compiled JAX Trainer
    assert int(ref.train_state.step) == 2
    assert _paths(ref.train_state.opt_state) == want["opt_paths"]
    costs = _jtrain(ref, BATCHES[2:])
    np.testing.assert_allclose(costs, want["costs"][2:], atol=1e-6, rtol=0)
    for a, b in zip(_leaves(ref.train_state.params), want["params"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def _images(seed, n=4, size=16):
    rng = np.random.RandomState(seed)
    return {"x": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "label": rng.randint(0, 10, (n,)).astype(np.int32)}


def test_resnet_bn_state_crosses_both_ways(tmp_path):
    imgs = [_images(0), _images(1)]
    jt = JTrainer(jresnet.resnet_cifar(1),
                  lambda out, b: jcosts.softmax_cross_entropy(
                      out, b["label"]),
                  jopt.momentum(0.1, 0.9), mesh=_mesh())
    jt.init(jax.random.PRNGKey(0), imgs[0])
    _jtrain(jt, imgs[:1])
    jt.save(str(tmp_path / "jax"), 0)
    want = jckpt.load_checkpoint(str(tmp_path / "jax"))
    assert jax.tree_util.tree_leaves(want["state"])     # BN statistics
    tr = pt.Trainer(tresnet.resnet_cifar(1, device="cpu"),
                    lambda out, b: pt.softmax_cross_entropy(out, b["label"]),
                    pt.momentum(0.1, 0.9), device="cpu")
    tr.init()
    tr.restore(str(tmp_path / "jax"))
    exported = pt.export_jax_params(tr.model, pt.jax_root(tr.model))
    assert any(k.startswith("state::ResNetCifar_0::") for k in exported)
    tr.save(str(tmp_path / "port"), 0)
    back = jckpt.load_checkpoint(str(tmp_path / "port"))
    for coll in ("params", "state", "opt_state"):
        la, lb = _leaves(back[coll]), _leaves(want[coll])
        assert len(la) == len(lb) > 0
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, b)
    assert int(back["step"]) == int(want["step"]) == 1
    # JAX continues from either directory to the same bits
    outs = []
    for d in ("jax", "port"):
        jt.restore(str(tmp_path / d))
        _jtrain(jt, imgs[1:])
        outs.append(_leaves({"p": jt.train_state.params,
                             "s": jt.train_state.state}))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
