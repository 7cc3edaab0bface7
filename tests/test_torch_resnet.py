"""The port's ResNets against the JAX package's (f32, CPU), on numpy inputs
from a seed and bridged weights and BatchNorm state:

- logits of ``ResNet(Bottleneck, [1, 1, 1, 1], 10)`` and
  ``resnet_cifar(1)`` at 32 x 32, batch 4, with ``train=False`` and with
  ``train=True`` (and the running statistics that training writes);
- ``resnet50(1000)``'s parameter count against the JAX model's;
- the bridge both ways for parameters and state, and its refusals;
- a strided, widening ``Bottleneck`` in training under ``"pallas"`` and
  ``"conv"``: output and every gradient;
- 3 ``Trainer`` steps of ``resnet_cifar(1)`` with ``momentum(0.1, 0.9)``
  under ``set_conv1x1_impl("pallas")`` on both sides (the JAX
  ``dw_pallas`` in interpret mode, the port's plain ``conv1x1_dw`` for
  the two strided shortcuts) on a conflicting-pairs batch, from the real
  initialisation. Each step starts the port from the JAX Trainer's
  parameters, BatchNorm state and velocity before it; the step's loss,
  parameters, BatchNorm state and velocity are then held against the
  JAX step's. The two frameworks' forwards differ in the last bits, so a
  ReLU input within that of 0 may take mask 1 on one side and 0 on the
  other, which moves a whole sum-type gradient (a BN shift's, a conv
  weight's) by that element's share, a few percent at this size. The
  test therefore asserts that every ReLU input of the port's three
  steps lies at least ``TIE`` from 0; ``INIT_KEY`` is an initialisation
  for which that holds (keys 1, 3, 4 and 6 put a ReLU input within 1e-6
  of 0 at the first step, key 7 at the third).

Tolerance: 1e-4 relative to each tensor's largest entry (f32; the two
frameworks sum in other orders). The 1x1-conv lowering is
process-global on both sides (other tests share the worker), so each test
sets it and restores it in ``finally``. The JAX Trainer gets a one-device
mesh: the test harness forces 8 CPU devices and would otherwise shard the
batch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu import optim as jopt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.nn.layers import set_conv1x1_impl as jset_impl
from paddle_tpu.serve.replica_proc import save_variables_npz
from paddle_tpu.train import events as jev
from paddle_tpu.train.trainer import Trainer as JTrainer
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as tresnet

RTOL = 1e-4


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    lim = RTOL * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= lim, f"{what}: max |port - jax| = {err} > {lim}"


def _images(seed, n=4, size=32):
    return np.random.RandomState(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


MODELS = {
    "bottleneck": (lambda: jresnet.ResNet(jresnet.Bottleneck, [1, 1, 1, 1],
                                          10),
                   lambda: tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1],
                                          10, device="cpu"),
                   "ResNet_0"),
    "cifar": (lambda: jresnet.resnet_cifar(1),
              lambda: tresnet.resnet_cifar(1, device="cpu"),
              "ResNetCifar_0"),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def bridged(request):
    jfn, tfn, root = MODELS[request.param]
    jm = jfn()
    variables = _copy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(_images(0))))
    # non-trivial running statistics, so eval reads them
    rng = np.random.RandomState(3)
    variables["state"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.rand(*a.shape)).astype(np.float32),
        variables["state"])
    return jm, variables, pt.load_jax_params(tfn(), variables), root, tfn


@pytest.mark.parametrize("train", [False, True])
def test_logits_and_state_match_jax(bridged, train):
    jm, variables, tm, _, _ = bridged
    x = _images(1)
    tm = pt.load_jax_params(tm, variables)       # fresh state each case
    if train:
        want, new = jax.jit(lambda v, xx: jm.apply(
            v, xx, train=True, mutable=("state",)))(variables, jnp.asarray(x))
    else:
        want, new = jax.jit(jm.apply)(variables, jnp.asarray(x)), variables
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train)
    _close(got.numpy(), want, "logits")
    flat = pt.export_jax_params(tm, root="x")
    for path, a in jax.tree_util.tree_flatten_with_path(new["state"])[0]:
        key = "::".join(["state", "x"] + [p.key for p in path[1:]])
        _close(flat[key], a, key)


def test_resnet50_parameter_count():
    n_port = sum(p.numel() for p in tresnet.resnet50(1000, device="cpu")
                 .parameters())
    shapes = jax.eval_shape(jresnet.resnet50(1000).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 32, 32, 3),
                                                 jnp.float32))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_port == n_jax == 25_557_032
    assert sum(p.numel() for p in tresnet.resnet50(10, device="cpu")
               .parameters()) == 23_528_522


def test_bridge_round_trip_and_refusals(bridged, tmp_path):
    jm, variables, tm, root, tfn = bridged
    tm = pt.load_jax_params(tm, variables)
    path = save_variables_npz(str(tmp_path / "w.npz"), variables)
    with np.load(path) as f:
        flat = dict(f)
    back = pt.export_jax_params(tm, root=root)
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    other = pt.load_jax_params(tfn(), flat)
    for (name, a), b in zip(tm.state_dict().items(),
                            other.state_dict().values()):
        assert torch.equal(a, b), name
    key = f"state::{root}::stem::bn::mean"
    with pytest.raises(ValueError, match="missing"):
        pt.load_jax_params(other, {k: v for k, v in flat.items()
                                   if k != key})
    with pytest.raises(ValueError, match="extra"):
        pt.load_jax_params(other, {**flat, f"state::{root}::fc::mean":
                                   flat[key]})
    with pytest.raises(ValueError, match="shape"):
        pt.load_jax_params(other, {**flat, key: np.zeros(3, np.float32)})


@pytest.mark.parametrize("impl", ["pallas", "conv"])
def test_strided_bottleneck_gradients_match_jax(impl):
    """The last stage's first block (stride 2, widening shortcut) in
    training, under each lowering: output and every gradient."""
    rs = np.random.RandomState(6)
    x = rs.normal(size=(8, 4, 4, 256)).astype(np.float32)
    jb = jresnet.Bottleneck(128, stride=2, name="b")
    variables = _copy_tree(jax.jit(jb.init)(jax.random.PRNGKey(2),
                                            jnp.asarray(x)))
    dy = rs.normal(size=(8, 2, 2, 512)).astype(np.float32)
    prev_j, prev_t = jset_impl(impl), pt.set_conv1x1_impl(impl)
    try:
        def f(p, xx):
            out, _ = jb.apply({"params": p, "state": variables["state"]},
                              xx, train=True, mutable=("state",))
            return jnp.sum(out * dy), out
        (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(variables["params"],
                                              jnp.asarray(x))
        tb = pt.load_jax_params(tresnet.Bottleneck(256, 128, stride=2,
                                                   device="cpu"), variables)
        xt = torch.from_numpy(x).requires_grad_()
        y = tb(xt, train=True)
        (y * torch.from_numpy(dy)).sum().backward()
    finally:
        jset_impl(prev_j)
        pt.set_conv1x1_impl(prev_t)
    _close(y.detach().numpy(), want, "output")
    _close(xt.grad.numpy(), gx, "x grad")
    grads = {n: p.grad.numpy() for n, p in tb.named_parameters()}
    for path, a in jax.tree_util.tree_flatten_with_path(gp)[0]:
        name = ".".join(p.key for p in path[1:])
        _close(grads[name], a, name)


STEPS, LR, MU = 3, 0.1, 0.9


def _pairs_batch(seed, n=8, size=32, classes=10):
    """Conflicting pairs: each image twice, with two different labels."""
    rng = np.random.RandomState(seed)
    half = n // 2
    x = rng.normal(size=(half, size, size, 3)).astype(np.float32)
    la = rng.randint(0, classes, half).astype(np.int32)
    lb = ((la + 1 + rng.randint(0, classes - 1, half)) % classes
          ).astype(np.int32)
    return {"x": np.concatenate([x, x]), "label": np.concatenate([la, lb])}


INIT_KEY, BATCH_SEED = 2, 5
TIE = 1e-6    # a ReLU input closer to 0 than this may take either mask


def test_trainer_matches_jax_trainer_under_pallas(monkeypatch):
    relu_inputs = []
    relu = torch.relu

    def recording_relu(x):
        relu_inputs.append(x.detach().abs().min().item())
        return relu(x)

    monkeypatch.setattr(torch, "relu", recording_relu)
    jm = jresnet.resnet_cifar(1)
    batch = _pairs_batch(BATCH_SEED)
    variables = _copy_tree(jax.jit(jm.init)(jax.random.PRNGKey(INIT_KEY),
                                            jnp.asarray(batch["x"])))
    opt = jopt.momentum(LR, MU)
    prev_j, prev_t = jset_impl("pallas"), pt.set_conv1x1_impl("pallas")
    try:
        tr = JTrainer(jm, lambda out, b: jcosts.softmax_cross_entropy(
            out, b["label"]), opt,
            mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
        # the Trainer's hook for models with their own init: start from
        # the variables above (and skip an eager re-init)
        jm.init_variables = lambda rng, b: jax.tree_util.tree_map(
            jnp.asarray, variables)
        tr.init(jax.random.PRNGKey(0), batch)
        tm = pt.load_jax_params(tresnet.resnet_cifar(1, device="cpu"),
                                variables)
        ttr = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(
            out, b["label"]), pt.momentum(LR, MU), device="cpu")
        ttr.init(batch)
        for k in range(STEPS):
            # each step from the JAX Trainer's state before it
            ts = tr.train_state
            pt.load_jax_params(tm, _copy_tree({"params": ts.params,
                                               "state": ts.state}))
            pt.load_jax_opt_state(ttr.train_state,
                                  _copy_tree(ts.opt_state), ts.step)
            losses = []
            for trainer, end in ((tr, jev.EndIteration),
                                 (ttr, pt.train.EndIteration)):
                trainer.train(lambda: iter([batch]),
                              event_handler=lambda e, end=end:
                              losses.append(e.cost)
                              if isinstance(e, end) else None,
                              log_period=0)
            assert len(relu_inputs) == 7 * (k + 1)
            assert min(relu_inputs) >= TIE, \
                f"step {k}: a ReLU input within {TIE} of 0: {relu_inputs}"
            _check_step(k, losses, tr.train_state, ttr, tm)
    finally:
        jset_impl(prev_j)
        pt.set_conv1x1_impl(prev_t)


def _check_step(k, losses, ts, ttr, tm):
    """One step's loss, parameters, BN state and velocity, each tensor
    against its own largest entry."""
    j_loss, t_loss = losses
    np.testing.assert_allclose(t_loss, j_loss, rtol=RTOL,
                               err_msg=f"step {k} loss")
    assert ttr.train_state.step == k + 1 == int(ts.step)
    ported = pt.export_jax_params(tm, root="ResNetCifar_0")
    for col, tree in (("params", ts.params), ("state", ts.state)):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "::".join([col] + [p.key for p in path])
            _close(ported[key], a, f"step {k} {key}")
    # TrainState.state holds the model's own buffers, which BN updated
    buffers = dict(tm.named_buffers())
    assert ttr.train_state.state.keys() == buffers.keys()
    assert all(ttr.train_state.state[n] is b for n, b in buffers.items())
    vel = pt.export_jax_opt_state(ttr.train_state.opt_state,
                                  root="ResNetCifar_0")
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(ts.opt_state)[0],
            jax.tree_util.tree_leaves(vel)):
        _close(b, a, f"step {k} velocity {jax.tree_util.keystr(path)}")
