"""Whole models under ``bfloat16_compute`` against the JAX package under the
same policy (CPU), on bridged weights and numpy batches from a seed:

- a small ``TransformerLM`` (vocab 97, dim 64, 2 layers, 4 heads, T 32,
  the flash path on both sides, JAX's kernels in interpret mode): logits,
  then 3 ``adam`` steps of the port's ``Trainer`` against the JAX
  ``Trainer``, both run under the policy as ``bench.py`` runs them;
- ``resnet_cifar(1)`` under ``set_conv1x1_impl("pallas")`` (JAX's
  ``dw_pallas`` in interpret mode, the port's ``conv1x1_dw`` plain
  version, both on bf16 operands): 2 ``momentum`` steps, each from the
  JAX run's parameters, BatchNorm state and velocity before it, with the
  step-0 gradients. The JAX side runs op by op here, not under ``jit``:
  a jitted step lets XLA's CPU backend keep fused bf16 elementwise chains
  in f32 between ops (excess precision), so its bf16 loss lies nearer the
  f32 one (7.6e-6 apart at this size) than an op-by-op run's (2.4e-4),
  which rounds after every op as the port does. The transformer's
  activations are f32 under the policy (only product operands are bf16),
  so its steps run through the JAX ``Trainer``;
- greedy serving: the port's ``DecodeEngine`` against the JAX engine,
  both under the policy;
- the weight bridge: JAX parameters made under the policy are f32 and
  load as they are; the port's parameters and optimizer state stay f32.

Tolerances. Two f32 values that differ in their last bits can round to
neighbouring bf16 values, and a model carries such a one-ulp difference
forward, so a whole model is held against the size of the policy's own
effect, measured on the same inputs: ``max |port_bf16 - jax_bf16| <= K *
max |jax_bf16 - jax_f32|`` with K = 0.25 for logits, losses, gradients,
parameters and running statistics (measured: at most 0.03 on the ResNet,
0.004 on the losses). Each training step starts both sides from JAX's
state, so the comparison holds one step's rounding, not a trajectory's.
Adam's first updates are nearly ``lr * sign(g)``, so a parameter entry
whose gradient one bf16 ulp moves across 0 differs by ``2 * lr``: every
entry is held within that, and the entries whose update has the same
sign on both sides to K of the policy's effect on them. Greedy tokens
must be equal wherever JAX's top-2 logit gap exceeds twice the logits'
tolerance; at the first position where it does not, the two sequences
may part, and the comparison stops there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu import optim as jopt
from paddle_tpu.core import dtypes as jdt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.nn.layers import set_conv1x1_impl as jset_impl
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu.train import events as jev
from paddle_tpu.train.trainer import Trainer as JTrainer
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet as tresnet

V, DIM, LAYERS, HEADS, FFN, T, BS = 97, 64, 2, 4, 128, 32, 4
KW = dict(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
          ffn_hidden=FFN, max_len=T, use_flash=True)
K_OUT = K_TRAIN = 0.25
ADAM_LR, STEPS = 1e-3, 3
LR, MU, RESNET_STEPS = 0.1, 0.9, 2


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jflat(tree):
    """A JAX variables tree as the bridge's flat ``"::"``-joined dict."""
    return {"::".join(k.key for k in path): np.asarray(a, np.float32)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _root(variables):
    (root,) = variables["params"].keys()
    return root


def _port_grads(model, root):
    """The model's parameter gradients under the bridge's flat names."""
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
        out = pt.export_jax_params(model, root)
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return {k: v for k, v in out.items() if k.startswith("params::")}


def _within_policy_effect(port, jax_bf16, jax_f32, k, what):
    """``max |port - jax_bf16| <= k * max |jax_bf16 - jax_f32|``."""
    port, jb, jf = (np.asarray(a, np.float32) for a in
                    (port, jax_bf16, jax_f32))
    effect = np.abs(jb - jf).max()
    err = np.abs(port - jb).max()
    assert effect > 0, f"{what}: the policy changed nothing"
    assert err <= k * effect, f"{what}: {err} > {k} x {effect}"
    return err, effect


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randint(0, V, (BS, T)).astype(np.int32),
             "y": rng.randint(0, V, (BS, T)).astype(np.int32)}
            for _ in range(n)]


BATCHES = _batches(STEPS, 0)


def _mesh():
    # the test harness forces 8 CPU devices: one, or the batch is sharded
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def lm():
    jm = JTransformerLM(**KW)
    with jdt.use_policy(jdt.bfloat16_compute):
        vs = _copy_tree(jm.init(jax.random.PRNGKey(0),
                                jnp.asarray(BATCHES[0]["x"])))
    return jm, vs


def test_bridge_loads_policy_params_as_f32(lm):
    _, vs = lm
    assert all(a.dtype == np.float32
               for a in jax.tree_util.tree_leaves(vs))
    tm = pt.load_jax_params(pt.TransformerLM(**KW, device="cpu"), vs)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_transformer_logits_match_jax_under_bf16(lm):
    jm, vs = lm
    ids = BATCHES[1]["x"]
    want = {}
    for name, pol in (("bf16", jdt.bfloat16_compute), ("f32", jdt.float32)):
        with jdt.use_policy(pol):
            want[name] = np.asarray(jm.apply(vs, jnp.asarray(ids)))
    tm = pt.load_jax_params(pt.TransformerLM(**KW, device="cpu"), vs)
    with torch.no_grad(), pt.use_policy(pt.bfloat16_compute):
        got = tm(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    _, effect = _within_policy_effect(got.numpy(), want["bf16"],
                                      want["f32"], K_OUT, "logits")
    top2 = np.sort(want["bf16"], -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * K_OUT * effect
    assert np.array_equal(got.numpy().argmax(-1)[clear],
                          want["bf16"].argmax(-1)[clear])


def _steps_from_jax(jtrs, ttr, tm, batches, root, check_params):
    """One step per batch from the bf16 JAX Trainer's state before it: the
    f32 JAX Trainer (for the policy's effect) and the port are set to that
    state, all three take the step, and the port's loss is held within
    K_OUT of the policy's effect on the loss; ``check_params(key, before,
    port, jax_bf16, jax_f32)`` holds each parameter and statistic."""
    for k, batch in enumerate(batches):
        ts = jtrs["bf16"].train_state
        start = _copy_tree({"params": ts.params, "state": ts.state,
                            "opt": ts.opt_state, "step": ts.step})
        fs = jtrs["f32"].train_state
        fs.params, fs.state, fs.opt_state = (
            jax.tree_util.tree_map(jnp.asarray, start[c])
            for c in ("params", "state", "opt"))
        pt.load_jax_params(tm, {"params": start["params"],
                                "state": start["state"]})
        pt.load_jax_opt_state(ttr.train_state, start["opt"], start["step"])
        losses, after = {}, {}
        for name, pol in (("bf16", jdt.bfloat16_compute),
                          ("f32", jdt.float32)):
            with jdt.use_policy(pol):
                jtrs[name].train(
                    lambda: iter([batch]), log_period=0,
                    event_handler=lambda e, n=name: losses.__setitem__(
                        n, e.cost) if isinstance(e, jev.EndIteration)
                    else None)
            s = jtrs[name].train_state
            after[name] = _jflat({"params": s.params, "state": s.state})
        with pt.use_policy(pt.bfloat16_compute):
            ttr.train(lambda: iter([batch]), log_period=0,
                      event_handler=lambda e: losses.__setitem__(
                          "port", e.cost)
                      if isinstance(e, pt.train.EndIteration) else None)
        _within_policy_effect(losses["port"], losses["bf16"], losses["f32"],
                              K_OUT, f"step {k} loss")
        ported = pt.export_jax_params(tm, root)
        before = _jflat({"params": start["params"], "state": start["state"]})
        assert ported.keys() == after["bf16"].keys()
        assert all(v.dtype == np.float32 for v in ported.values())
        for key, a in after["bf16"].items():
            check_params(f"step {k} {key}", before[key], ported[key], a,
                         after["f32"][key])


def _jax_trainers(jm, loss, opt, variables, batch):
    """A JAX Trainer under each policy, both from ``variables``."""
    trs = {}
    for name, pol in (("bf16", jdt.bfloat16_compute), ("f32", jdt.float32)):
        tr = JTrainer(jm, loss, opt, mesh=_mesh())
        # the Trainer's hook for models with their own init
        jm.init_variables = lambda rng, b: jax.tree_util.tree_map(
            jnp.asarray, variables)
        with jdt.use_policy(pol):
            tr.init(jax.random.PRNGKey(0), batch)
        trs[name] = tr
    return trs


def _adam_entries(what, before, port, jb, jf):
    """Adam's first updates are nearly ``lr * sign(g)``: every entry within
    ``2 * lr`` of JAX's (a sign that one bf16 ulp flips); the entries whose
    update has the same sign in the port and in JAX within K_TRAIN of the
    policy's effect on them, plus 1e-6 of the parameter (f32 rounding)."""
    assert np.abs(port - jb).max() <= 2 * ADAM_LR, what
    same = (port - before) * (jb - before) > 0
    err = np.abs(port - jb)[same].max(initial=0.0)
    effect = np.abs(jb - jf)[same].max(initial=0.0)
    assert err <= K_TRAIN * effect + 1e-6 * np.abs(jb).max(), \
        f"{what}: {err} > {K_TRAIN} x {effect}"


def test_transformer_adam_steps_match_jax_trainer(lm):
    jm, vs = lm
    trs = _jax_trainers(jm, lambda out, b: jcosts.softmax_cross_entropy(
        out, b["y"]), jopt.adam(ADAM_LR), vs, BATCHES[0])
    tm = pt.load_jax_params(pt.TransformerLM(**KW, device="cpu"), vs)
    ttr = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(
        out, b["y"]), pt.adam(ADAM_LR), device="cpu")
    ttr.init()
    _steps_from_jax(trs, ttr, tm, BATCHES, _root(vs), _adam_entries)
    assert ttr.train_state.step == STEPS
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(t.dtype == torch.float32 for t in
               jax.tree_util.tree_leaves(ttr.train_state.opt_state)
               if isinstance(t, torch.Tensor))


def _pairs_batch(seed, n=8, size=32, classes=10):
    rng = np.random.RandomState(seed)
    half = n // 2
    x = rng.normal(size=(half, size, size, 3)).astype(np.float32)
    la = rng.randint(0, classes, half).astype(np.int32)
    lb = ((la + 1 + rng.randint(0, classes - 1, half)) % classes).astype(
        np.int32)
    return {"x": np.concatenate([x, x]), "label": np.concatenate([la, lb])}


def _jax_step(jm, variables, vel, step, batch, pol, opt):
    """One momentum step of the JAX model run op by op (see the module
    note on why not jit): ``(loss, grads, params, state, velocity)``."""
    def loss_of(p):
        with jdt.use_policy(pol):
            out, new = jm.apply({"params": p, "state": variables["state"]},
                                jnp.asarray(batch["x"]), train=True,
                                mutable=["state"])
            return jcosts.softmax_cross_entropy(
                out, jnp.asarray(batch["label"])).mean(), new["state"]
    (loss, state), grads = jax.value_and_grad(loss_of, has_aux=True)(
        variables["params"])
    upd, vel = opt.update(grads, vel, variables["params"], step)
    return (float(loss), grads, jopt.apply_updates(variables["params"], upd),
            state, vel)


def test_resnet_cifar_pallas_grads_and_steps_match_jax():
    """2 momentum steps, each from the bf16 JAX run's parameters,
    BatchNorm state and velocity before it (the f32 JAX run too, for the
    policy's effect): the step-0 gradient of every parameter, then each
    step's loss, parameters and running statistics."""
    jm = jresnet.resnet_cifar(1)
    batch = _pairs_batch(2)
    variables = _copy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(batch["x"])))
    root = _root(variables)
    tm = pt.load_jax_params(tresnet.resnet_cifar(1, device="cpu"),
                            variables)
    opt = jopt.momentum(LR, MU)
    ttr = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(
        out, b["label"]), pt.momentum(LR, MU), device="cpu")
    ttr.init()
    vel = opt.init(variables["params"])
    prev_j, prev_t = jset_impl("pallas"), pt.set_conv1x1_impl("pallas")
    try:
        for k in range(RESNET_STEPS):
            runs = {name: _jax_step(jm, variables, vel, k, batch, pol, opt)
                    for name, pol in (("bf16", jdt.bfloat16_compute),
                                      ("f32", jdt.float32))}
            pt.load_jax_params(tm, variables)
            pt.load_jax_opt_state(ttr.train_state, _copy_tree(vel), k)
            losses = []
            with pt.use_policy(pt.bfloat16_compute):
                ttr.train(lambda: iter([batch]), log_period=0,
                          event_handler=lambda e: losses.append(e.cost)
                          if isinstance(e, pt.train.EndIteration) else None)
            _within_policy_effect(losses, [runs["bf16"][0]],
                                  [runs["f32"][0]], K_OUT, f"step {k} loss")
            if k == 0:
                tg = _port_grads(tm, root)
                jg = {n: _jflat({"params": r[1]}) for n, r in runs.items()}
                assert tg.keys() == jg["bf16"].keys()
                for key, a in jg["bf16"].items():
                    _within_policy_effect(tg[key], a, jg["f32"][key],
                                          K_TRAIN, f"step-0 grad {key}")
            after = {n: _jflat({"params": r[2], "state": r[3]})
                     for n, r in runs.items()}
            ported = pt.export_jax_params(tm, root)
            assert ported.keys() == after["bf16"].keys()
            assert all(v.dtype == np.float32 for v in ported.values())
            for key, a in after["bf16"].items():
                _within_policy_effect(ported[key], a, after["f32"][key],
                                      K_TRAIN, f"step {k} {key}")
            _, _, params, state, vel = runs["bf16"]
            variables = _copy_tree({"params": params, "state": state})
            vel = jax.tree_util.tree_map(jnp.asarray, vel)
    finally:
        jset_impl(prev_j)
        pt.set_conv1x1_impl(prev_t)


SV, SW, SBS = 64, 32, 4     # serving: vocab, width, block size


def test_greedy_serving_tokens_match_jax_engine_under_bf16():
    jm = JTransformerLM(vocab=SV, dim=32, num_layers=2, num_heads=4,
                        ffn_hidden=64, max_len=SW, use_flash=True)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SW), jnp.int32))
    tm = pt.load_jax_params(pt.TransformerLM(
        SV, dim=32, num_layers=2, num_heads=4, ffn_hidden=64, max_len=SW,
        use_flash=True, device="cpu"), vs)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, SV, n)] for n in (5, 11, 3)]
    new = 6
    with jdt.use_policy(jdt.bfloat16_compute):
        jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=SBS,
                             attention="paged")
        # copies: the JAX engine bumps the lengths in place while a CPU
        # tick may still alias them (tests/test_torch_serve.py)
        jc = jeng.cache
        jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                    jnp.array(np.copy(jc.lengths)))
        js = JScheduler(jeng)
        jreqs = [js.submit(list(p), new) for p in prompts]
        js.run()
    eng = pt.DecodeEngine(tm, max_slots=3, block_size=SBS, device="cpu",
                          attention="paged")
    ts = pt.ContinuousBatchingScheduler(eng)
    treqs = [ts.submit(list(p), new) for p in prompts]
    with pt.use_policy(pt.bfloat16_compute):
        ts.run()
    fwd = {name: jax.jit(lambda v, i, pol=pol: _apply_under(jm, v, i, pol))
           for name, pol in (("bf16", jdt.bfloat16_compute),
                             ("f32", jdt.float32))}
    for p, jr, tr in zip(prompts, jreqs, treqs):
        seq = np.zeros((1, SW), np.int32)
        full = p + jr.tokens[:-1]
        seq[0, :len(full)] = full
        rows = slice(len(p) - 1, len(full))
        lb = np.asarray(fwd["bf16"](vs, jnp.asarray(seq)))[0, rows]
        lf = np.asarray(fwd["f32"](vs, jnp.asarray(seq)))[0, rows]
        tol = 2 * K_OUT * np.abs(lb - lf).max()
        for i, (a, b) in enumerate(zip(jr.tokens, tr.tokens)):
            if a != b:
                top2 = np.sort(lb[i])[-2:]
                assert top2[1] - top2[0] <= tol, \
                    f"token {i}: {b} != {a} at a top-2 gap {top2}"
                break


def _apply_under(jm, variables, ids, pol):
    with jdt.use_policy(pol):
        return jm.apply(variables, ids)
