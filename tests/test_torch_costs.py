"""The port's costs against the JAX package's (f32, CPU): the 17 functions
after ``softmax_cross_entropy``. Each of the 16 costs on the same seeded
inputs, its
per-example losses (``cross_entropy_over_beam``: the batch's mean) and
the gradients of ``sum(loss * g)`` with respect to each float input JAX
differentiates (``jax.grad`` against autograd), one case per function;
``build_hsigmoid_codes`` exactly. Inputs span each piecewise cost's
branches (smooth L1 and Huber on both sides of delta; hinge and the
huberized hinge on every segment; beams with the gold off the beam and
padded candidates). Tolerance: rtol 1e-5, atol 1e-5 — the same f32
formulas, summed in other orders."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import costs as J
from paddle_tpu_torch.nn import costs as T

B, C, V, D, K = 6, 5, 11, 8, 4


def _r(seed):
    return np.random.RandomState(seed)


def _f(a):
    return np.asarray(a, np.float32)


def _case_cross_entropy_with_probs(r):
    p = r.rand(B, C)
    return dict(logits=_f(r.randn(B, C) * 2),
                target_probs=_f(p / p.sum(1, keepdims=True)),
                weight=_f(r.rand(B))), ("logits",)


def _case_soft_binary_ce(r):
    return dict(probs=_f(r.rand(B, C)), targets=_f(r.rand(B, C)),
                weight=_f(r.rand(B))), ("probs",)


def _case_binary_logistic(r):
    return dict(logits=_f(r.randn(B) * 4),
                labels=r.randint(0, 2, B).astype(np.int32)), ("logits",)


def _case_multi_binary_ce(r):
    return dict(logits=_f(r.randn(B, C) * 3),
                targets=_f(r.randint(0, 2, (B, C))),
                weight=_f(r.rand(B))), ("logits",)


def _case_mse(r):
    return dict(output=_f(r.randn(B, C)), target=_f(r.randn(B, C)),
                weight=_f(r.rand(B))), ("output", "target")


def _case_smooth_l1_elementwise(r):
    return dict(output=_f(r.randn(B, C) * 2), target=_f(r.randn(B, C)),
                delta=0.7), ("output",)


def _case_smooth_l1(r):
    return dict(output=_f(r.randn(B, C) * 2), target=_f(r.randn(B, C)),
                weight=_f(r.rand(B)), delta=0.5), ("output", "target")


def _case_huber_regression(r):
    return dict(output=_f(r.randn(B, C) * 2), target=_f(r.randn(B, C)),
                weight=_f(r.rand(B)), delta=1.0), ("output",)


def _case_huber_classification(r):
    # z = y * s on every segment: below -1, in (-1, 1), above 1
    return dict(score=_f([[-3.0], [-0.4], [0.3], [2.5], [0.9], [-1.7]]),
                label01=_f(r.randint(0, 2, B)),
                weight=_f(r.rand(B))), ("score",)


def _case_hinge(r):
    return dict(score=_f([[-2.0], [-0.3], [0.2], [1.6], [0.7], [-1.2]]),
                label01=_f(r.randint(0, 2, B))), ("score",)


def _case_rank_cost(r):
    return dict(left=_f(r.randn(B, 1)), right=_f(r.randn(B, 1)),
                label=_f(r.rand(B)), weight=_f(r.rand(B))), \
        ("left", "right")


def _case_lambda_rank_ndcg(r):
    return dict(scores=_f(r.randn(3, 7)),
                relevance=_f(r.randint(0, 4, (3, 7))),
                lengths=np.array([7, 4, 6], np.int32), sigma=1.5,
                ndcg_k=3), ("scores",)


def _case_sum_cost(r):
    return dict(output=_f(r.randn(B, C)), weight=_f(r.rand(B))), \
        ("output",)


def _case_nce_loss(r):
    return dict(hidden=_f(r.randn(B, D)),
                labels=r.randint(0, V, B).astype(np.int32),
                table_w=_f(r.randn(V, D) * 0.3), table_b=_f(r.randn(V)),
                noise_ids=r.randint(0, V, (B, K)).astype(np.int32),
                noise_logprob=_f(np.log(r.rand(V) * K + 0.1))), \
        ("hidden", "table_w", "table_b")


def _case_hsigmoid_loss(r):
    labels = r.randint(0, V, B).astype(np.int32)
    codes, signs = J.build_hsigmoid_codes(jnp.asarray(labels), V)
    return dict(hidden=_f(r.randn(B, D)), labels=labels,
                codes=np.asarray(codes), signs=np.asarray(signs),
                node_w=_f(r.randn(V, D) * 0.3), node_b=_f(r.randn(V))), \
        ("hidden", "node_w", "node_b")


def _case_cross_entropy_over_beam(r):
    mask = r.rand(B, C) < 0.8
    mask[:, 0] = True
    gold = r.randint(0, C, B).astype(np.int32)
    gold[[1, 4]] = -1                           # fell off the beam
    gold[2] = 0
    return dict(path_scores=_f(r.randn(B, C) * 2), gold_idx=gold,
                gold_score=_f(r.randn(B)), valid_mask=mask), \
        ("path_scores", "gold_score")


CASES = {n[len("_case_"):]: f for n, f in sorted(globals().items())
         if n.startswith("_case_")}


def test_every_cost_has_a_case():
    # JAX's __all__ leaves out three of its functions
    want = (set(J.__all__) - {"softmax_cross_entropy", "reduce"}) | {
        "smooth_l1_elementwise", "cross_entropy_over_beam"}
    assert set(CASES) == want and len(CASES) == 16
    assert set(T.__all__) >= set(J.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cost_and_gradients_match_jax(name):
    args, diff = CASES[name](_r(sorted(CASES).index(name)))
    jf, tf = getattr(J, name), getattr(T, name)
    arrays = {k: v for k, v in args.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in args.items() if k not in arrays}
    want = np.asarray(jf(**{k: jnp.asarray(v) for k, v in arrays.items()},
                         **static))
    tin = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    for k in diff:
        tin[k].requires_grad_(True)
    got = tf(**tin, **static)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    g = np.asarray(np.random.RandomState(7).randn(*want.shape), np.float32)

    def jloss(*xs):
        kw = {k: jnp.asarray(v) for k, v in arrays.items()}
        kw.update(zip(diff, xs))
        return jnp.sum(jf(**kw, **static) * g)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(diff))))(
        *(jnp.asarray(arrays[k]) for k in diff))
    (got * torch.from_numpy(g)).sum().backward()
    for k, jgr in zip(diff, jgrads):
        np.testing.assert_allclose(tin[k].grad.numpy(), np.asarray(jgr),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("classes", [1, 2, 5, 8, 11, 64])
def test_build_hsigmoid_codes_exactly(classes):
    labels = np.arange(classes, dtype=np.int32)
    jc, js = J.build_hsigmoid_codes(jnp.asarray(labels), classes)
    tc, ts = T.build_hsigmoid_codes(torch.from_numpy(labels), classes)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.float32
