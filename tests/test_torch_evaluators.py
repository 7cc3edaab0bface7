"""The port's evaluators against the JAX package's (CPU): each evaluator
fed the same seeded numpy batches on both sides — ``batch_stats`` in
torch on the port's side, in ``jnp`` on JAX's, the host ``update`` on
each side's stats — over several batches, then ``result()`` compared
key for key (atol 1e-6: the same counts, and f32 sums in other orders
before the host's float64 accumulation). Printers compare the lines
they log (integer-valued outputs, so the printed means are exact).
Also ``reset``, and ``EvaluatorSet`` bundling several."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.train import evaluators as J
from paddle_tpu_torch.train import evaluators as T

B = 24


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.numpy()


def _run(ev, batches):
    """Feed ``batches`` (``(outputs, batch)`` numpy pairs) through ``ev``;
    its module says which framework."""
    jax_side = isinstance(ev, (J.Evaluator, J.EvaluatorSet))
    for out, batch in batches:
        if jax_side:
            st = ev.batch_stats(jnp.asarray(out),
                                {k: jnp.asarray(v) for k, v in batch.items()})
            ev.update(jax.device_get(st))
        else:
            st = ev.batch_stats(torch.from_numpy(out),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
            ev.update(_to_host(st))
    return ev.result()


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=1e-6, rtol=0, err_msg=k)


def _labels(rng, n, classes, pad=True):
    y = rng.randint(0, classes, n).astype(np.int32)
    if pad:
        y[rng.rand(n) < 0.15] = -1
    return y


def _cls(rng):
    return (rng.randn(B, 5).astype(np.float32),
            {"label": _labels(rng, B, 5)})


def _binary(rng, two=False, logits=False):
    out = rng.randn(B, 2).astype(np.float32) if two else \
        (rng.randn(B, 1) if logits else rng.rand(B, 1)).astype(np.float32)
    return out, {"label": rng.randint(0, 2, B).astype(np.int32)}


def _ranked(rng):
    # rounded scores: ties within and across labels
    out = np.round(rng.rand(B, 1) * 4) / 4
    return (out.astype(np.float32),
            {"label": _labels(rng, B, 2),
             "weight": rng.randint(1, 4, B).astype(np.float32),
             "query": rng.randint(0, 4, B).astype(np.int32)})


def _chunks(rng):
    T_, types = 9, 3
    tags = rng.randint(0, 2 * types + 1, (4, T_)).astype(np.int32)
    gold = np.where(rng.rand(4, T_) < 0.7, tags,
                    rng.randint(0, 2 * types + 1, (4, T_))).astype(np.int32)
    return tags, {"label": gold,
                  "length": rng.randint(3, T_ + 1, 4).astype(np.int32)}


def _ctc(rng):
    Tn, C, L = 10, 5, 6
    out = rng.randn(4, Tn, C).astype(np.float32)
    label = rng.randint(1, C, (4, L)).astype(np.int32)
    lens = rng.randint(0, L + 1, 4)
    for b in range(4):
        label[b, lens[b]:] = -1
    return out, {"label": label,
                 "length": rng.randint(1, Tn + 1, 4).astype(np.int32)}


def _sums(rng, cols=1):
    return (rng.randn(B, cols).astype(np.float32),
            {"weight": rng.rand(B).astype(np.float32)})


def _detections(rng):
    Bn, K, G, C = 3, 6, 4, 3

    def boxes(n):
        lo = rng.rand(Bn, n, 2) * 0.6
        return np.concatenate([lo, lo + 0.1 + rng.rand(Bn, n, 2) * 0.3], -1)

    gt = boxes(G).astype(np.float32)
    gl = rng.randint(0, C, (Bn, G)).astype(np.int32)
    gl[:, -1] = -1
    det_box = np.where(rng.rand(Bn, K, 1) < 0.6,
                       np.repeat(gt, 2, axis=1)[:, :K] + 0.01,
                       boxes(K)).astype(np.float32)
    det = np.concatenate([rng.randint(0, C, (Bn, K, 1)),
                          rng.rand(Bn, K, 1), det_box], -1).astype(
                              np.float32)
    det[:, -1, 0] = -1
    return det, {"gt_box": gt, "gt_label": gl,
                 "gt_difficult": (rng.rand(Bn, G) < 0.2).astype(np.int32)}


CASES = {
    "classification_error": (lambda m: m.ClassificationError(), _cls),
    "precision_recall": (lambda m: m.PrecisionRecall(0.4), _binary),
    "precision_recall_two": (lambda m: m.PrecisionRecall(),
                             lambda r: _binary(r, two=True)),
    "auc": (lambda m: m.Auc(num_bins=64), _binary),
    "auc_two": (lambda m: m.Auc(), lambda r: _binary(r, two=True)),
    "auc_logits": (lambda m: m.Auc(from_logits=True),
                   lambda r: _binary(r, logits=True)),
    "rankauc": (lambda m: m.RankAuc(), _ranked),
    "pnpair": (lambda m: m.PnPair(), _ranked),
    "chunk": (lambda m: m.ChunkEvaluator(3), _chunks),
    "ctc": (lambda m: m.CtcErrorEvaluator(), _ctc),
    "ctc_last_blank": (lambda m: m.CtcErrorEvaluator(blank=-1), _ctc),
    "sum": (lambda m: m.SumEvaluator(), _sums),
    "column_sum": (lambda m: m.ColumnSumEvaluator(),
                   lambda r: _sums(r, 4)),
    "detection_map": (lambda m: m.DetectionMAP(), _detections),
    "detection_map_integral": (
        lambda m: m.DetectionMAP(ap_type="Integral",
                                 evaluate_difficult=True), _detections),
    "set": (lambda m: m.EvaluatorSet(m.ClassificationError(),
                                     m.PrecisionRecall(name="pr")), _cls),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_result_matches_jax_over_batches(name):
    make, data = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    batches = [data(rng) for _ in range(4)]
    jev, tev = make(J), make(T)
    _same(_run(tev, batches), _run(jev, batches))
    # reset, then one batch
    jev.reset()
    tev.reset()
    _same(_run(tev, batches[:1]), _run(jev, batches[:1]))


@pytest.mark.parametrize("printer", ["value", "max_id", "text"])
def test_printers_log_what_jax_logs(printer):
    rng = np.random.RandomState(11)
    logs = {"jax": [], "port": []}

    def make(m, sink):
        if printer == "value":
            return m.ValuePrinter(sink=sink)
        if printer == "max_id":
            return m.MaxIdPrinter(sink=sink, limit=5)
        return m.SequenceTextPrinter(vocab={1: "a", 3: "c"}, sink=sink)

    if printer == "text":
        batches = [(rng.randint(0, 5, (3, 6)).astype(np.int32),
                    {"length": np.array([6, 2, 4], np.int32)}),
                   (rng.randint(0, 5, (2, 6)).astype(np.int32), {})]
    else:
        batches = [(rng.randint(-8, 8, (4, 3)).astype(np.float32), {})
                   for _ in range(2)]
    assert _run(make(T, logs["port"].append), batches) == {}
    _run(make(J, logs["jax"].append), batches)
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 2
