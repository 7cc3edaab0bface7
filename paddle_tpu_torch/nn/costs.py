"""Cost functions — the port of ``paddle_tpu/nn/costs.py``. Each cost maps
outputs and labels to a per-example loss in float32 whatever the
activation dtype (``cross_entropy_over_beam`` to the batch's mean, as in
JAX); the trainer reduces it. ``weight`` multiplies each example's loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "softmax_cross_entropy", "cross_entropy_with_probs", "soft_binary_ce",
    "binary_logistic", "multi_binary_ce", "mse", "smooth_l1_elementwise",
    "smooth_l1", "huber_regression", "huber_classification", "hinge",
    "rank_cost", "lambda_rank_ndcg", "sum_cost", "nce_loss",
    "hsigmoid_loss", "build_hsigmoid_codes", "cross_entropy_over_beam",
    "reduce",
]


def _weight(loss: torch.Tensor, weight) -> torch.Tensor:
    return loss if weight is None else loss * weight


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """Stable ``log(1 + exp(x))`` in float32 (``jax.nn.softplus``:
    ``logaddexp(x, 0)``)."""
    x = x.float()
    return torch.logaddexp(x, torch.zeros_like(x))


def reduce(per_example: torch.Tensor, mask=None,
           how: str = "mean") -> torch.Tensor:
    """Masked reduction to a scalar: ``"mean"`` divides by the mask's sum
    (at least 1) when a mask is given, ``"sum"`` sums."""
    x = per_example.float()
    if mask is not None:
        m = mask.float()
        x = x * m
        if how == "mean":
            return x.sum() / m.sum().clamp_min(1.0)
    if how == "mean":
        return x.mean()
    if how == "sum":
        return x.sum()
    raise ValueError(how)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weight=None) -> torch.Tensor:
    """Multi-class cross-entropy from logits ``[..., C]`` and integer
    labels ``[...]``: f32 log-softmax, the label's negative log-likelihood;
    label -1 masks the example (it is clamped into range, looked up, and
    multiplied by 0)."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return _weight(nll * valid.to(nll.dtype), weight)


def cross_entropy_with_probs(logits, target_probs, weight=None):
    """Soft-label cross-entropy: ``-sum(p * log_softmax(logits))``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _weight(-(target_probs * logp).sum(-1), weight)


def soft_binary_ce(probs, targets, weight=None, eps: float = 1e-7):
    """Binary cross-entropy on probabilities (post-sigmoid), clipped to
    ``[eps, 1 - eps]``; summed over the last axis of a matrix."""
    p = probs.float().clamp(eps, 1 - eps)
    loss = -(targets * torch.log(p) + (1 - targets) * torch.log1p(-p))
    return _weight(loss.sum(-1) if loss.dim() > 1 else loss, weight)


def binary_logistic(logits, labels, weight=None):
    """Binary cross-entropy on logits ``[B]`` with 0/1 labels ``[B]``:
    ``softplus(z) - y z``."""
    z = logits.float()
    return _weight(_softplus(z) - labels.float() * z, weight)


def multi_binary_ce(logits, targets, weight=None):
    """Multi-label binary cross-entropy from logits, summed over labels."""
    x = logits.float()
    return _weight((_softplus(x) - x * targets).sum(-1), weight)


def mse(output, target, weight=None):
    """Sum-of-squares cost: ``0.5 * sum((output - target)^2)``."""
    d = (output - target).float()
    return _weight(0.5 * (d * d).sum(-1), weight)


def smooth_l1_elementwise(output, target, delta: float = 1.0):
    """Per-element smooth L1: ``0.5 d^2 / delta`` below ``delta``, else
    ``d - delta / 2``."""
    d = torch.abs((output - target).float())
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


def smooth_l1(output, target, weight=None, delta: float = 1.0):
    """Smooth L1 summed over the last axis."""
    return _weight(smooth_l1_elementwise(output, target, delta).sum(-1),
                   weight)


def huber_regression(output, target, weight=None, delta: float = 1.0):
    """Huber regression: ``0.5 d^2`` up to ``delta``, then linear."""
    d = torch.abs((output - target).float())
    loss = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _weight(loss.sum(-1), weight)


def huber_classification(score, label01, weight=None):
    """Huberized hinge for two classes, labels in {0, 1}: with ``z = y s``
    (y = ±1), ``-4 z`` below -1, ``(1 - z)^2`` below 1, else 0."""
    y = (2.0 * label01 - 1.0).float()
    z = y * score[..., 0].float()
    loss = torch.where(z < -1, -4.0 * z,
                       torch.where(z < 1, (1 - z) ** 2,
                                   torch.zeros_like(z)))
    return _weight(loss, weight)


def hinge(score, label01, weight=None):
    """Two-class hinge: ``max(0, 1 - y s)`` with y = ±1."""
    y = 2.0 * label01.float() - 1.0
    return _weight(torch.clamp_min(1.0 - y * score[..., 0].float(), 0.0),
                   weight)


def rank_cost(left, right, label, weight=None):
    """Pairwise rank cost (RankNet): ``softplus(o) - o t`` with ``o =
    left - right`` and ``t`` in [0, 1]."""
    o = (left - right).float()[..., 0]
    return _weight(_softplus(o) - o * label, weight)


def lambda_rank_ndcg(scores, relevance, lengths=None, sigma: float = 1.0,
                     ndcg_k: int = 5):
    """LambdaRank's NDCG-weighted pairwise logistic cost per list:
    ``scores``/``relevance`` ``[B, T]``, optional ``lengths [B]``; returns
    ``[B]``. The pair weights (gains, discounts by the current ranking,
    the ideal DCG over the top ``ndcg_k``) carry no gradient."""
    s = scores.float()
    r = relevance.float()
    t = s.shape[1]
    ar = torch.arange(t, device=s.device)
    if lengths is not None:
        valid = ar[None, :] < lengths[:, None]
    else:
        valid = torch.ones_like(s, dtype=torch.bool)
    neg_inf = torch.full_like(s, -math.inf)
    diff_s = s[:, :, None] - s[:, None, :]
    gain = 2.0 ** r - 1.0
    sorted_r = torch.sort(torch.where(valid, r, neg_inf), dim=1,
                          descending=True, stable=True).values
    disc = 1.0 / torch.log2(ar.float() + 2.0)
    topk = (ar < ndcg_k).float()
    finite = torch.where(torch.isfinite(sorted_r), sorted_r,
                         torch.zeros_like(sorted_r))
    idcg = ((2.0 ** finite - 1.0) * disc * topk).sum(1)
    order = torch.argsort(-torch.where(valid, s, neg_inf).detach(), dim=1,
                          stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    d = disc[ranks.clamp(0, t - 1)]
    delta = (torch.abs(gain[:, :, None] - gain[:, None, :])
             * torch.abs(d[:, :, None] - d[:, None, :])
             / idcg.clamp_min(1e-9)[:, None, None])
    pair_valid = valid[:, :, None] & valid[:, None, :] & \
        (r[:, :, None] > r[:, None, :])
    logistic = _softplus(-sigma * diff_s)
    return (delta * logistic * pair_valid).sum((1, 2))


def sum_cost(output, weight=None):
    """The sum of the outputs over the last axis, as a cost."""
    return _weight(output.float().sum(-1), weight)


def nce_loss(hidden, labels, table_w, table_b, noise_ids,
             noise_logprob=None):
    """Noise-contrastive estimation: binary logistic on the true class
    against K sampled noise classes. ``hidden [B, D]``, ``labels [B]``,
    ``table_w [V, D]``, ``table_b [V]``, ``noise_ids [B, K]``;
    ``noise_logprob [V]`` (log(k q(class))), when given, is subtracted
    from every logit."""
    h = hidden.float()
    labels = labels.long()
    noise_ids = noise_ids.long()
    pos_logit = (h * table_w[labels]).sum(-1) + table_b[labels]
    neg_logit = torch.einsum("bd,bkd->bk", h, table_w[noise_ids]) \
        + table_b[noise_ids]
    if noise_logprob is not None:
        pos_logit = pos_logit - noise_logprob[labels]
        neg_logit = neg_logit - noise_logprob[noise_ids]
    return _softplus(-pos_logit) + _softplus(neg_logit).sum(-1)


def hsigmoid_loss(hidden, labels, codes, signs, node_w, node_b):
    """Hierarchical sigmoid over a complete binary tree of classes:
    ``hidden [B, D]``; ``codes [B, L]`` node ids (-1 padding) and
    ``signs [B, L]`` (±1, 0 padding) from :func:`build_hsigmoid_codes`;
    ``node_w [nodes, D]``, ``node_b [nodes]``. ``labels`` is taken for
    the JAX signature (the codes carry it)."""
    h = hidden.float()
    safe = codes.clamp_min(0).long()
    logit = torch.einsum("bd,bld->bl", h, node_w[safe]) + node_b[safe]
    loss = _softplus(-signs * logit)
    return (loss * (codes >= 0)).sum(-1)


def build_hsigmoid_codes(labels, num_classes: int):
    """Complete-binary-tree path codes for each label (the reference's
    ``SimpleCode``): ``c = label + num_classes`` in heap order; each step
    up records the parent's node id ``parent - 1`` and the sign ``+1`` for
    a left child (bit 0), ``-1`` for a right one, padded with -1 / 0 past
    the root. Returns ``(codes [B, L], signs [B, L])`` with ``L =
    max(1, ceil(log2(num_classes)))``."""
    depth = max(1, math.ceil(math.log2(num_classes)))
    c = labels + num_classes
    codes, signs = [], []
    for _ in range(depth):
        parent = torch.div(c, 2, rounding_mode="floor")
        bit = c % 2
        valid = parent >= 1
        codes.append(torch.where(valid, parent - 1,
                                 torch.full_like(parent, -1)))
        signs.append(torch.where(valid, 1.0 - 2.0 * bit.float(),
                                 torch.zeros(bit.shape, device=bit.device)))
        c = parent
    return torch.stack(codes, -1), torch.stack(signs, -1)


def cross_entropy_over_beam(path_scores, gold_idx, gold_score=None,
                            valid_mask=None):
    """Cross-entropy over beam-search candidate paths: softmax over the
    ``N`` candidates' scores ``[B, N]`` (``valid_mask`` off ones masked),
    the gold path at ``gold_idx [B]``; where it is -1 the gold fell off the
    beam and ``gold_score [B]`` joins as an extra candidate, the target.
    Returns the batch's mean negative log-probability of the gold path."""
    B, N = path_scores.shape
    if gold_score is None:
        gold_score = torch.zeros(B, dtype=path_scores.dtype,
                                 device=path_scores.device)
    if valid_mask is None:
        valid_mask = torch.ones(B, N, dtype=torch.bool,
                                device=path_scores.device)
    off_beam = gold_idx < 0
    neg_inf = torch.full_like(gold_score, -math.inf)
    extra = torch.where(off_beam, gold_score, neg_inf)
    scores = torch.cat([torch.where(valid_mask, path_scores,
                                    torch.full_like(path_scores, -math.inf)),
                        extra[:, None]], dim=1)
    target = torch.where(off_beam, torch.full_like(gold_idx, N),
                         gold_idx.clamp_min(0)).long()
    logp = F.log_softmax(scores, dim=-1)
    return -logp.gather(1, target[:, None])[:, 0].mean()
