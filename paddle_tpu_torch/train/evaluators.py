"""Evaluators — the port of ``paddle_tpu/train/evaluators.py``: streaming
metrics over batches.

Each evaluator has a ``batch_stats(outputs, batch) -> dict`` piece that
runs in torch on the step's device tensors (inside the trainer's step,
no host sync) and gives small sufficient statistics, and host-side
``update``/``result`` in numpy that accumulate them across batches, as in
JAX: the trainer fetches a call's stats in the same device-to-host copy as
its losses. ``update`` takes the stats as numpy arrays (or CPU tensors).
The host-side parts are the JAX module's, kept here as a copy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["Evaluator", "ClassificationError", "PrecisionRecall", "Auc",
           "RankAuc", "PnPair", "ChunkEvaluator", "CtcErrorEvaluator",
           "DetectionMAP", "SumEvaluator", "ColumnSumEvaluator", "ValuePrinter",
           "MaxIdPrinter", "SequenceTextPrinter", "EvaluatorSet"]

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32, device=like.device)


class Evaluator:
    name = "evaluator"

    def batch_stats(self, outputs, batch) -> Dict[str, Any]:
        """Device-side sufficient statistics (torch tensors; no host
        sync)."""
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def update(self, stats: Dict[str, np.ndarray]):
        raise NotImplementedError

    def result(self) -> Dict[str, float]:
        raise NotImplementedError


class ClassificationError(Evaluator):
    """top-1 error (reference: ``ClassificationErrorEvaluator``)."""

    def __init__(self, name="classification_error"):
        self.name = name
        self.reset()

    def batch_stats(self, outputs, batch):
        labels = batch["label"]
        pred = torch.argmax(outputs, dim=-1)
        valid = labels >= 0
        wrong = ((pred != labels) & valid).sum()
        return {"wrong": wrong, "total": valid.sum()}

    def reset(self):
        self._wrong = 0
        self._total = 0

    def update(self, stats):
        self._wrong += int(stats["wrong"])
        self._total += int(stats["total"])

    def result(self):
        err = self._wrong / max(1, self._total)
        return {self.name: err, "accuracy": 1.0 - err}


class PrecisionRecall(Evaluator):
    """Binary/micro-averaged precision-recall-F1 (reference:
    ``PrecisionRecallEvaluator``)."""

    def __init__(self, threshold: float = 0.5, name="precision_recall"):
        self.name = name
        self.threshold = threshold
        self.reset()

    def batch_stats(self, outputs, batch):
        labels = batch["label"]
        if outputs.dim() > 1 and outputs.shape[-1] == 2:
            pred = torch.argmax(outputs, -1)
        else:
            score = outputs[..., 0] if outputs.dim() > 1 else outputs
            pred = (score > self.threshold).to(torch.int32)
        labels = labels.to(torch.int32)
        tp = ((pred == 1) & (labels == 1)).sum()
        fp = ((pred == 1) & (labels == 0)).sum()
        fn = ((pred == 0) & (labels == 1)).sum()
        return {"tp": tp, "fp": fp, "fn": fn}

    def reset(self):
        self._tp = self._fp = self._fn = 0

    def update(self, stats):
        self._tp += int(stats["tp"])
        self._fp += int(stats["fp"])
        self._fn += int(stats["fn"])

    def result(self):
        p = self._tp / max(1, self._tp + self._fp)
        r = self._tp / max(1, self._tp + self._fn)
        f1 = 2 * p * r / max(1e-9, p + r)
        return {"precision": p, "recall": r, "f1": f1}


class Auc(Evaluator):
    """ROC AUC via fixed-bin histogram (reference: ``AucEvaluator`` — same
    binned approach, Evaluator.cpp)."""

    def __init__(self, num_bins: int = 1024, from_logits: bool = False,
                 name="auc"):
        self.name = name
        self.num_bins = num_bins
        self.from_logits = from_logits
        self.reset()

    def batch_stats(self, outputs, batch):
        labels = batch["label"].to(torch.int32)
        if outputs.dim() > 1 and outputs.shape[-1] == 2:
            score = torch.softmax(outputs, -1)[..., 1]
        else:
            score = outputs[..., 0] if outputs.dim() > 1 else outputs
            if self.from_logits:      # map logits into [0,1) for binning
                score = torch.sigmoid(score)
        idx = (score * self.num_bins).to(torch.int32).clamp(
            0, self.num_bins - 1).reshape(-1).long()
        zeros = torch.zeros(self.num_bins, dtype=torch.float32,
                            device=outputs.device)
        pos = zeros.index_add(0, idx, (labels == 1).reshape(-1).float())
        neg = zeros.index_add(0, idx, (labels == 0).reshape(-1).float())
        return {"pos": pos, "neg": neg}

    def reset(self):
        self._pos = np.zeros(self.num_bins)
        self._neg = np.zeros(self.num_bins)

    def update(self, stats):
        self._pos += np.asarray(stats["pos"])
        self._neg += np.asarray(stats["neg"])

    def result(self):
        # integrate from the highest bin down
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return {self.name: 0.5}
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        auc = float(_trapezoid(tpr, fpr))
        return {self.name: auc}


class RankAuc(Evaluator):
    """Exact ROC AUC from accumulated (score, label) pairs (reference:
    ``RankAucEvaluator``, ``gserver/evaluators/Evaluator.cpp`` — computes AUC
    over the full score column). Holds every score on the host until
    ``result`` — exact but O(N) memory; use the binned :class:`Auc` for
    unbounded streams."""

    def __init__(self, name="rankauc"):
        self.name = name
        self.reset()

    def batch_stats(self, outputs, batch):
        score = outputs[..., 0] if outputs.dim() > 1 else outputs
        return {"score": score, "label": batch["label"],
                "weight": batch.get("weight",
                                    _ones(score.shape[0], score))}

    def reset(self):
        self._scores, self._labels, self._weights = [], [], []

    def update(self, stats):
        lab = np.asarray(stats["label"])
        keep = lab >= 0                       # -1 = padding, as everywhere
        self._scores.append(np.asarray(stats["score"], np.float64)[keep])
        self._labels.append(lab[keep])
        self._weights.append(np.asarray(stats["weight"], np.float64)[keep])

    def result(self):
        if not self._scores:
            return {self.name: 0.5}
        s = np.concatenate(self._scores)
        y = np.concatenate(self._labels)
        w = np.concatenate(self._weights)
        order = np.argsort(s, kind="stable")
        s, y, w = s[order], y[order], w[order]
        # average rank per tied-score group (Mann-Whitney with ties)
        ranks = np.empty(len(s))
        i = 0
        cum = 0.0
        while i < len(s):
            j = i
            while j < len(s) and s[j] == s[i]:
                j += 1
            block_w = w[i:j].sum()
            # weighted average 1-based rank of the tied block
            ranks[i:j] = cum + (block_w + 1.0) / 2.0
            cum += block_w
            i = j
        pos = y == 1
        w_pos = w[pos].sum()
        w_neg = w[~pos].sum()
        if w_pos == 0 or w_neg == 0:
            return {self.name: 0.5}
        auc = ((ranks[pos] * w[pos]).sum() - w_pos * (w_pos + 1) / 2.0) / (
            w_pos * w_neg)
        return {self.name: float(auc)}


class PnPair(Evaluator):
    """Positive-negative pair ordering accuracy within query groups
    (reference: ``PnpairEvaluator``, ``gserver/evaluators/Evaluator.cpp`` —
    counts correctly-ordered / mis-ordered / tied (pos, neg) score pairs per
    query). ``batch['query']`` gives group ids (defaults to one global
    group); groups must not span batches."""

    def __init__(self, name="pnpair"):
        self.name = name
        self.reset()

    def batch_stats(self, outputs, batch):
        score = outputs[..., 0] if outputs.dim() > 1 else outputs
        return {"score": score, "label": batch["label"],
                "query": batch.get("query", torch.zeros(
                    score.shape[0], dtype=torch.int32,
                    device=score.device))}

    def reset(self):
        self._correct = self._wrong = self._tie = 0.0

    def update(self, stats):
        s = np.asarray(stats["score"], np.float64)
        y = np.asarray(stats["label"])
        q = np.asarray(stats["query"])
        keep = y >= 0
        s, y, q = s[keep], y[keep], q[keep]
        # One lexsort for the whole batch, then per-group rank counting —
        # O(B log B) instead of a full-batch mask per query id. Within each
        # group, Mann-Whitney: correct + tie/2 = sum(pos ranks) - npos(npos+1)/2;
        # ties counted per equal-score block.
        order = np.lexsort((s, q))
        s, y, q = s[order], y[order], q[order]
        starts = np.flatnonzero(np.r_[True, q[1:] != q[:-1]])
        bounds = np.r_[starts, len(q)]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sg, yg = s[lo:hi], y[lo:hi]
            npos = int((yg == 1).sum())
            nneg = int((yg == 0).sum())
            if not npos or not nneg:
                continue
            # average 1-based ranks over tied blocks (sg already sorted)
            blk = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
            blk = np.r_[blk, len(sg)]
            ranks = np.repeat((blk[:-1] + blk[1:] + 1) / 2.0, np.diff(blk))
            bp = np.add.reduceat((yg == 1).astype(np.float64), blk[:-1])
            bn = np.add.reduceat((yg == 0).astype(np.float64), blk[:-1])
            tie = float((bp * bn).sum())
            u = ranks[yg == 1].sum() - npos * (npos + 1) / 2.0
            correct = u - 0.5 * tie
            self._correct += correct
            self._tie += tie
            self._wrong += npos * nneg - correct - tie

    def result(self):
        total = self._correct + self._wrong + self._tie
        acc = ((self._correct + 0.5 * self._tie) / total) if total else 0.5
        return {self.name: acc, "pnpair_pairs": total}


class ChunkEvaluator(Evaluator):
    """Chunk (NER span) F1 with IOB labeling (reference:
    ``ChunkEvaluator.cpp:294`` — plain-IOB scheme). Host-side extraction from
    predicted/gold tag sequences; stats stay device-friendly (tag arrays)."""

    def __init__(self, num_tag_types: int, scheme: str = "IOB",
                 name="chunk"):
        assert scheme == "IOB"
        self.name = name
        self.num_tag_types = num_tag_types
        self.reset()

    def batch_stats(self, outputs, batch):
        # outputs: predicted tags [B, T] (already decoded); pass through
        return {"pred": outputs, "gold": batch["label"],
                "length": batch["length"]}

    def _chunk_codes(self, tags, lengths):
        """Vectorized span extraction over the whole [B, T] batch (the
        reference computes chunk stats per batch in C++,
        ChunkEvaluator.cpp:294; a per-token Python loop would dominate the
        host loop on real corpora). Tag encoding (plain IOB): B-k = 2k,
        I-k = 2k+1, O = 2*num_tag_types. A chunk begins on a B- tag OR on an
        I-k tag with no active k-span (after O or a different type — the
        reference's ``isChunkBegin``, ChunkEvaluator.cpp:236). Returns one
        int64 code per chunk encoding (flat_start, flat_end, type); codes are
        unique since starts are."""
        tags = np.asarray(tags)
        B, T = tags.shape
        o_tag = 2 * self.num_tag_types
        valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
        tags = np.where(valid, tags, o_tag)
        is_o = tags >= o_tag
        typ = np.where(is_o, -1, tags // 2)
        is_b = (~is_o) & (tags % 2 == 0)
        prev_typ = np.concatenate([np.full((B, 1), -1), typ[:, :-1]], axis=1)
        prev_in = np.concatenate([np.zeros((B, 1), bool), ~is_o[:, :-1]],
                                 axis=1)
        # begin: B- tag, or any in-chunk tag not continuing the previous span
        begins = ~is_o & (is_b | ~(prev_in & (prev_typ == typ)))
        # a chunk ends at t unless t+1 continues it (in-chunk and not a begin)
        cont = ~is_o & ~begins
        next_cont = np.concatenate([cont[:, 1:], np.zeros((B, 1), bool)],
                                   axis=1)
        ends = ~is_o & ~next_cont
        flat_b = np.flatnonzero(begins)
        flat_e = np.flatnonzero(ends)
        # begins/ends interleave s1<=e1<s2<=e2… within each row and rows have
        # equal counts, so row-major flattening keeps the pairing aligned.
        types = typ.ravel()[flat_b]
        n = np.int64(B) * T + 1
        return (flat_b.astype(np.int64) * n + flat_e) * (
            self.num_tag_types + 1) + types

    def reset(self):
        self._correct = self._pred = self._gold = 0

    def update(self, stats):
        pred = np.asarray(stats["pred"])
        gold = np.asarray(stats["gold"])
        lengths = np.asarray(stats["length"])
        pc = self._chunk_codes(pred, lengths)
        gc = self._chunk_codes(gold, lengths)
        self._correct += len(np.intersect1d(pc, gc, assume_unique=True))
        self._pred += len(pc)
        self._gold += len(gc)

    def result(self):
        p = self._correct / max(1, self._pred)
        r = self._correct / max(1, self._gold)
        f1 = 2 * p * r / max(1e-9, p + r)
        return {"chunk_precision": p, "chunk_recall": r, "chunk_f1": f1}


def _collapse_ctc_path(path: np.ndarray, blank: int) -> np.ndarray:
    """Best-path → label string: drop blanks, merge repeats not separated by a
    blank (reference: ``CTCErrorEvaluator.cpp`` ``path2String``)."""
    if len(path) == 0:
        return path
    prev = np.concatenate([[blank], path[:-1]])
    keep = (path != blank) & ((path != prev) | (prev == blank))
    return path[keep]


def _edit_distance_matrix(gold: np.ndarray, gold_len: np.ndarray,
                          hyp: np.ndarray, hyp_len: np.ndarray) -> np.ndarray:
    """Levenshtein DP tables for a whole batch at once, [B, N+1, M+1].

    The left-to-right dependency ``d[i,j] = min(..., d[i,j-1]+1)`` is resolved
    without a scalar loop: with ``tmp[j] = min(d[i-1,j]+1, d[i-1,j-1]+cost)``,
    unrolling gives ``d[i,j] = min_{k<=j}(tmp[k]-k) + j`` — a running minimum,
    so each row is one ``np.minimum.accumulate`` over the batch. Rows (gold
    positions) remain a Python loop of length N.
    """
    B = gold.shape[0]
    N = int(gold_len.max(initial=0))
    M = int(hyp_len.max(initial=0))
    jj = np.arange(M + 1)
    D = np.empty((B, N + 1, M + 1), np.int32)
    D[:, 0, :] = jj[None, :]
    for i in range(1, N + 1):
        cost = (gold[:, i - 1][:, None] != hyp[:, :M]).astype(np.int32)
        prev = D[:, i - 1, :]
        tmp = np.empty((B, M + 1), np.int32)
        tmp[:, 0] = i
        np.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost, out=tmp[:, 1:])
        D[:, i, :] = np.minimum.accumulate(tmp - jj[None, :], axis=1) + jj
    return D


def _backtrace_counts(D: np.ndarray, n: int, m: int,
                      gold: np.ndarray, hyp: np.ndarray):
    """(substitutions, deletions, insertions) following the reference's
    tie-break order: match > substitution > deletion > insertion
    (``CTCErrorEvaluator.cpp`` ``stringAlignment`` backtrace). The match
    branch additionally requires the characters to be equal: a zero-cost
    diagonal tie with ``gold[i-1] != hyp[j-1]`` is NOT a match (it is
    reachable via a different path) and must fall through, or the
    sub/del/ins breakdown shifts relative to the reference."""
    i, j = n, m
    sub = dele = ins = 0
    while i and j:
        if D[i, j] == D[i - 1, j - 1] and gold[i - 1] == hyp[j - 1]:
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j - 1] + 1:
            sub += 1
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + 1:
            dele += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return sub, dele + i, ins + j


class CtcErrorEvaluator(Evaluator):
    """Sequence edit-distance error for CTC models (reference:
    ``CTCErrorEvaluator.cpp:318``, registered as ``ctc_edit_distance``).

    Per sequence: best-path decode the frame activations (argmax, collapse,
    blank = num_classes-1), align against the gold label sequence, and
    normalise distance and per-kind counts by ``max(len(gold), len(hyp))``.
    Reports error / deletion_error / insertion_error / substitution_error /
    sequence_error, all averaged over sequences, as the reference does.

    Expects ``outputs`` of shape [B, T, C] with frame lengths in
    ``batch['length']``, gold labels in ``batch['label']`` ([B, L], padded
    with -1) with lengths in ``batch['label_length']`` (defaults to counting
    non-negative labels).

    ``blank`` defaults to 0, matching this package's CTC stack
    (:func:`paddle_tpu.nn.ctc.ctc_loss`); the reference evaluator uses
    ``num_classes - 1`` — pass ``blank=-1`` to mean "last class".
    """

    def __init__(self, blank: int = 0, name="ctc_edit_distance"):
        self.name = name
        self.blank = blank
        self.reset()

    def batch_stats(self, outputs, batch):
        # argmax on the device; everything else is small host work
        blank = self.blank if self.blank >= 0 else outputs.shape[-1] - 1
        return {"path": torch.argmax(outputs, -1),
                "length": batch["length"],
                "label": batch["label"],
                "label_length": batch.get(
                    "label_length", (batch["label"] >= 0).sum(-1)),
                "blank": torch.full((), blank, dtype=torch.int32,
                                    device=outputs.device)}

    def reset(self):
        self._score = self._del = self._ins = self._sub = 0.0
        self._seq_err = 0
        self._num_seq = 0

    def update(self, stats):
        paths = np.asarray(stats["path"])
        lengths = np.asarray(stats["length"])
        labels = np.asarray(stats["label"])
        label_lens = np.asarray(stats["label_length"])
        blank = int(stats["blank"])
        B = paths.shape[0]
        hyps = [_collapse_ctc_path(paths[b, :lengths[b]], blank)
                for b in range(B)]
        hyp_len = np.array([len(h) for h in hyps], np.int32)
        M = int(hyp_len.max(initial=0))
        hyp = np.zeros((B, max(M, 1)), labels.dtype)
        for b, h in enumerate(hyps):
            hyp[b, :len(h)] = h
        D = _edit_distance_matrix(labels, label_lens, hyp, hyp_len)
        for b in range(B):
            n, m = int(label_lens[b]), int(hyp_len[b])
            if n == 0:
                sub, dele, ins = 0, 0, m
            elif m == 0:
                sub, dele, ins = 0, n, 0
            else:
                sub, dele, ins = _backtrace_counts(D[b], n, m,
                                                   labels[b], hyp[b])
            dist = sub + dele + ins
            max_len = max(1, n, m)
            self._score += dist / max_len
            self._sub += sub / max_len
            self._del += dele / max_len
            self._ins += ins / max_len
            self._seq_err += int(dist != 0)
            self._num_seq += 1

    def result(self):
        d = max(1, self._num_seq)
        return {"error": self._score / d,
                "deletion_error": self._del / d,
                "insertion_error": self._ins / d,
                "substitution_error": self._sub / d,
                "sequence_error": self._seq_err / d}


class SumEvaluator(Evaluator):
    """Sum of an output column, optionally weighted (reference:
    ``SumEvaluator``, ``Evaluator.cpp:180``)."""

    def __init__(self, name="sum"):
        self.name = name
        self.reset()

    def batch_stats(self, outputs, batch):
        v = outputs[..., 0] if outputs.dim() > 1 else outputs
        w = batch.get("weight", _ones(v.shape[0], v))
        return {"sum": (v * w).sum(), "count": w.sum()}

    def reset(self):
        self._sum = self._count = 0.0

    def update(self, stats):
        self._sum += float(stats["sum"])
        self._count += float(stats["count"])

    def result(self):
        # weights may sum below 1, so guard only against zero (unlike the
        # integer-count evaluators above)
        return {self.name: self._sum / (self._count if self._count else 1.0)}


class ColumnSumEvaluator(Evaluator):
    """Per-column mean of an output matrix (reference: ``ColumnSumEvaluator``,
    ``Evaluator.cpp:276``)."""

    def __init__(self, name="column_sum"):
        self.name = name
        self.reset()

    def batch_stats(self, outputs, batch):
        w = batch.get("weight", _ones(outputs.shape[0], outputs))
        return {"sum": (outputs * w[:, None]).sum(0), "count": w.sum()}

    def reset(self):
        self._sum = None
        self._count = 0.0

    def update(self, stats):
        s = np.asarray(stats["sum"], np.float64)
        self._sum = s if self._sum is None else self._sum + s
        self._count += float(stats["count"])

    def result(self):
        if self._sum is None:
            return {self.name: []}
        return {self.name:
                (self._sum / (self._count if self._count else 1.0)).tolist()}


class DetectionMAP(Evaluator):
    """Mean average precision for detection (reference:
    ``DetectionMAPEvaluator.cpp:306``, registered as ``detection_map``).

    Consumes fixed-shape detection output — ``outputs`` is the
    :class:`~paddle_tpu.nn.detection.DetectionOutput` tensor
    ``[B, K, 6]`` of ``(label, score, xmin, ymin, xmax, ymax)`` rows padded
    with label = -1 — and padded ground truth ``batch['gt_box'] [B, G, 4]``,
    ``batch['gt_label'] [B, G]`` (-1 padding), optional
    ``batch['gt_difficult'] [B, G]``. Matching, accumulation, and AP follow
    the reference exactly: per image/class greedy match by descending score
    with IoU strictly above ``overlap_threshold``, each gt creditable once;
    AP per class by '11point' (VOC2007) or 'Integral'; mAP averaged over
    classes with positives, scaled by 100.
    """

    def __init__(self, overlap_threshold: float = 0.5,
                 ap_type: str = "11point", evaluate_difficult: bool = False,
                 name="detection_map"):
        assert ap_type in ("11point", "Integral")
        self.name = name
        self.overlap_threshold = overlap_threshold
        self.ap_type = ap_type
        self.evaluate_difficult = evaluate_difficult
        self.reset()

    def batch_stats(self, outputs, batch):
        return {"det": outputs, "gt_box": batch["gt_box"],
                "gt_label": batch["gt_label"],
                "gt_difficult": batch.get(
                    "gt_difficult", torch.zeros(
                        batch["gt_label"].shape, dtype=torch.int32,
                        device=outputs.device))}

    def reset(self):
        self._num_pos = {}       # class -> gt count (non-difficult)
        self._pairs = {}         # class -> list of (score, is_tp)

    @staticmethod
    def _iou_matrix(a, b):
        """Vectorized pairwise IoU, [N,4] x [M,4] -> [N,M] (numpy mirror of
        ``paddle_tpu.nn.detection.iou_matrix``)."""
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.maximum(rb - lt, 0.0)
        inter = wh[..., 0] * wh[..., 1]
        area = lambda x: (np.maximum(x[:, 2] - x[:, 0], 0.0) *
                          np.maximum(x[:, 3] - x[:, 1], 0.0))
        union = area(a)[:, None] + area(b)[None, :] - inter
        return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)

    def update(self, stats):
        det = np.asarray(stats["det"])
        gt_box = np.asarray(stats["gt_box"])
        gt_label = np.asarray(stats["gt_label"])
        gt_diff = np.asarray(stats["gt_difficult"]).astype(bool)
        for b in range(det.shape[0]):
            valid_gt = gt_label[b] >= 0
            for c in np.unique(gt_label[b][valid_gt]):
                sel = valid_gt & (gt_label[b] == c)
                n = int(np.sum(sel & ~gt_diff[b])) if not \
                    self.evaluate_difficult else int(np.sum(sel))
                self._num_pos[int(c)] = self._num_pos.get(int(c), 0) + n
            dmask = det[b, :, 0] >= 0
            for c in np.unique(det[b][dmask, 0]).astype(int):
                rows = det[b][dmask & (det[b, :, 0] == c)]
                rows = rows[np.argsort(-rows[:, 1], kind="stable")]
                gsel = np.flatnonzero(valid_gt & (gt_label[b] == c))
                pairs = self._pairs.setdefault(int(c), [])
                visited = np.zeros(len(gsel), bool)
                iou_all = self._iou_matrix(rows[:, 2:6], gt_box[b][gsel]) \
                    if len(gsel) else None
                for r, score in enumerate(rows[:, 1]):
                    if len(gsel) == 0:
                        pairs.append((float(score), 0))
                        continue
                    ious = iou_all[r]
                    j = int(np.argmax(ious))
                    if ious[j] > self.overlap_threshold:
                        if not self.evaluate_difficult and \
                                gt_diff[b][gsel[j]]:
                            continue       # difficult match: ignored entirely
                        if not visited[j]:
                            pairs.append((float(score), 1))
                            visited[j] = True
                        else:
                            pairs.append((float(score), 0))
                    else:
                        pairs.append((float(score), 0))

    def result(self):
        aps = []
        for c, npos in self._num_pos.items():
            if npos == 0 or c not in self._pairs or not self._pairs[c]:
                continue
            pairs = sorted(self._pairs[c], key=lambda p: -p[0])
            tp = np.cumsum([p[1] for p in pairs])
            fp = np.cumsum([1 - p[1] for p in pairs])
            prec = tp / np.maximum(tp + fp, 1)
            rec = tp / npos
            if self.ap_type == "11point":
                ap = 0.0
                for t in np.arange(0.0, 1.01, 0.1):
                    mask = rec >= t
                    ap += (prec[mask].max() if mask.any() else 0.0) / 11.0
            else:
                dr = np.diff(np.concatenate([[0.0], rec]))
                ap = float(np.sum(prec * dr))
            aps.append(ap)
        return {self.name: 100.0 * float(np.mean(aps)) if aps else 0.0}


class _Printer(Evaluator):
    """Debug evaluators that log instead of scoring (reference printer
    family, ``Evaluator.cpp:1020-1357``). ``sink`` defaults to the module
    logger; pass e.g. ``print`` for tests."""

    def __init__(self, name, sink=None):
        self.name = name
        if sink is None:
            import logging
            sink = logging.getLogger("paddle_tpu_torch.evaluators").info
        self._sink = sink

    def reset(self):
        pass

    def update(self, stats):
        self._sink("%s: %s" % (self.name, self._format(stats)))

    def result(self):
        return {}


class ValuePrinter(_Printer):
    """Logs output value summaries (reference: ``ValuePrinter``)."""

    def __init__(self, name="value_printer", sink=None):
        super().__init__(name, sink)

    def batch_stats(self, outputs, batch):
        return {"mean": outputs.mean(), "abs_max": outputs.abs().max(),
                "shape": torch.tensor(outputs.shape, device=outputs.device)}

    def _format(self, stats):
        return "shape=%s mean=%.6g abs_max=%.6g" % (
            tuple(np.asarray(stats["shape"]).tolist()),
            float(stats["mean"]), float(stats["abs_max"]))


class MaxIdPrinter(_Printer):
    """Logs argmax ids per row (reference: ``MaxIdPrinter``)."""

    def __init__(self, name="max_id_printer", sink=None, limit=16):
        super().__init__(name, sink)
        self.limit = limit

    def batch_stats(self, outputs, batch):
        return {"ids": torch.argmax(outputs, -1)}

    def _format(self, stats):
        ids = np.asarray(stats["ids"]).ravel()[:self.limit]
        return "ids=%s" % (ids.tolist(),)


class SequenceTextPrinter(_Printer):
    """Maps id sequences through a vocabulary and logs the text (reference:
    ``SequenceTextPrinter``, ``Evaluator.cpp:1192``).

    Debugging tool, like the reference's whole printer family: ``_format``
    does per-token host-side Python string work on every batch it sees —
    attach it to small evaluation/inspection runs, never inside the hot
    training loop."""

    def __init__(self, vocab=None, name="seq_text_printer", sink=None):
        super().__init__(name, sink)
        self.vocab = vocab or {}

    def batch_stats(self, outputs, batch):
        return {"ids": outputs, "length": batch.get(
            "length", torch.full((outputs.shape[0],), outputs.shape[-1],
                                 device=outputs.device))}

    def _format(self, stats):
        ids = np.asarray(stats["ids"])
        lengths = np.asarray(stats["length"])
        rows = []
        for b in range(ids.shape[0]):
            toks = [str(self.vocab.get(int(i), int(i)))
                    for i in ids[b, :lengths[b]]]
            rows.append(" ".join(toks))
        return " | ".join(rows)


class EvaluatorSet:
    """Bundle of evaluators sharing one device round-trip per batch."""

    def __init__(self, *evaluators: Evaluator):
        self.evaluators = list(evaluators)

    def batch_stats(self, outputs, batch):
        return {ev.name: ev.batch_stats(outputs, batch)
                for ev in self.evaluators}

    def reset(self):
        for ev in self.evaluators:
            ev.reset()

    def update(self, stats):
        for ev in self.evaluators:
            ev.update(stats[ev.name])

    def result(self):
        out = {}
        for ev in self.evaluators:
            out.update(ev.result())
        return out
