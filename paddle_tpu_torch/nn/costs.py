"""Cost functions — the port of ``softmax_cross_entropy`` and ``reduce``
from ``paddle_tpu/nn/costs.py``. Each cost maps ``(logits, labels)`` to a
per-example loss in float32 whatever the activation dtype; the trainer
reduces it. The other costs of the JAX module are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["reduce", "softmax_cross_entropy"]


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
    multiplied by 0). ``weight`` multiplies each example's loss."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = nll * valid.to(nll.dtype)
    return nll if weight is None else nll * weight
