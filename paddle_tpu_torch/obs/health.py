"""Training-health scalars — the port of ``paddle_tpu/obs/health.py``:
global gradient norm, global parameter norm, update norm, update/param
ratio and a NaN/Inf sentinel.

The Trainer computes them on the device right after a call's last
optimizer step (f32 accumulation, an int32 non-finite count), and they
leave the card in the same device-to-host copy as the call's losses, so
monitoring adds no fetch. The norms run over the f32 parameters,
gradients and updates, after the backward pass (never inside a
``remat`` recompute).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

__all__ = ["HEALTH_KEYS", "tree_l2_norm", "tree_nonfinite_count",
           "health_scalars"]

# The fixed key set every health dict carries (the schema of the step
# record).
HEALTH_KEYS = ("grad_norm", "param_norm", "update_norm", "update_ratio",
               "nonfinite_count")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict/list of tensors (dict keys
    sorted, as JAX orders a pytree's leaves)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [] if tree is None else [tree]


@torch.no_grad()
def tree_l2_norm(tree, device=None) -> torch.Tensor:
    """Global L2 norm over every leaf (f32 accumulation): the per-leaf
    norms of one ``torch._foreach_norm`` (one multi-tensor launch on the
    card), then the norm of those."""
    leaves = [_f32(t) for t in _tensors(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(leaves, 2)))


@torch.no_grad()
def tree_nonfinite_count(tree, device=None) -> torch.Tensor:
    """Total count of NaN/Inf elements across every leaf (int32): one
    flat copy of the leaves and one count, whatever their number."""
    leaves = [_f32(t).reshape(-1) for t in _tensors(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.int32, device=device)
    return (~torch.isfinite(torch.cat(leaves))).sum(dtype=torch.int32)


@torch.no_grad()
def health_scalars(grads, updates, new_params, loss) -> Dict[str, Any]:
    """The per-step health dict of device scalars. ``update_ratio`` is
    ||update|| / ||param|| (healthy training sits around 1e-3; a collapse
    toward 0 or a blow-up toward 1 flags a bad learning rate). The
    sentinel counts the non-finite elements of the gradients plus the
    step loss."""
    gn = tree_l2_norm(grads, loss.device)
    pn = tree_l2_norm(new_params, loss.device)
    un = tree_l2_norm(updates, loss.device)
    bad = tree_nonfinite_count(grads, loss.device) + \
        (~torch.isfinite(_f32(loss))).to(torch.int32)
    return {
        "grad_norm": gn,
        "param_norm": pn,
        "update_norm": un,
        "update_ratio": un / torch.clamp(pn, min=1e-12),
        "nonfinite_count": bad,
    }
