"""The training loop — the port of the plain serial loop of
``paddle_tpu/train/trainer.py`` (``Trainer._run_pass``'s serial body).

:class:`Trainer` runs one optimizer step per reader batch: move the host
batch to the device, forward with ``train=True``, reduce the per-example
loss, backward, one optimizer update applied to the parameters in place.
Events fire in the JAX order: ``BeginPass``, then per batch
``BeginIteration`` and ``EndIteration``, then ``EndPass`` with the pass's
mean cost and, given a test reader, its test cost.

Not ported yet, and so not accepted as arguments: ``steps_per_call``,
``grad_accum``, ``grad_sync``, ``pipeline_depth``, telemetry, tracer,
anomaly detection, faults, evaluators, ``param_sharding`` and
checkpoints. PyTorch runs eagerly, so there is no compiled step to build.

Dtype policy: a step runs under the caller's policy, as the JAX Trainer
traces its step under it (``bench.py`` wraps init and training in
``use_policy(bfloat16_compute)``): ``with use_policy(bfloat16_compute):
trainer.train(...)``. The forward reads the policy; the backward does
not (it may run on autograd's device thread). Parameters, gradients,
optimizer state and BatchNorm statistics stay f32 under every policy.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from . import events as ev

__all__ = ["Trainer", "TrainState"]

_log = logging.getLogger(__name__)


class TrainState:
    """What training carries: the parameters and the module state (the
    model's buffers, such as BatchNorm's running statistics; the JAX
    ``TrainState.state``), both by name and the model's own tensors, the
    optimizer state and the step count. A ``train=True`` forward updates
    the module state in place, once per step."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 state: Dict[str, torch.Tensor], opt_state: Any, step: int):
        self.params = params
        self.state = state
        self.opt_state = opt_state
        self.step = step


class Trainer:
    """Single-device training loop.

    Args:
      model: the ``nn.Module``, already on ``device``.
      loss_fn: ``(outputs, batch) -> per-example losses``, reduced by their
        mean, or by the ``batch["weight"]``-weighted mean when the batch
        has one.
      optimizer: a :class:`paddle_tpu_torch.optim.Optimizer`.
      forward: optional ``(model, batch, train) -> outputs`` for models
        with other inputs; the default feeds ``batch["x"]`` as
        ``model(x, train=train)``.
      nan_check: raise ``FloatingPointError`` on a non-finite loss, naming
        the parameters that hold non-finite values.
      device: where batches go (default ``"cuda"``).
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, forward: Optional[Callable] = None,
                 nan_check: bool = False, device="cuda"):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._forward = forward or self._default_forward
        self._nan_check = nan_check
        self.device = resolve_device(device)
        self.train_state: Optional[TrainState] = None

    @staticmethod
    def _default_forward(model, batch, train):
        return model(batch["x"], train=train)

    def _to_device(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host_batch.items()}

    def init(self, sample_batch: Optional[Dict[str, Any]] = None
             ) -> TrainState:
        """Build the optimizer state over the model's parameters and set
        the step to 0. The model already holds its parameters and buffers,
        so the sample batch is not needed; it is taken for the JAX
        signature."""
        params = dict(self.model.named_parameters())
        self.train_state = TrainState(params,
                                      dict(self.model.named_buffers()),
                                      self.optimizer.init(params), 0)
        return self.train_state

    def _loss(self, batch) -> torch.Tensor:
        out = self._forward(self.model, batch, True)
        per_ex = self.loss_fn(out, batch)
        w = batch.get("weight")
        if w is not None:
            return (per_ex * w).sum() / w.sum().clamp_min(1e-9)
        return per_ex.mean()

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (not
        yet synchronised)."""
        ts = self.train_state
        for p in ts.params.values():
            p.grad = None
        loss = self._loss(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in ts.params.items()}
        ts.opt_state = self.optimizer.apply(grads, ts.opt_state, ts.params,
                                            ts.step)
        ts.step += 1
        return loss.detach()

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              log_period: int = 100) -> TrainState:
        """``num_passes`` passes over ``reader()`` (an iterable of host
        batches: dicts of arrays), one optimizer step per batch."""
        if self.train_state is None:
            raise RuntimeError("call init() first")
        handler = event_handler or (lambda e: None)
        for pass_id in range(num_passes):
            handler(ev.BeginPass(pass_id))
            costs = []
            for batch_id, host_batch in enumerate(reader()):
                handler(ev.BeginIteration(pass_id, batch_id))
                cost = float(self.step(self._to_device(host_batch)))
                if self._nan_check and not np.isfinite(cost):
                    bad = [n for n, p in self.train_state.params.items()
                           if not torch.isfinite(p).all()]
                    raise FloatingPointError(
                        f"non-finite loss {cost} at pass {pass_id} batch "
                        f"{batch_id} (step {self.train_state.step}); "
                        f"non-finite parameters: {bad[:8] or 'none'}")
                costs.append(cost)
                if log_period and (batch_id + 1) % log_period == 0:
                    _log.info("pass %d batch %d cost=%.4f", pass_id,
                              batch_id + 1, cost)
                handler(ev.EndIteration(pass_id, batch_id,
                                        self.train_state.step, cost, {}))
            pass_metrics = {"mean_cost": float(np.mean(costs))
                            if costs else 0.0}
            if test_reader is not None:
                tc, tm = self.evaluate(test_reader)
                pass_metrics.update({f"test_{k}": v for k, v in tm.items()})
                pass_metrics["test_cost"] = tc
            handler(ev.EndPass(pass_id, pass_metrics))
        return self.train_state

    @torch.no_grad()
    def evaluate(self, reader: Callable) -> Tuple[float, Dict[str, float]]:
        """Mean over batches of each batch's mean loss, with ``train``
        false (BatchNorm on its running statistics, which stay as they
        are); no metrics yet (no evaluators are ported)."""
        costs = []
        for host_batch in reader():
            batch = self._to_device(host_batch)
            out = self._forward(self.model, batch, False)
            costs.append(float(self.loss_fn(out, batch).float().mean()))
        return (float(np.mean(costs)) if costs else 0.0), {}
