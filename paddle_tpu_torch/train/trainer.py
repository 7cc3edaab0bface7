"""The training loop — the port of ``paddle_tpu/train/trainer.py``.

:class:`Trainer` runs optimizer steps over a reader's host batches: move
the batch to the device, forward with ``train=True``, reduce the
per-example loss (the ``weight``-weighted mean where the batch has a
``weight``), backward, one optimizer update applied to the parameters in
place. Events fire in the JAX order: ``BeginPass``, then per step
``BeginIteration`` and ``EndIteration``, then ``EndPass`` with the pass's
mean cost and, given a test reader, its test cost.

Ported from the JAX Trainer:

- ``steps_per_call=K``: K optimizer steps a call, grouped as the JAX
  ``_plan_group`` groups them; a call's K losses come to the host in one
  device-to-host copy, after which its events, logging and
  ``saving_period`` saves replay, so mid-pass saves land on call
  boundaries.
- ``grad_accum=M``: a step over M host batches (microbatches): the loss
  and the gradient are the mean of the M microbatch means, each weighted
  by its own ``weight``; the module state threads through the
  microbatches and the optimizer updates once. A pass's last step may
  take fewer.
- checkpoints (``train(checkpoint_dir=, checkpoint_keep=,
  checkpoint_async=, saving_period=, resume=)``, :meth:`Trainer.save`,
  :meth:`Trainer.restore`) in the JAX on-disk format, through
  ``utils/bridge.checkpoint_tree``: a directory either framework wrote
  restores in the other. ``resume`` loads the newest readable pass
  (quarantining poisoned ones), skips the consumed batches of an
  interrupted pass and warns when the reader's batch fingerprint differs
  from the one recorded.
- ``nan_check``: a non-finite loss raises ``FloatingPointError`` naming
  the non-finite parameters, and a group with one is never saved.
- ``request_stop(reason)`` and ``faults=``
  (:class:`~paddle_tpu_torch.train.faults.FaultSchedule`): a stop drains,
  saves at the next group boundary and raises
  :class:`~paddle_tpu_torch.train.faults.Preempted`.
- ``pipeline_depth=W`` (``train/host_pipeline.py``): a stager thread
  copies the next group to the card from pinned buffers on a side stream
  while up to W calls stay in flight with their losses unfetched; the
  plain K = 1, M = 1 loop defers its fetch the same way when
  ``nan_check`` is off. Bit-identical to the serial loop.
- ``train(rng=seed)``: dropout draws come from generators re-seeded
  before each step from ``(seed, step)``, under accumulation ``(seed,
  step, microbatch)``, so a resumed run draws the masks of the
  uninterrupted one. The masks differ from JAX's.
- ``evaluator=`` (``train/evaluators.py``): each step computes
  ``evaluator.batch_stats(outputs, batch)`` on the device, per
  microbatch under ``grad_accum`` (stacked ``[M]``) and stacked ``[K]``
  over a call's steps; a call's stats leave the card in the same
  device-to-host copy as its losses, so ``host_fetches`` does not grow.
  The host runs ``update`` per step (per microbatch), and ``result()``
  goes into each ``EndIteration``'s metrics and the pass's metrics beside
  ``mean_cost``; ``reset`` runs at each ``BeginPass``, and
  :meth:`Trainer.evaluate` returns the evaluator's metrics.

- observability (``obs/``): ``telemetry=`` (per-call step records with
  ``dispatch_ms``, fenced ``device_ms``, ``k_steps``, memory and the
  health scalars, which ride the call's loss fetch; compile and retrace
  records keyed by the step fingerprint; the pipelined loop's
  ``stage_ms``, ``drain_wait_ms`` and ``overlap_frac``), ``tracer=``
  (spans: plan, stack, device_put, dispatch, fence, drain, drain_wait,
  events_replay, checkpoint_save, eval; the stager thread's stage, stack
  and shard, flow-linked to the dispatch and drain), ``anomaly=`` (fed
  every step record; its verdicts are echoed as ``kind="anomaly"``
  records; an armed capture wraps the next call in a ``torch.profiler``
  window), ``metrics=`` (steps, step ms, tokens/s, loss) and
  ``param_stats_period`` (per-parameter scale logs). ``self.stats`` is
  the loop's :class:`~paddle_tpu_torch.utils.stats.StatSet`. With every
  hook None the loop launches what it launched before, records no CUDA
  event, synchronizes nothing and makes no extra fetch; the obs package
  is then not even imported.

Still refused, with an error: ``mesh``, ``param_sharding``, ``grad_sync``
and ``bucket_mb`` (multi-GPU is not ported). ``donate`` is taken and does
nothing: PyTorch runs eagerly and the optimizer already updates in place.

Dtype policy: a step runs under the caller's policy, as the JAX Trainer
traces its step under it (``bench.py`` wraps init and training in
``use_policy(bfloat16_compute)``): ``with use_policy(bfloat16_compute):
trainer.train(...)``. The forward reads the policy; the backward does
not (it may run on autograd's device thread). Parameters, gradients,
optimizer state and BatchNorm statistics stay f32 under every policy.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn.layers import Dropout
from ..optim.optimizers import apply_updates
from ..utils import bridge
from ..utils.stats import StatSet
from . import checkpoint as ckpt_lib
from . import events as ev
from .faults import Preempted
from .host_pipeline import FusedPipeline, StagedGroup, StagedUnit

__all__ = ["Trainer", "TrainState"]

_log = logging.getLogger("paddle_tpu_torch.trainer")

_NOT_PORTED = {
    "mesh": "multi-GPU training is not ported yet",
    "param_sharding": "multi-GPU training is not ported yet",
    "grad_sync": "multi-GPU training is not ported yet",
}


def _leaves(tree) -> List[Any]:
    """The leaves of a host batch in JAX's ``tree_leaves`` order (dict
    keys sorted), so fingerprints agree across frameworks."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _step_fingerprint(batch_tree) -> tuple:
    """The step fingerprint: per-leaf (shape, dtype name) of the batch
    feeding one call, in JAX's leaf order; a grouped call's leaves carry
    ``[K, M, ...]``, so K and M are in it too. The telemetry's retrace
    counter keys on exactly this tuple. Metadata only: device tensors are
    not read."""
    def dtype_name(leaf):
        if isinstance(leaf, torch.Tensor):
            return str(leaf.dtype).replace("torch.", "")
        return str(np.asarray(leaf).dtype)

    return tuple((tuple(np.shape(leaf)), dtype_name(leaf))
                 for leaf in _leaves(batch_tree))


def _tspan(tracer, name: str, **kw):
    """``tracer.span(...)``, or a no-op context without a tracer (the obs
    package's ``tspan``, kept here so the loop without hooks never
    imports it)."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **kw)


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)


def _batch_fingerprint(host_batch) -> int:
    """CRC32 of a host batch's raw bytes, recorded in mid-pass checkpoints
    so a resume can tell a nondeterministic reader (a shuffled reader
    replayed from scratch gives another batch at the same index)."""
    crc = 0
    for leaf in _leaves(host_batch):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(leaf)).tobytes(),
                         crc)
    return crc


def _batch_shapes(host_batch):
    """Leaf shapes of a host batch: a group's batches must stack."""
    return tuple(np.shape(leaf) for leaf in _leaves(host_batch))


def _tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict (evaluator stats)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees):
    """Stack same-shaped nested dicts of tensors on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _host_copy(tree):
    """A nested dict of device tensors on the host as numpy arrays, in ONE
    device-to-host copy: every leaf's bytes are packed into one uint8
    tensor on its device, copied, and cut back into arrays (16-bit floats
    are widened to f32 first: numpy has no bf16)."""
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, tree)
    flat = [(t.float() if t.dtype in (torch.bfloat16, torch.float16)
             else t).detach().reshape(-1) for t in leaves]
    buf = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = [], 0
    for t, f in zip(leaves, flat):
        dt = torch.empty(0, dtype=f.dtype).numpy().dtype
        n = f.numel() * dt.itemsize
        out.append(buf[off:off + n].copy().view(dt).reshape(tuple(t.shape)))
        off += n
    it = iter(out)
    return _tree_map(lambda _: next(it), tree)


def _seed_of(*path: int) -> int:
    """A 63-bit generator seed that is a function of ``path`` alone."""
    return int(np.random.SeedSequence(list(path)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class _CallExtras(NamedTuple):
    """What a call leaves beside its losses and stats: the last step's
    health scalars on the device, the call's partial step record (both
    None without telemetry) and the staged unit it ran on (None in the
    serial loop)."""
    health: Optional[Dict[str, torch.Tensor]]
    rec: Optional[Dict[str, Any]]
    unit: Any


class TrainState:
    """What training carries: the parameters and the module state (the
    model's buffers, such as BatchNorm's running statistics; the JAX
    ``TrainState.state``), both by name and the model's own tensors, the
    optimizer state and the step count. A ``train=True`` forward updates
    the module state in place, once per microbatch."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 state: Dict[str, torch.Tensor], opt_state: Any, step: int):
        self.params = params
        self.state = state
        self.opt_state = opt_state
        self.step = step


class Trainer:
    """Single-device training loop (see the module docstring for what is
    ported).

    Args:
      model: the ``nn.Module``, already on ``device``.
      loss_fn: ``(outputs, batch) -> per-example losses``, reduced by their
        mean, or by the ``batch["weight"]``-weighted mean when the batch
        has one.
      optimizer: a :class:`paddle_tpu_torch.optim.Optimizer`.
      forward: optional ``(model, batch, train) -> outputs`` for models
        with other inputs; the default feeds ``batch["x"]`` as
        ``model(x, train=train)``.
      donate: taken for the JAX signature; does nothing.
      nan_check: raise ``FloatingPointError`` on a non-finite loss, naming
        the parameters that hold non-finite values.
      steps_per_call: K optimizer steps a call (one loss fetch a call).
      grad_accum: M host batches a step, the mean of their means.
      pipeline_depth: W calls in flight, the next group staged by a
        thread (``train/host_pipeline.py``); 1 is the serial loop.
      evaluator: optional :class:`~paddle_tpu_torch.train.evaluators.
        Evaluator` or ``EvaluatorSet`` (see the module docstring).
      faults: optional :class:`~paddle_tpu_torch.train.faults.FaultSchedule`.
      device: where batches go (default ``"cuda"``).

      telemetry: optional :class:`~paddle_tpu_torch.obs.Telemetry` (see the
        module docstring); ``telemetry.fence`` fences the serial loops'
        calls on the compute stream, the pipelined loops record
        ``drain_wait_ms`` instead.
      tracer: optional :class:`~paddle_tpu_torch.obs.Tracer`.
      anomaly: optional :class:`~paddle_tpu_torch.obs.AnomalyDetector`
        (needs ``telemetry``).
      metrics: optional :class:`~paddle_tpu_torch.obs.MetricsHub` (or a
        scoped view of one).
      param_stats_period: log each parameter's scale every N batches.

    ``mesh``, ``param_sharding``, ``grad_sync`` and a ``bucket_mb`` other
    than its default raise ``NotImplementedError``.

    ``host_fetches`` counts the device-to-host copies of losses (with the
    evaluator's stats): one a call (a call is one step when K = 1).
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, mesh=None, forward: Optional[Callable] = None,
                 evaluator=None, param_sharding=None, donate: bool = True,
                 nan_check: bool = False,
                 param_stats_period: Optional[int] = None,
                 steps_per_call: int = 1, grad_accum: int = 1,
                 grad_sync: Optional[str] = None, bucket_mb: float = 4.0,
                 pipeline_depth: int = 1, telemetry=None, tracer=None,
                 anomaly=None, faults=None, metrics=None, device="cuda"):
        given = {"mesh": mesh, "param_sharding": param_sharding,
                 "grad_sync": grad_sync}
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"Trainer({name}=...): {_NOT_PORTED[name]}")
        if bucket_mb != 4.0:
            raise NotImplementedError(
                f"Trainer(bucket_mb=...): {_NOT_PORTED['grad_sync']}")
        if steps_per_call < 1 or grad_accum < 1:
            raise ValueError("steps_per_call and grad_accum must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if anomaly is not None and telemetry is None:
            raise ValueError(
                "AnomalyDetector consumes telemetry step records — pass "
                "telemetry=Telemetry(...) alongside anomaly=")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._forward = forward or self._default_forward
        self.evaluator = evaluator
        self._nan_check = nan_check
        self.steps_per_call = int(steps_per_call)
        self.grad_accum = int(grad_accum)
        self.pipeline_depth = int(pipeline_depth)
        self.faults = faults
        self.telemetry = telemetry
        self.tracer = tracer
        self.anomaly = anomaly
        self.metrics = metrics
        self._param_stats_period = param_stats_period
        self.stats = StatSet("trainer")
        self.device = resolve_device(device)
        self.train_state: Optional[TrainState] = None
        self.host_fetches = 0
        self.last_quarantined: list = []
        # a graceful-stop request: a bare attribute write, so it is safe
        # from signal handlers and other threads; read at group boundaries
        self._stop_requested: Optional[str] = None
        self._last_iter_state: Optional[Dict[str, Any]] = None
        self._last_restored_pass: Optional[int] = None
        self._seed = 0
        self._dropout_gens: Optional[List[torch.Generator]] = None
        self._copy_stream = None

    @staticmethod
    def _default_forward(model, batch, train):
        return model(batch["x"], train=train)

    # -- setup ---------------------------------------------------------------

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

    def _to_device(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """A host batch on the device. On the card each array goes through
        a pinned buffer with a non-blocking copy, so the host does not
        wait for the card here."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in host_batch.items()}
        out = {}
        for k, v in host_batch.items():
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v))
            if t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _stack(self, sub: List[Dict[str, Any]], k: int, m: int
               ) -> Dict[str, torch.Tensor]:
        """Stack ``k * m`` host batches into ``[k, m, ...]`` host tensors:
        pinned buffers when the batches go to the card."""
        out = {}
        for key in sub[0]:
            xs = [np.asarray(b[key]) for b in sub]
            if self.device.type != "cuda":
                out[key] = torch.from_numpy(
                    np.stack(xs).reshape((k, m) + xs[0].shape))
                continue
            buf = torch.empty((k, m) + xs[0].shape,
                              dtype=torch.from_numpy(
                                  np.empty(0, xs[0].dtype)).dtype,
                              pin_memory=True)
            np.stack(xs, out=buf.numpy().reshape((k * m,) + xs[0].shape))
            out[key] = buf
        return out

    def _copy(self, host: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """A stacked group on the device; on the card non-blocking copies
        from its pinned buffers on the current stream."""
        return {key: t.to(self.device, non_blocking=True)
                for key, t in host.items()}

    # -- one optimizer step --------------------------------------------------

    def _dropout_generators(self) -> List[torch.Generator]:
        """The distinct generators of the model's active dropouts (a
        generator shared by several layers counts once)."""
        if self._dropout_gens is None:
            gens, seen = [], set()
            for mod in self.model.modules():
                if isinstance(mod, Dropout) and mod.rate > 0:
                    if mod.generator is None:
                        mod.generator = torch.Generator(device=self.device)
                    if id(mod.generator) not in seen:
                        seen.add(id(mod.generator))
                        gens.append(mod.generator)
            self._dropout_gens = gens
        return self._dropout_gens

    def _seed_dropout(self, step: int, micro: Optional[int]) -> None:
        path = (self._seed, step) if micro is None \
            else (self._seed, step, micro)
        for i, g in enumerate(self._dropout_generators()):
            g.manual_seed(_seed_of(*path, i))

    def _loss(self, batch):
        """``(loss, stats)``: the batch's reduced loss and, with an
        evaluator, its stats on the device (else None)."""
        out = self._forward(self.model, batch, True)
        per_ex = self.loss_fn(out, batch)
        w = batch.get("weight")
        if w is not None:
            loss = (per_ex * w).sum() / w.sum().clamp_min(1e-9)
        else:
            loss = per_ex.mean()
        return loss, self._batch_stats(out, batch)

    def _batch_stats(self, out, batch):
        if self.evaluator is None:
            return None
        with torch.no_grad():          # no graph through the stats
            return self.evaluator.batch_stats(out, batch)

    def _health_on(self) -> bool:
        return self.telemetry is not None and self.telemetry.health

    def _opt_step(self, microbatches: List[Dict[str, torch.Tensor]],
                  health: bool = False):
        """One optimizer step over one batch, or the mean of the means of
        several; returns ``(loss, stats, health)`` (not synchronised): the
        evaluator's stats of the batch, stacked ``[M]`` over several, or
        None without an evaluator; with ``health`` the step's health
        scalars on the device (``obs/health.py``), else None."""
        ts = self.train_state
        for p in ts.params.values():
            p.grad = None
        M = len(microbatches)
        if M == 1:
            self._seed_dropout(ts.step, None)
            loss, stats = self._loss(microbatches[0])
            loss.backward()
            loss = loss.detach()
        else:
            # the gradients sum into .grad in microbatch order, as JAX's
            # accumulator does, then divide by M
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            per_mb = []
            for i, mb in enumerate(microbatches):
                self._seed_dropout(ts.step, i)
                lm, st = self._loss(mb)
                lm.backward()
                loss = loss + lm.detach()
                per_mb.append(st)
            loss = loss / M
            stats = None if self.evaluator is None else _tree_stack(per_mb)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in ts.params.items()}
        if M > 1:
            grads = {n: g / M for n, g in grads.items()}
        scalars = None
        if health:
            # Optimizer.apply is update + apply_updates: the same launches,
            # with the updates kept for their norm
            updates, ts.opt_state = self.optimizer.update(
                grads, ts.opt_state, ts.params, ts.step)
            apply_updates(ts.params, updates)
            from ..obs.health import health_scalars
            scalars = health_scalars(grads, updates, ts.params, loss)
        else:
            ts.opt_state = self.optimizer.apply(grads, ts.opt_state,
                                                ts.params, ts.step)
        ts.step += 1
        return loss, stats, scalars

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (not
        yet synchronised)."""
        return self._opt_step([batch])[0]

    def _fetch(self, losses: torch.Tensor, stats=None, health=None):
        """A call's losses, with the evaluator's stats and the health
        scalars when there are any, on the host in one device-to-host
        copy: ``(losses, stats, health)`` as numpy (None where absent)."""
        self.host_fetches += 1
        if stats is None and health is None:
            return losses.detach().cpu().numpy(), None, None
        tree = {"losses": losses}
        if stats is not None:
            tree["stats"] = stats
        if health is not None:
            tree["health"] = health
        host = _host_copy(tree)
        return host["losses"], host.get("stats"), host.get("health")

    # -- observability ------------------------------------------------------

    def _maybe_profiled_call(self, fn, *args):
        """Run one call, inside an anomaly-armed ``torch.profiler`` window
        when one is pending; a profiled call fences inside the window so
        the card's work lands in it. Returns ``(out, profiled)``."""
        prof_dir = (self.anomaly.take_profiler_request()
                    if self.anomaly is not None else None)
        if prof_dir is None:
            return fn(*args), False
        from ..obs.telemetry import fence
        from ..obs.trace import torch_profile
        with torch_profile(prof_dir):
            out = fn(*args)
            fence(self.device)
        return out, True

    def _fence_call(self, **span) -> Optional[float]:
        """With a fencing telemetry, wait for the compute stream's queued
        work (``obs.telemetry.fence``) and return the seconds waited (the
        call's ``device_ms``); else None, touching nothing."""
        tel = self.telemetry
        if tel is None or not tel.fence:
            return None
        from ..obs.telemetry import fence
        t0 = time.perf_counter()
        with _tspan(self.tracer, "fence", **span):
            fence(self.device)
        device_s = time.perf_counter() - t0
        self.stats.add("device_wait", device_s)
        return device_s

    def _emit_step(self, handler, rec: Dict[str, Any],
                   health_np=None) -> None:
        """Finalize one call's step record (the call's last step's health
        first), fire it as an event and feed the anomaly detector."""
        tel = self.telemetry
        if health_np is not None:
            tel.update_health(health_np)
        rec = tel.emit_step(rec)
        handler(ev.TelemetryRecord(record=rec))
        self._anomaly_observe(rec)

    def _anomaly_observe(self, rec) -> None:
        """Feed one finalized step record to the metrics and the anomaly
        detector. A detector failure is logged, never raised; verdicts are
        echoed into the telemetry stream as ``kind="anomaly"`` records."""
        if (self.metrics is not None and rec is not None
                and rec.get("kind") == "step"):
            m = self.metrics
            k = rec.get("k_steps") or 1
            m.counter("train_steps", "optimizer steps completed").inc(k)
            total_ms = ((rec.get("device_ms") or 0.0)
                        + (rec.get("dispatch_ms") or 0.0))
            if total_ms > 0:
                m.histogram("train_step_ms",
                            "per-step wall (device+dispatch) ms"
                            ).observe(total_ms / k)
            if rec.get("tokens_per_sec") is not None:
                m.gauge("train_tokens_per_sec",
                        "training token throughput"
                        ).set(rec["tokens_per_sec"])
            if rec.get("loss") is not None:
                m.gauge("train_loss", "last step loss").set(rec["loss"])
        if self.anomaly is None or rec is None:
            return
        try:
            verdicts = self.anomaly.observe(rec)
        except Exception:
            _log.exception("anomaly detector failed (training continues)")
            return
        if verdicts and self.telemetry is not None:
            for v in verdicts:
                try:
                    vd = v.to_dict()
                    vd["anomaly_kind"] = vd.pop("kind")
                    self.telemetry.emit_event({"kind": "anomaly", **vd})
                except Exception:
                    _log.exception("anomaly telemetry emit failed")

    def _anomaly_context(self) -> Dict[str, Any]:
        """The config/env snapshot frozen into a forensics bundle: the
        loop's settings, torch and CUDA, the card and the dtype policy."""
        from ..core.dtypes import current_policy
        cuda = self.device.type == "cuda"
        return {
            "model": type(self.model).__name__,
            "optimizer": type(self.optimizer).__name__,
            "steps_per_call": self.steps_per_call,
            "grad_accum": self.grad_accum,
            "pipeline_depth": self.pipeline_depth,
            "nan_check": self._nan_check,
            "host_step": (self.train_state.step
                          if self.train_state is not None else None),
            "device": str(self.device),
            "device_count": torch.cuda.device_count() if cuda else 0,
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if cuda else "cpu"),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "policy": repr(current_policy()),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("CUDA_", "TORCH_", "PYTORCH_"))},
        }

    def _log_stat_report(self, top_n: int = 8) -> None:
        """The periodic StatSet table at ``log_period``: INFO with
        telemetry attached, DEBUG otherwise."""
        lvl = logging.INFO if self.telemetry is not None else logging.DEBUG
        if _log.isEnabledFor(lvl):
            _log.log(lvl, "%s", self.stats.report(top_n=top_n))

    def _log_param_stats(self, pass_id: int, batch_id: int) -> None:
        """Per-parameter scale logs (``--show_parameter_stats_period``:
        max and mean absolute value, mean and std of each parameter)."""
        for name, p in self.train_state.params.items():
            arr = p.detach().float().cpu().numpy()
            _log.info(
                "param %s shape=%s abs_max=%.4g abs_avg=%.4g mean=%.4g "
                "std=%.4g (pass %d batch %d)", name, tuple(arr.shape),
                float(np.abs(arr).max(initial=0)), float(np.abs(arr).mean()),
                float(arr.mean()), float(arr.std()), pass_id, batch_id + 1)

    # -- checkpoints and preemption -------------------------------------------

    def _tree(self, it: Dict[str, Any]) -> Dict[str, Any]:
        return {**bridge.checkpoint_tree(self.train_state,
                                         bridge.jax_root(self.model)),
                "iter": it}

    def request_stop(self, reason: str = "requested") -> None:
        """Ask the loop to stop at the next group boundary: drain, write a
        checkpoint at that position, raise
        :class:`~paddle_tpu_torch.train.faults.Preempted`. Safe from a
        signal handler or another thread (it only writes an
        attribute)."""
        if self._stop_requested is None:
            self._stop_requested = reason
            _log.warning("graceful stop requested (%s): will stop at the "
                         "next group boundary", reason)

    def _fire_step_faults(self, step: int) -> None:
        """After one optimizer step's host replay: a scheduled crash
        raises; a scheduled preemption requests a stop."""
        fs = self.faults
        fs.maybe_crash_step(step)
        if fs.should_preempt(step):
            self.request_stop(f"injected preemption at step {step}")

    def _maybe_stop(self, pipe, pending, pass_id, next_batch, handler,
                    costs, log_period, checkpoint_dir, checkpoint_keep,
                    save_fn, last_batch=None) -> None:
        """The group-boundary stop: drain what is in flight, save at
        exactly ``next_batch`` consumed batches (with the last batch's
        fingerprint) and raise :class:`Preempted`. ``train()`` fences an
        async save before it unwinds."""
        if self._stop_requested is None:
            return
        reason = self._stop_requested
        if pipe is not None:
            pipe.flush()
        while pending:
            self._replay_plain(pending.pop(0), pass_id, handler, costs,
                               log_period, checkpoint_dir, checkpoint_keep,
                               save_fn)
        if checkpoint_dir:
            it = {"pass": pass_id, "next_batch": next_batch,
                  "completed": 0, "preempted": 1}
            if last_batch is not None:
                it["batch_crc"] = _batch_fingerprint(last_batch)
            with _tspan(self.tracer, "checkpoint_save",
                        preempt_next_batch=next_batch):
                save_fn(checkpoint_dir, pass_id, self._tree(it),
                        keep_last=checkpoint_keep)
        raise Preempted(pass_id=pass_id, next_batch=next_batch,
                        reason=reason)

    # -- the loop ------------------------------------------------------------

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_keep: int = 3,
              checkpoint_async: bool = False,
              saving_period: Optional[int] = None,
              log_period: int = 100, rng: Optional[int] = None,
              resume: bool = False) -> TrainState:
        """``num_passes`` passes over ``reader()`` (an iterable of host
        batches: dicts of arrays).

        ``checkpoint_dir``: a checkpoint after every pass (and every
        ``saving_period`` batches within one, on call boundaries), the
        newest ``checkpoint_keep`` kept; ``checkpoint_async`` writes them
        on a background thread after a host copy (fenced before ``train``
        returns). ``resume`` continues from the newest readable pass,
        mid-pass where the checkpoint says so. ``rng``: the dropout seed
        (default 0)."""
        if self.train_state is None:
            raise RuntimeError("call init() first")
        # a stop request is scoped to ONE train() call
        self._stop_requested = None
        self._seed = 0 if rng is None else int(rng)
        handler = event_handler or (lambda e: None)
        if self.anomaly is not None:
            # the flight recorder's trace ring and snapshot source
            self.anomaly.bind(tracer=self.tracer,
                              context_fn=self._anomaly_context)

        start_pass, skip_batches = 0, 0
        if resume and checkpoint_dir:
            if ckpt_lib.latest_pass(checkpoint_dir) is not None:
                try:
                    self.restore(checkpoint_dir)
                except FileNotFoundError as e:
                    self.last_quarantined = list(
                        getattr(e, "quarantined", []))
                    _log.warning(
                        "resume: no readable checkpoint remains under %s "
                        "after quarantine — starting from scratch",
                        checkpoint_dir)
                else:
                    it = self._last_iter_state
                    if it is not None and not int(it.get("completed", 1)):
                        start_pass = int(it["pass"])
                        skip_batches = int(it["next_batch"])
                    else:
                        start_pass = self._last_restored_pass + 1

        saver = None
        if checkpoint_async:
            saver = ckpt_lib.AsyncCheckpointer(telemetry=self.telemetry,
                                               faults=self.faults)
            save_fn = saver.save
        elif self.faults is not None:
            save_fn = functools.partial(ckpt_lib.save_checkpoint,
                                        faults=self.faults)
        else:
            save_fn = ckpt_lib.save_checkpoint
        try:
            return self._train_loop(reader, num_passes, handler, test_reader,
                                    checkpoint_dir, checkpoint_keep,
                                    saving_period, log_period, start_pass,
                                    skip_batches, save_fn)
        finally:
            if saver is not None:
                saver.close()          # fence the write in flight

    def _train_loop(self, reader, num_passes, handler, test_reader,
                    checkpoint_dir, checkpoint_keep, saving_period,
                    log_period, start_pass, skip_batches, save_fn):
        fused = self.steps_per_call > 1 or self.grad_accum > 1
        for pass_id in range(start_pass, num_passes):
            handler(ev.BeginPass(pass_id))
            if self.telemetry is not None:
                self.telemetry.begin_pass(pass_id)  # the per-pass peak
            if self.evaluator is not None:
                self.evaluator.reset()
            costs: List[float] = []
            pipe = None
            if fused and self.pipeline_depth > 1:
                if self.device.type == "cuda" and self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(device=self.device)
                pipe = FusedPipeline(
                    self, pass_id, handler, costs, log_period,
                    saving_period, checkpoint_dir, checkpoint_keep, save_fn,
                    depth=self.pipeline_depth)
            try:
                self._run_pass(reader, pass_id, start_pass, skip_batches,
                               pipe, handler, costs, log_period,
                               saving_period, checkpoint_dir,
                               checkpoint_keep, save_fn)
            finally:
                if pipe is not None:
                    pipe.close()
            pass_metrics = (self.evaluator.result()
                            if self.evaluator is not None else {})
            pass_metrics["mean_cost"] = float(np.mean(costs)) if costs \
                else 0.0
            if test_reader is not None:
                tc, tm = self.evaluate(test_reader)
                pass_metrics.update({f"test_{k}": v for k, v in tm.items()})
                pass_metrics["test_cost"] = tc
            if checkpoint_dir:
                with _tspan(self.tracer, "checkpoint_save", pass_end=pass_id):
                    save_fn(checkpoint_dir, pass_id,
                            self._tree({"pass": pass_id, "next_batch": 0,
                                        "completed": 1}),
                            keep_last=checkpoint_keep)
            handler(ev.EndPass(pass_id, pass_metrics))
            if self._stop_requested is not None:
                # too late for a group boundary: the pass checkpoint above
                # recorded completed=1, so resume starts the next pass
                raise Preempted(pass_id=pass_id + 1, next_batch=0,
                                reason=self._stop_requested)
        return self.train_state

    def _run_pass(self, reader, pass_id, start_pass, skip_batches, pipe,
                  handler, costs, log_period, saving_period, checkpoint_dir,
                  checkpoint_keep, save_fn):
        """One pass's batch loop (split out so the stager thread is always
        closed by the caller's ``finally``)."""
        fused = self.steps_per_call > 1 or self.grad_accum > 1
        group = self.steps_per_call * self.grad_accum
        # the plain loop defers its loss fetch only with nan_check off:
        # the trap must raise before the next step
        plain_deferred = (not fused and self.pipeline_depth > 1
                          and not self._nan_check)
        args = (pass_id, handler, costs, log_period, saving_period,
                checkpoint_dir, checkpoint_keep, save_fn)
        buf, buf_start = [], 0
        pending: List[Dict[str, Any]] = []
        for batch_id, host_batch in enumerate(reader()):
            if pass_id == start_pass and batch_id < skip_batches:
                # the resume skip; on its last batch, check the recorded
                # fingerprint: a mismatch means a nondeterministic reader
                if batch_id == skip_batches - 1:
                    want = (self._last_iter_state or {}).get("batch_crc")
                    if want is not None and \
                            _batch_fingerprint(host_batch) != int(want):
                        _log.warning(
                            "resume: reader replay diverged from the "
                            "checkpointed batch fingerprint at batch %d "
                            "— the reader is nondeterministic (shuffle/"
                            "buffered?); the resumed pass trains on a "
                            "different batch remainder than the "
                            "interrupted run", batch_id)
                continue
            if fused:
                # K*M host batches make a group; a shape change mid-group
                # (a ragged last batch) flushes it early
                if buf and _batch_shapes(host_batch) != \
                        _batch_shapes(buf[0]):
                    self._submit_group(pipe, buf, buf_start, *args)
                    buf = []
                if not buf:
                    buf_start = batch_id
                buf.append(host_batch)
                if len(buf) == group:
                    self._submit_group(pipe, buf, buf_start, *args)
                    buf = []
                    self._maybe_stop(pipe, pending, pass_id, batch_id + 1,
                                     handler, costs, log_period,
                                     checkpoint_dir, checkpoint_keep,
                                     save_fn, last_batch=host_batch)
                continue
            if plain_deferred:
                # make room BEFORE the step: at most pipeline_depth steps
                # in flight
                while len(pending) >= self.pipeline_depth:
                    self._replay_plain(pending.pop(0), pass_id, handler,
                                       costs, log_period, checkpoint_dir,
                                       checkpoint_keep, save_fn)
                pending.append(self._plain_dispatch(
                    host_batch, pass_id, batch_id, saving_period,
                    checkpoint_dir))
                if pending[-1]["boundary"]:
                    # the save needs the state at exactly this batch
                    while pending:
                        self._replay_plain(pending.pop(0), pass_id, handler,
                                           costs, log_period,
                                           checkpoint_dir, checkpoint_keep,
                                           save_fn)
                self._maybe_stop(None, pending, pass_id, batch_id + 1,
                                 handler, costs, log_period, checkpoint_dir,
                                 checkpoint_keep, save_fn,
                                 last_batch=host_batch)
                continue
            # the serial plain step: the deferred loop's dispatch, fenced,
            # then its bookkeeping at once (_replay_plain mirrors it)
            handler(ev.BeginIteration(pass_id, batch_id))
            entry = self._plain_dispatch(host_batch, pass_id, batch_id,
                                         saving_period, checkpoint_dir,
                                         fenced=True)
            loss_np, stats_np, health_np = self._fetch(
                entry["loss"], entry["stats"], entry["health"])
            cost = float(loss_np)
            if entry["rec"] is not None:
                self._emit_step(handler, dict(entry["rec"], loss=cost),
                                health_np)
            if self._nan_check and not np.isfinite(cost):
                self._raise_nonfinite(cost, pass_id, batch_id,
                                      self.train_state.step)
            costs.append(cost)
            metrics = self._update_metrics([stats_np])
            self._log_step(log_period, pass_id, batch_id, batch_id, cost,
                           metrics, health_np)
            if entry["boundary"]:
                with _tspan(self.tracer, "checkpoint_save",
                            next_batch=batch_id + 1):
                    save_fn(checkpoint_dir, pass_id,
                            self._tree({"pass": pass_id,
                                        "next_batch": batch_id + 1,
                                        "completed": 0,
                                        "batch_crc": entry["crc"]}),
                            keep_last=checkpoint_keep)
            handler(ev.EndIteration(pass_id, batch_id, self.train_state.step,
                                    cost, metrics))
            if self.faults is not None:
                self._fire_step_faults(self.train_state.step)
            self._maybe_stop(None, pending, pass_id, batch_id + 1, handler,
                             costs, log_period, checkpoint_dir,
                             checkpoint_keep, save_fn, last_batch=host_batch)
        if fused and buf:
            # a pass tail smaller than K*M: its last step may accumulate
            # fewer than M microbatches
            self._submit_group(pipe, buf, buf_start, *args)
        if pipe is not None:
            pipe.flush()
        while pending:
            self._replay_plain(pending.pop(0), pass_id, handler, costs,
                               log_period, checkpoint_dir, checkpoint_keep,
                               save_fn)

    def _raise_nonfinite(self, cost, pass_id, batch_id, step):
        bad = [n for n, p in self.train_state.params.items()
               if not torch.isfinite(p).all()]
        raise FloatingPointError(
            f"non-finite loss {cost} at pass {pass_id} batch {batch_id} "
            f"(step {step}); non-finite parameters: {bad[:8] or 'none'}")

    def _log_step(self, log_period, pass_id, first_id, last_id, cost,
                  metrics, health=None) -> None:
        """Log at every crossing of a ``log_period`` boundary by the host
        batches ``first_id..last_id`` of one step (with the evaluator's
        metrics and, on a call's last step, the health scalars), then the
        StatSet table; log the parameters' scales at every crossing of a
        ``param_stats_period`` boundary."""
        if log_period and (last_id + 1) // log_period > first_id // log_period:
            msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            if health:
                msg += " " + " ".join(
                    f"{k}={float(v):.3g}" for k, v in health.items())
            _log.info("pass %d batch %d cost=%.4f %s", pass_id, last_id + 1,
                      cost, msg)
            self._log_stat_report()
        psp = self._param_stats_period
        if psp and (last_id + 1) // psp > first_id // psp:
            self._log_param_stats(pass_id, last_id)

    def _plain_dispatch(self, host_batch, pass_id, batch_id, saving_period,
                        checkpoint_dir, fenced=False) -> Dict[str, Any]:
        """One plain step, unfetched: the pending entry ``_replay_plain``
        takes. ``fenced`` (the serial loop) fences the call with a fencing
        telemetry; the deferred loop does not (a fence would serialise its
        window), and its drain records ``drain_wait_ms``."""
        tel = self.telemetry
        is_new, fp = False, None
        if tel is not None:
            fp = ((1, 1),) + _step_fingerprint(host_batch)
            is_new = tel.observe_fingerprint(fp)
        t0 = time.perf_counter()
        with self.stats.time("shard_batch"), \
                _tspan(self.tracer, "device_put", batch=batch_id):
            batch = self._to_device(host_batch)
        t_disp = time.perf_counter()
        with self.stats.time("train_step"), \
                _tspan(self.tracer, "dispatch", batch=batch_id,
                       new_compile=is_new):
            (loss, stats, health), profiled = self._maybe_profiled_call(
                self._opt_step, [batch], self._health_on())
        t2 = time.perf_counter()
        device_s = self._fence_call(batch=batch_id) if fenced else None
        if is_new:
            tel.record_compile(fp, wall_s=(t2 - t_disp) + (device_s or 0.0),
                               meta={"k_steps": 1, "m": 1})
        boundary = bool(saving_period and checkpoint_dir
                        and (batch_id + 1) % saving_period == 0)
        rec = None
        if tel is not None:
            rec = {"pass": pass_id, "step": self.train_state.step,
                   "k_steps": 1, "m": 1, "profiled": profiled,
                   "host_stack_ms": None, "shard_ms": _ms(t_disp - t0),
                   "dispatch_ms": _ms(t2 - t_disp),
                   "device_ms": _ms(device_s), "replay_ms": None}
        return {"batch_id": batch_id, "step": self.train_state.step,
                "loss": loss, "stats": stats, "health": health, "rec": rec,
                "boundary": boundary,
                "crc": _batch_fingerprint(host_batch) if boundary else None}

    def _replay_plain(self, entry, pass_id, handler, costs, log_period,
                      checkpoint_dir, checkpoint_keep, save_fn):
        """The deferred bookkeeping of one plain step, in step order:
        Begin and EndIteration both fire here, as in the grouped loop; the
        fetch is the drain. ``nan_check`` is off on this path."""
        batch_id = entry["batch_id"]
        handler(ev.BeginIteration(pass_id, batch_id))
        t0 = time.perf_counter()
        with _tspan(self.tracer, "drain_wait", batch=batch_id):
            loss_np, stats_np, health_np = self._fetch(
                entry["loss"], entry["stats"], entry["health"])
        drain_wait = time.perf_counter() - t0
        self.stats.add("drain_wait", drain_wait)
        cost = float(loss_np)
        if entry["rec"] is not None:
            rec = entry["rec"]
            rec["loss"] = cost
            rec["drain_wait_ms"] = _ms(drain_wait)
            self._emit_step(handler, rec, health_np)
        costs.append(cost)
        metrics = self._update_metrics([stats_np])
        self._log_step(log_period, pass_id, batch_id, batch_id, cost,
                       metrics, health_np)
        if entry["boundary"]:
            # the boundary drained everything right after this step
            with _tspan(self.tracer, "checkpoint_save",
                        next_batch=batch_id + 1):
                save_fn(checkpoint_dir, pass_id,
                        self._tree({"pass": pass_id,
                                    "next_batch": batch_id + 1,
                                    "completed": 0,
                                    "batch_crc": entry["crc"]}),
                        keep_last=checkpoint_keep)
        handler(ev.EndIteration(pass_id, batch_id, entry["step"], cost,
                                metrics))
        if self.faults is not None:
            self._fire_step_faults(entry["step"])

    # -- grouped calls -------------------------------------------------------

    @staticmethod
    def _plan_group(n: int, m: int):
        """Split an n-batch group into calls: the full K x M part first,
        then the tail (whose last step may take fewer than M
        microbatches). Returns ``[(offset, take, m_eff)]``, shared by the
        serial loop and the stager thread."""
        plans, done = [], 0
        while done < n:
            rem = n - done
            take = (rem // m) * m or rem
            plans.append((done, take, m if take >= m else take))
            done += take
        return plans

    def _call(self, batches: Dict[str, torch.Tensor]):
        """One call: K optimizer steps over ``[K, M, ...]`` batches;
        returns the K losses stacked on the device, unfetched, the
        evaluator's stats stacked ``[K]`` (``[K, M]`` under accumulation;
        None without an evaluator) and, with health telemetry, the last
        step's health scalars (else None)."""
        k, m = next(iter(batches.values())).shape[:2]
        health_on = self._health_on()
        out = [self._opt_step([{key: t[i, j] for key, t in batches.items()}
                               for j in range(m)],
                              health=health_on and i == k - 1)
               for i in range(k)]
        losses = torch.stack([loss for loss, _, _ in out])
        stats = None if self.evaluator is None else \
            _tree_stack([st for _, st, _ in out])
        return losses, stats, out[-1][2]

    def _dispatch(self, host=None, stack_s=None, staged=None,
                  flow=None):
        """One call over a stacked group: ``host`` (stacked on this thread,
        copied here) or ``staged`` (a :class:`StagedUnit` the stager
        copied; the compute stream waits on its copies). A staged call is
        not fenced (the pipeline keeps it in flight; its drain records
        ``drain_wait_ms``). Returns ``(losses, stats, health, rec)``:
        ``rec`` the call's partial step record (None without
        telemetry)."""
        tel = self.telemetry
        if staged is None:
            t_sh = time.perf_counter()
            with self.stats.time("shard_batch"), \
                    _tspan(self.tracer, "device_put"):
                batches = self._copy(host)
            shard_s = time.perf_counter() - t_sh
        else:
            batches, stack_s, shard_s = (staged.batches, staged.stack_s,
                                         staged.shard_s)
            if staged.event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(staged.event)
                for t in batches.values():
                    t.record_stream(cur)
        is_new, fp = False, None
        if tel is not None:
            fp = _step_fingerprint(batches)
            is_new = tel.observe_fingerprint(fp)
        k, m = (int(n) for n in next(iter(batches.values())).shape[:2])
        t_disp = time.perf_counter()
        with self.stats.time("train_step"), \
                _tspan(self.tracer, "dispatch", flow_step=flow,
                       step=self.train_state.step, new_compile=is_new):
            (losses, stats, health), profiled = self._maybe_profiled_call(
                self._call, batches)
        dispatch_s = time.perf_counter() - t_disp
        device_s = self._fence_call() if staged is None else None
        if is_new:
            tel.record_compile(fp, wall_s=dispatch_s + (device_s or 0.0),
                               meta={"k_steps": k, "m": m})
        rec = None
        if tel is not None:
            rec = {"k_steps": k, "m": m, "profiled": profiled,
                   "host_stack_ms": _ms(stack_s), "shard_ms": _ms(shard_s),
                   "dispatch_ms": _ms(dispatch_s), "device_ms": _ms(device_s)}
            if staged is not None:
                # measured on the stager thread, off the loop's path
                rec["stage_ms"] = _ms(staged.stack_s + staged.shard_s)
        return losses, stats, health, rec

    def _submit_group(self, pipe, buf, buf_start, pass_id, handler, costs,
                      log_period, saving_period, checkpoint_dir,
                      checkpoint_keep, save_fn):
        if pipe is not None:
            pipe.submit(buf, buf_start)
            return
        results = []
        with _tspan(self.tracer, "plan", group=buf_start, batches=len(buf)):
            plans = self._plan_group(len(buf), self.grad_accum)
        for off, take, m_eff in plans:
            t_stack = time.perf_counter()
            with _tspan(self.tracer, "stack", group=buf_start, offset=off):
                host = self._stack(buf[off:off + take], take // m_eff, m_eff)
            stack_s = time.perf_counter() - t_stack
            self.stats.add("stack_group", stack_s)
            losses, stats, health, rec = self._dispatch(host=host,
                                                        stack_s=stack_s)
            results.append((buf_start + off, m_eff, losses, stats,
                            self.train_state.step,
                            _CallExtras(health, rec, None)))
        self._finalize_group(pass_id, buf_start, len(buf), results, handler,
                             costs, log_period, saving_period,
                             checkpoint_dir, checkpoint_keep, save_fn,
                             crc_fn=lambda: _batch_fingerprint(buf[-1]))

    def _stage_group_work(self, work):
        """Stage one raw group for the pipeline: every call's batches
        stacked and copied to the device. RUNS IN THE STAGER THREAD: on
        the card the copies go on the side stream, and an event marks
        them done. The group's flow id links this thread's ``stage`` span
        to the training thread's dispatch and drain."""
        buf, buf_start, boundary = work
        if self.faults is not None:
            # raises in this thread; surfaces in the training thread
            self.faults.maybe_stager_error(buf_start)
        cuda = self.device.type == "cuda"
        tracer = self.tracer
        flow = tracer.new_flow() if tracer is not None else None
        units = []
        with (torch.cuda.device(self.device) if cuda
              else contextlib.nullcontext()), \
                _tspan(tracer, "stage", flow_start=flow, group=buf_start,
                       batches=len(buf)):
            for off, take, m_eff in self._plan_group(len(buf),
                                                     self.grad_accum):
                t0 = time.perf_counter()
                with _tspan(tracer, "stack", group=buf_start, offset=off):
                    host = self._stack(buf[off:off + take], take // m_eff,
                                       m_eff)
                t1 = time.perf_counter()
                event = None
                with _tspan(tracer, "shard", group=buf_start, offset=off):
                    if cuda:
                        with torch.cuda.stream(self._copy_stream):
                            batches = self._copy(host)
                            event = torch.cuda.Event()
                            event.record(self._copy_stream)
                    else:
                        batches = self._copy(host)
                t2 = time.perf_counter()
                self.stats.add("stage_stack", t1 - t0)
                self.stats.add("stage_shard", t2 - t1)
                units.append(StagedUnit(off, m_eff, batches, event,
                                        list(host.values()), t1 - t0,
                                        t2 - t1))
        crc = _batch_fingerprint(buf[-1]) if boundary else None
        return StagedGroup(buf_start, len(buf), units, boundary, crc, flow)

    def _run_staged(self, buf_start, unit, flow=None):
        """One call over a staged unit, on the training thread (the compute
        stream waits for the unit's copies, and the copied tensors are
        marked as used by it). The unit (and so its pinned buffers) stays
        in the result until the group drains."""
        losses, stats, health, rec = self._dispatch(staged=unit, flow=flow)
        return (buf_start + unit.offset, unit.m_eff, losses, stats,
                self.train_state.step, _CallExtras(health, rec, unit))

    def _finalize_group(self, pass_id, buf_start, buf_len, results, handler,
                        costs, log_period, saving_period, checkpoint_dir,
                        checkpoint_keep, save_fn, crc_fn, drain_timing=False,
                        overlap_frac=None):
        """The bottom half of a group, shared by the serial loop and the
        pipeline's drain: fetch each call's losses, stats and health (one
        copy a call; with ``drain_timing`` the copy's wait is the call's
        ``drain_wait_ms``), the boundary checkpoint, then the events in
        order and each call's step record. With nan_check on, a
        non-finite loss anywhere in the group skips the save."""
        fetched = []
        for start, m_eff, losses, stats, step_after, extras in results:
            t0 = time.perf_counter()
            with (_tspan(self.tracer, "drain_wait", step=step_after)
                  if drain_timing else contextlib.nullcontext()):
                host = self._fetch(losses, stats, extras.health)
            rec = extras.rec
            if drain_timing:
                wait = time.perf_counter() - t0
                self.stats.add("drain_wait", wait)
                if rec is not None:
                    rec["drain_wait_ms"] = _ms(wait)
                    if overlap_frac is not None:
                        rec["overlap_frac"] = round(overlap_frac, 4)
            fetched.append((start, m_eff, *host, step_after, rec))
        end = buf_start + buf_len
        group_finite = (not self._nan_check) or all(
            np.isfinite(f[2]).all() for f in fetched)
        if saving_period and checkpoint_dir and group_finite and \
                (end // saving_period) > (buf_start // saving_period):
            with _tspan(self.tracer, "checkpoint_save", next_batch=end):
                save_fn(checkpoint_dir, pass_id,
                        self._tree({"pass": pass_id, "next_batch": end,
                                    "completed": 0, "batch_crc": crc_fn()}),
                        keep_last=checkpoint_keep)
        for start, m_eff, losses, stats, health, step_after, rec in fetched:
            t_replay = time.perf_counter()
            replay_ok = False
            try:
                with _tspan(self.tracer, "events_replay", step=step_after):
                    self._replay_call(pass_id, start, m_eff, losses, stats,
                                      health, step_after, handler, costs,
                                      log_period)
                replay_ok = True
            finally:
                # the record is emitted (and the detector fed) even when
                # nan_check's error unwinds the replay — a poisoned run is
                # exactly when the flight recorder must fire; a second
                # failure here must not mask the first
                if rec is not None:
                    try:
                        rec["pass"] = pass_id
                        rec["step"] = step_after
                        rec["loss"] = float(losses.ravel()[-1])
                        rec["replay_ms"] = _ms(time.perf_counter()
                                               - t_replay)
                        self._emit_step(handler, rec, health)
                    except Exception:
                        if replay_ok:
                            raise
                        _log.exception(
                            "telemetry emit failed during exception unwind "
                            "(the original error propagates)")

    def _replay_call(self, pass_id, start, m_eff, losses, stats, health,
                     step_after, handler, costs, log_period):
        """Replay one call's host bookkeeping, step by step; ``step_after``
        is the optimizer step count right after the call."""
        K = int(losses.shape[0])
        for k in range(K):
            first_id = start + k * m_eff
            last_id = first_id + m_eff - 1
            step = step_after - (K - 1 - k)
            handler(ev.BeginIteration(pass_id, last_id))
            cost = float(losses[k])
            if self._nan_check and not np.isfinite(cost):
                self._raise_nonfinite(cost, pass_id, last_id, step)
            costs.append(cost)
            metrics = {} if stats is None else self._update_metrics(
                [_tree_map(lambda x: x[k] if m_eff == 1 else x[k][m],
                           stats) for m in range(m_eff)])
            self._log_step(log_period, pass_id, first_id, last_id, cost,
                           metrics, health if k == K - 1 else None)
            handler(ev.EndIteration(pass_id, last_id, step, cost, metrics))
            if self.faults is not None:
                self._fire_step_faults(step)

    # -- evaluation and checkpoints ------------------------------------------

    @torch.no_grad()
    def evaluate(self, reader: Callable) -> Tuple[float, Dict[str, float]]:
        """Mean over batches of each batch's mean loss, with ``train``
        false (BatchNorm on its running statistics, which stay as they
        are), and the evaluator's metrics over the batches (it is reset
        first; ``{}`` without one)."""
        if self.evaluator is not None:
            self.evaluator.reset()
        costs = []
        with _tspan(self.tracer, "eval"):
            for host_batch in reader():
                batch = self._to_device(host_batch)
                out = self._forward(self.model, batch, False)
                costs.append(float(self.loss_fn(out, batch).float().mean()))
                if self.evaluator is not None:
                    self.evaluator.update(_host_copy(
                        self._batch_stats(out, batch)))
        metrics = self.evaluator.result() if self.evaluator is not None \
            else {}
        return (float(np.mean(costs)) if costs else 0.0), metrics

    def _update_metrics(self, stats_list) -> Dict[str, Any]:
        """The host half of a step: ``update`` with each microbatch's
        stats, then ``result()`` (``{}`` without an evaluator)."""
        if self.evaluator is None:
            return {}
        for st in stats_list:
            self.evaluator.update(st)
        return self.evaluator.result()

    def save(self, checkpoint_dir: str, pass_id: int) -> str:
        """Write the training state to ``checkpoint_dir/pass-NNNNN/`` in the
        JAX format (no iterator position)."""
        assert self.train_state is not None, "call init() first"
        return ckpt_lib.save_checkpoint(
            checkpoint_dir, pass_id,
            bridge.checkpoint_tree(self.train_state,
                                   bridge.jax_root(self.model)))

    def restore(self, checkpoint_dir: str, pass_id: Optional[int] = None
                ) -> TrainState:
        """Load a checkpoint of either framework into the model, the
        optimizer state and the step. ``pass_id=None`` loads the newest
        READABLE pass (``checkpoint.load_latest_valid``): poisoned
        directories are renamed to ``pass-NNNNN.corrupt`` and the previous
        pass loads instead (``last_quarantined`` lists what was moved). An
        explicit ``pass_id`` raises on corruption."""
        if self.train_state is None:
            self.init()
        if pass_id is None:
            loaded = ckpt_lib.load_latest_valid(checkpoint_dir)
        else:
            loaded = ckpt_lib.load_checkpoint(checkpoint_dir, pass_id)
        self.last_quarantined = loaded.pop("_quarantined", [])
        self._last_restored_pass = int(loaded["pass_id"])
        self._last_iter_state = loaded.get("iter")
        bridge.load_checkpoint_tree(self.train_state, self.model, loaded)
        return self.train_state
