"""Training events — the port of ``paddle_tpu/train/events.py``: the
BeginPass/EndPass/BeginIteration/EndIteration callback surface, with cost
and metric results, that :class:`~paddle_tpu_torch.train.Trainer` fires.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "TestResult", "TelemetryRecord"]


@dataclasses.dataclass
class BeginPass:
    pass_id: int


@dataclasses.dataclass
class EndPass:
    pass_id: int
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


@dataclasses.dataclass
class EndIteration:
    pass_id: int
    batch_id: int
    step: int
    cost: float
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TestResult:
    pass_id: int
    cost: float
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TelemetryRecord:
    """One telemetry step record. The port has no telemetry yet, so its
    trainer never fires this event; it is kept for handlers written
    against the JAX package."""
    record: Dict[str, Any] = dataclasses.field(default_factory=dict)
