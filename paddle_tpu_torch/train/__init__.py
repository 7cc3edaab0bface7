from . import events
from .events import (BeginIteration, BeginPass, EndIteration, EndPass,
                     TestResult)
from .trainer import Trainer, TrainState

__all__ = ["BeginIteration", "BeginPass", "EndIteration", "EndPass",
           "TestResult", "TrainState", "Trainer", "events"]
