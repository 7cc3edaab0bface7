from . import checkpoint, evaluators, events, faults, resilience
from .evaluators import EvaluatorSet
from .events import (BeginIteration, BeginPass, EndIteration, EndPass,
                     TestResult)
from .faults import (FaultSchedule, InjectedCrash, InjectedFault,
                     InjectedSaveError, Preempted)
from .resilience import (RunResult, SupervisorGaveUp, classify_failure,
                         install_preemption_handler, run_resilient)
from .trainer import Trainer, TrainState

__all__ = ["BeginIteration", "BeginPass", "EndIteration", "EndPass",
           "EvaluatorSet", "FaultSchedule", "InjectedCrash", "InjectedFault",
           "InjectedSaveError", "Preempted", "RunResult", "SupervisorGaveUp",
           "TestResult", "TrainState", "Trainer", "checkpoint",
           "classify_failure", "evaluators", "events", "faults",
           "install_preemption_handler", "resilience", "run_resilient"]
