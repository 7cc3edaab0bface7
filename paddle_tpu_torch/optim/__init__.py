from . import schedules
from .optimizers import (AdamState, Optimizer, adam, apply_updates, chain,
                         clip_by_global_norm, global_norm, momentum, sgd,
                         weight_decay)

__all__ = ["AdamState", "Optimizer", "adam", "apply_updates", "chain",
           "clip_by_global_norm", "global_norm", "momentum", "schedules",
           "sgd", "weight_decay"]
