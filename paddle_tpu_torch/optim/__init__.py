from . import schedules
from .optimizers import (EMA, AdaDeltaState, AdamaxState, AdamState,
                         FtrlState, LambState, Optimizer, PruningState,
                         RMSPropState, adadelta, adagrad, adam, adamax,
                         apply_updates, chain, clip_by_global_norm,
                         clip_by_value, decayed_adagrad, ftrl, global_norm,
                         l1_decay, lamb, momentum, polyak_average, rmsprop,
                         sgd, static_pruning, weight_decay)

__all__ = ["AdaDeltaState", "AdamState", "AdamaxState", "EMA", "FtrlState",
           "LambState", "Optimizer", "PruningState", "RMSPropState",
           "adadelta", "adagrad", "adam", "adamax", "apply_updates", "chain",
           "clip_by_global_norm", "clip_by_value", "decayed_adagrad", "ftrl",
           "global_norm", "l1_decay", "lamb", "momentum", "polyak_average",
           "rmsprop", "schedules", "sgd", "static_pruning", "weight_decay"]
