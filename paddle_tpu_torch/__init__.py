"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper. It imports torch and numpy only; the JAX package ``paddle_tpu``
stays beside it as the reference the port is tested against. It serves a
``TransformerLM`` (``DecodeEngine``) and trains one (``Trainer``).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""

from .core import Policy, current_policy, resolve_device, use_policy
from .models import TransformerBlock, TransformerLM
from .nn.costs import softmax_cross_entropy
from .optim import (adam, chain, clip_by_global_norm, momentum, sgd,
                    weight_decay)
from .serve import ContinuousBatchingScheduler, DecodeEngine, Request
from .train import Trainer
from .utils.bridge import (export_jax_opt_state, export_jax_params,
                           load_jax_opt_state, load_jax_params)

__all__ = ["ContinuousBatchingScheduler", "DecodeEngine", "Policy",
           "Request", "Trainer", "TransformerBlock", "TransformerLM", "adam",
           "chain", "clip_by_global_norm", "current_policy",
           "export_jax_opt_state", "export_jax_params",
           "load_jax_opt_state", "load_jax_params", "momentum",
           "resolve_device", "sgd", "softmax_cross_entropy", "use_policy",
           "weight_decay"]
