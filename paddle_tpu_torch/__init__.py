"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper. It imports torch and numpy only; the JAX package ``paddle_tpu``
stays beside it as the reference the port is tested against. It serves a
``TransformerLM``, dense or mixture-of-experts (``DecodeEngine``), and
trains one (with ``remat``) or a ResNet (``Trainer``: grouped steps,
gradient accumulation, the host pipeline, evaluators, checkpoints in the
JAX format that restore in either framework, resume, faults and the
restart supervisor ``run_resilient``), with the observability of
``paddle_tpu_torch.obs`` (telemetry, tracing, metrics, SLOs, anomaly
bundles, run reports) wired through the Trainer, the engine and the
scheduler; multi-GPU training is not ported yet.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""

from .core import (Policy, bfloat16_compute, canonicalize, current_policy,
                   float32, resolve_device, use_policy)
from .models import (ResNet, TransformerBlock, TransformerLM, resnet50,
                     resnet_cifar)
from .nn.costs import softmax_cross_entropy
from .nn.fused_ln import fused_ln_matmul
from .nn.layers import set_conv1x1_impl
from .optim import (EMA, adadelta, adagrad, adam, adamax, chain,
                    clip_by_global_norm, clip_by_value, decayed_adagrad,
                    ftrl, l1_decay, lamb, momentum, polyak_average, rmsprop,
                    sgd, static_pruning, weight_decay)
from .serve import (ContinuousBatchingScheduler, DecodeEngine, Request,
                    SamplingConfig, blobs_to_pages, pages_to_blobs)
from .train import (EvaluatorSet, FaultSchedule, Preempted, Trainer,
                    run_resilient)
from .utils.bridge import (checkpoint_tree, export_jax_opt_state,
                           export_jax_params, jax_root, load_checkpoint_tree,
                           load_jax_opt_state, load_jax_params)

__all__ = ["ContinuousBatchingScheduler", "DecodeEngine", "EMA",
           "EvaluatorSet", "FaultSchedule", "Policy", "Preempted", "Request", "ResNet",
           "SamplingConfig", "Trainer", "TransformerBlock", "TransformerLM",
           "adadelta", "adagrad", "adam", "adamax", "bfloat16_compute",
           "blobs_to_pages", "canonicalize", "chain", "checkpoint_tree",
           "clip_by_global_norm", "clip_by_value", "current_policy",
           "decayed_adagrad", "export_jax_opt_state", "export_jax_params",
           "float32", "ftrl", "fused_ln_matmul", "jax_root", "l1_decay", "lamb",
           "load_checkpoint_tree", "load_jax_opt_state", "load_jax_params",
           "momentum", "pages_to_blobs", "polyak_average", "resnet50",
           "resnet_cifar", "resolve_device", "rmsprop", "run_resilient",
           "set_conv1x1_impl", "sgd", "softmax_cross_entropy",
           "static_pruning", "use_policy", "weight_decay"]
