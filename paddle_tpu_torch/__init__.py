"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper. It imports torch and numpy only; the JAX package ``paddle_tpu``
stays beside it as the reference the port is tested against. It serves a
``TransformerLM`` (``DecodeEngine``) and trains one or a ResNet
(``Trainer``).

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
from .optim import (adam, chain, clip_by_global_norm, momentum, sgd,
                    weight_decay)
from .serve import (ContinuousBatchingScheduler, DecodeEngine, Request,
                    SamplingConfig, blobs_to_pages, pages_to_blobs)
from .train import Trainer
from .utils.bridge import (export_jax_opt_state, export_jax_params,
                           load_jax_opt_state, load_jax_params)

__all__ = ["ContinuousBatchingScheduler", "DecodeEngine", "Policy",
           "Request", "ResNet", "SamplingConfig", "Trainer",
           "TransformerBlock", "TransformerLM", "adam", "bfloat16_compute",
           "canonicalize", "chain", "clip_by_global_norm", "current_policy",
           "float32", "export_jax_opt_state", "export_jax_params",
           "fused_ln_matmul", "load_jax_opt_state", "load_jax_params",
           "momentum", "blobs_to_pages", "pages_to_blobs", "resnet50",
           "resnet_cifar", "resolve_device",
           "set_conv1x1_impl", "sgd", "softmax_cross_entropy", "use_policy",
           "weight_decay"]
