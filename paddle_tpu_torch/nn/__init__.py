from .attention import MultiHeadAttention
from .cuda_attention import (flash_attention, flash_attention_fwd,
                             launch_counts, paged_decode_attention,
                             paged_span_attention, reset_launch_counts)
from .costs import reduce, softmax_cross_entropy
from .cuda_conv import conv1x1, conv1x1_dw, conv1x1_strided
from .fused_ln import fused_ln_matmul, ln_matmul_reference
from .layers import (BatchNorm, Conv2D, Dropout, Embedding, GlobalPool,
                     LayerNorm, Linear, Pool2D, set_conv1x1_impl)
from .moe import MoEFFN
from . import activations, costs

__all__ = ["BatchNorm", "Conv2D", "Dropout", "Embedding", "GlobalPool",
           "LayerNorm", "Linear", "MoEFFN", "MultiHeadAttention", "Pool2D",
           "activations", "conv1x1", "costs",
           "conv1x1_dw", "conv1x1_strided", "flash_attention",
           "flash_attention_fwd", "fused_ln_matmul", "launch_counts",
           "ln_matmul_reference", "paged_decode_attention",
           "paged_span_attention", "reduce", "reset_launch_counts",
           "set_conv1x1_impl", "softmax_cross_entropy"]
