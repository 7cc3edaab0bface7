from .attention import MultiHeadAttention
from .cuda_attention import (flash_attention, flash_attention_fwd,
                             launch_counts, paged_decode_attention,
                             paged_span_attention, reset_launch_counts)
from .costs import reduce, softmax_cross_entropy
from .layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "flash_attention", "flash_attention_fwd", "launch_counts",
           "paged_decode_attention", "paged_span_attention", "reduce",
           "reset_launch_counts", "softmax_cross_entropy"]
