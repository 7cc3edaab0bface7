"""Serving runtime: continuous batching over a paged KV cache."""

from .engine import AdmitProbe, DecodeEngine
from .kv_cache import (NULL_BLOCK, BlockAllocator, PagedKVCache, PrefixCache,
                       PrefixMatch, blobs_to_pages, dequantize_rows,
                       gather_pages, pages_to_blobs, quantize_rows,
                       scatter_prefill, scatter_prefill_pages,
                       scatter_span, scatter_span_pages, scatter_token,
                       scatter_token_pages)
from .sampling import SamplingConfig
from .scheduler import ORDERS, ContinuousBatchingScheduler, Request

__all__ = ["AdmitProbe", "BlockAllocator", "ContinuousBatchingScheduler",
           "DecodeEngine", "NULL_BLOCK", "PagedKVCache", "PrefixCache",
           "ORDERS", "PrefixMatch", "Request", "SamplingConfig",
           "blobs_to_pages", "dequantize_rows", "gather_pages",
           "pages_to_blobs", "quantize_rows", "scatter_prefill",
           "scatter_prefill_pages",
           "scatter_span", "scatter_span_pages", "scatter_token",
           "scatter_token_pages"]
