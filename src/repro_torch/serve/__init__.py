"""Serving (PyTorch port): the batched server, its decode-burst and prefill
programs, per-slot sampling and KV-cache helpers."""
from .engine import (
    BatchedServer,
    Request,
    make_bucketed_prefill,
    make_decode_burst,
    sample,
    top2_margin,
)
from .kvcache import bucket_length, cache_positions, scatter_rows, with_cache_positions

__all__ = [
    "BatchedServer",
    "Request",
    "bucket_length",
    "cache_positions",
    "make_bucketed_prefill",
    "make_decode_burst",
    "sample",
    "scatter_rows",
    "top2_margin",
    "with_cache_positions",
]
