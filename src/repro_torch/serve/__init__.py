"""Serving (PyTorch port): batched greedy server and KV-cache helpers."""
from .engine import BatchedServer, Request
from .kvcache import bucket_length, cache_positions, scatter_rows, with_cache_positions

__all__ = [
    "BatchedServer",
    "Request",
    "bucket_length",
    "cache_positions",
    "scatter_rows",
    "with_cache_positions",
]
