"""Serving (PyTorch port): the batched server, its decode-burst and prefill
programs, per-slot sampling, KV-cache helpers and the streaming frontend."""
from .engine import (
    BatchedServer,
    Request,
    make_bucketed_prefill,
    make_chunk_admit,
    make_decode_burst,
    make_prefill_chunk,
    make_scan_chunk,
    sample,
    top2_margin,
)
from .frontend import AsyncFrontend, ContinuousScheduler, FrontendConfig, StreamHandle
from .kvcache import bucket_length, cache_positions, scatter_rows, with_cache_positions

__all__ = [
    "AsyncFrontend",
    "BatchedServer",
    "ContinuousScheduler",
    "FrontendConfig",
    "StreamHandle",
    "make_chunk_admit",
    "make_prefill_chunk",
    "make_scan_chunk",
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
