"""KV-cache index surgery for serving (port of ``repro.serve.kvcache``).

Caches are nested dicts; index leaves are identified as the reference
identifies them: integer dtype, stacked ``(layers, batch)`` shape. Unlike the
reference, these helpers write in place.
"""
from __future__ import annotations

import torch

__all__ = ["bucket_length", "cache_positions", "scatter_rows", "with_cache_positions"]


def _leaves(cache):
    if isinstance(cache, dict):
        for v in cache.values():
            yield from _leaves(v)
    else:
        yield cache


def _is_index(leaf) -> bool:
    return not leaf.is_floating_point() and leaf.ndim >= 2


def cache_positions(cache) -> torch.Tensor:
    """Per-slot committed row counts, ``(B,)`` int32 (layer 0 is authoritative)."""
    for leaf in _leaves(cache):
        if _is_index(leaf):
            return leaf[0]
    raise ValueError("cache carries no write index")


def with_cache_positions(cache, positions: torch.Tensor):
    """Set every layer's write index to ``positions`` ((B,) int32 on the
    cache's device), in place."""
    for leaf in _leaves(cache):
        if _is_index(leaf):
            leaf.copy_(positions.to(leaf.dtype).expand_as(leaf))
    return cache


def bucket_length(plen: int, max_len: int) -> int:
    """Next power-of-two block length for a ``plen``-token prompt, clamped to
    ``max_len``."""
    b = 1
    while b < plen:
        b *= 2
    return min(b, max_len)


def scatter_rows(full, row, slot: torch.Tensor):
    """Write a single-row cache into slot ``slot`` (an integer tensor of one
    element on the cache's device) of a multi-slot cache, in place. The one
    axis where the shapes differ is the slot axis."""
    if isinstance(full, dict):
        for k in full:
            scatter_rows(full[k], row[k], slot)
        return full
    src = row.to(full.dtype)
    if full.shape == src.shape:
        full.copy_(src)
        return full
    diff = [i for i, (a, b) in enumerate(zip(full.shape, src.shape)) if a != b]
    assert len(diff) == 1, (full.shape, src.shape)
    full.index_copy_(diff[0], slot.reshape(1).to(torch.int64), src)
    return full
