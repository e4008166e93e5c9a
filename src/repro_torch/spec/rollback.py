"""KV-cache rollback: truncate drafted rows past the accepted prefix (port of
``repro.spec.rollback``).

Truncation is an index rewrite: the per-query-causal mask makes rows at
positions ``>= index`` invisible, so rejected draft rows stay resident and
are overwritten by the next round. The helpers live in ``serve.kvcache`` and
write in place; a recurrent-state cache has no write index and is refused.
"""
from __future__ import annotations

from repro_torch.serve.kvcache import cache_positions, with_cache_positions

__all__ = ["cache_positions", "rollback", "with_cache_positions"]


def rollback(cache, committed):
    """Truncate each slot's cache to its ``committed`` row count ((B,) int32
    on the cache's device), in place."""
    return with_cache_positions(cache, committed)
