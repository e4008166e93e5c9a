"""Host side of the split-K integer main loop (``kernels/include/int_dot.cuh``)
that the fused dot+AF and the cordic_mac kernels share: the tile
configuration and K split for a call, and its zeroed scratch.
"""
from __future__ import annotations

import functools
import math

import torch

# (BM, BN, BK) of the three tile configurations, by M (the header's dispatch_tiles)
CONFIGS = {0: (8, 128, 32), 1: (32, 128, 32), 2: (128, 128, 16)}
# split-K aims at about two blocks per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 264


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int):
    """``(config, splits, k_per_split)`` for an (M, K) x (K, N) call."""
    config = 0 if m <= 8 else (1 if m <= 32 else 2)
    bm, bn, bk = CONFIGS[config]
    k_tiles = max(1, math.ceil(k / bk))
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    splits = max(1, min(k_tiles, math.ceil(_TARGET_BLOCKS / tiles)))
    per = math.ceil(k_tiles / splits)
    splits = math.ceil(k_tiles / per)
    return config, splits, per * bk


def splitk_scratch(m: int, n: int, config: int, splits: int, device):
    """``(ws, tile_count)``: the zeroed uint32 partial sums and per-tile arrival
    counts of a split-K launch, or ``(None, None)`` when K is not split."""
    if splits == 1:
        return None, None
    bm, bn, _ = CONFIGS[config]
    scratch = torch.zeros((m * n + math.ceil(m / bm) * math.ceil(n / bn),), dtype=torch.int32,
                          device=device)
    return scratch[: m * n], scratch[m * n:]


def vector_loads(w: torch.Tensor) -> int:
    """1 when every row of the contiguous (K, N) integer weight allows 16-byte loads."""
    return int(w.shape[1] % (16 // w.element_size()) == 0 and w.data_ptr() % 16 == 0)


def ptr(t) -> int:
    """Device pointer of an optional tensor (``None`` -> null)."""
    return t.data_ptr() if t is not None else None
