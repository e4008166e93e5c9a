"""Host side of the integer dot shared by the fused dot+AF and the MAC-array
kernels: the K-major weight-bank layout, the path, tile and K split of a
call (``plan``), and its split-K scratch.

Paths (the sources' ``Path`` enum):

* ``NARROW``: int8 operands, M <= 16 (decode, the 16-row bucket): the
  streaming ``mma.sync`` loop of ``include/int_dot.cuh``, bound by the weight
  bytes;
* ``WGMMA``: int8 operands, M > 16 (prefill): TMA + ``wgmma`` on the int8
  tensor cores, ``include/int8_wgmma.cuh``. Measured on the H100 the two
  tie at M = 16 over an olmo-1b layer and wgmma is ~30 % faster at M = 32
  (PERF.md);
* ``IMAD``: any int16 operand (FxP16), any M: the int32 CUDA-core loop of
  ``include/int_dot.cuh``.

Every bank is K-major: the logical ``(K, N)`` weight is stored as N rows of
K (``stride == (1, K_pad)``), ``K_pad`` rounded up so that a row is a
multiple of 16 bytes, as Hopper's integer MMAs and TMA require.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

NARROW, WGMMA, IMAD = 0, 1, 2
# each path's name, as its kernel instantiations carry it
PATH_NAMES = ("narrow", "wgmma", "imad")
NARROW_MAX_M = 16
SMS = 132  # streaming multiprocessors of an H100 SXM

# the CUDA-core loop's (BM, BN, BK) by config (the header's dispatch_tiles)
IMAD_CONFIGS = {0: (8, 128, 32), 1: (32, 128, 32), 2: (128, 128, 16)}
# the wgmma loop's tile rows and widths (int8_wgmma.cuh WG_BM, BN)
WGMMA_BM, WGMMA_BNS = 128, (128, 256)
# the most waves of 128 x 128 tiles that the 128 x 256 tile still shortens
WGMMA_WIDE_WAVES = 4
# the narrow loop: 128 columns a block, K granted in 128-wide units, between
# 256 and 2048 of K a block (its x tile lives in shared memory)
NARROW_BN, NARROW_UNIT, NARROW_MIN_KPS, NARROW_MAX_KPS = 128, 128, 256, 2048
# the narrow and CUDA-core loops aim at about two blocks per SM
_TARGET_BLOCKS = 2 * SMS


class Plan(NamedTuple):
    path: int
    config: int  # NARROW: m-tiles of 8 rows (1, 2); WGMMA: tile width; IMAD: tile config
    splits: int  # WGMMA: always 1 (each block runs the whole of K)
    k_per_split: int  # elements of K a block
    bm: int  # output tile (one split-K arrival counter each)
    bn: int


def padded_k(k: int, elem: int) -> int:
    """K rounded up so that K elements of ``elem`` bytes fill whole 16-byte units."""
    per = 16 // elem
    return -(-k // per) * per


def k_major_empty(lead, k: int, n: int, dtype, device) -> torch.Tensor:
    """An uninitialised K-major bank: logical ``(*lead, K, N)``, stored as
    ``(*lead, N, K_pad)`` and viewed back (``stride[-2:] == (1, K_pad)``)."""
    store = torch.empty((*lead, n, padded_k(k, dtype.itemsize)), dtype=dtype, device=device)
    return store[..., :k].transpose(-1, -2)


def to_k_major(w: torch.Tensor) -> torch.Tensor:
    """A K-major copy of a ``(..., K, N)`` integer tensor (one copy)."""
    out = k_major_empty(tuple(w.shape[:-2]), w.shape[-2], w.shape[-1], w.dtype, w.device)
    out.copy_(w)
    return out


def is_k_major(w: torch.Tensor) -> bool:
    """True when the 2-D ``(K, N)`` ``w`` is stored K-major with 16-byte-aligned columns."""
    elem = w.element_size()
    return (w.ndim == 2 and (w.stride(0) == 1 or w.shape[0] == 1)
            and (w.stride(1) * elem) % 16 == 0 and w.data_ptr() % 16 == 0)


def has_aligned_rows(x: torch.Tensor) -> bool:
    """True when the 2-D ``(M, K)`` ``x`` has K contiguous and 16-byte-aligned rows."""
    elem = x.element_size()
    return (x.ndim == 2 and (x.stride(1) == 1 or x.shape[1] == 1)
            and (x.stride(0) * elem) % 16 == 0 and x.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, x_bytes: int = 1, w_bytes: int = 1) -> Plan:
    """The path, tiles and K split of an ``(M, K) x (K, N)`` call."""
    if x_bytes == 1 and w_bytes == 1:
        if m <= NARROW_MAX_M:
            return _narrow_plan(m, n, k)
        return _wgmma_plan(m, n, k)
    return _imad_plan(m, n, k)


def _narrow_plan(m: int, n: int, k: int) -> Plan:
    units = max(1, math.ceil(k / NARROW_UNIT))
    blocks_n = math.ceil(n / NARROW_BN)
    splits = min(math.ceil(_TARGET_BLOCKS / blocks_n),
                 max(1, units // (NARROW_MIN_KPS // NARROW_UNIT)))
    splits = max(splits, math.ceil(units * NARROW_UNIT / NARROW_MAX_KPS))
    per = math.ceil(units / splits)
    splits = math.ceil(units / per)
    return Plan(NARROW, 1 if m <= 8 else 2, splits, per * NARROW_UNIT, NARROW_MAX_M, NARROW_BN)


def _wgmma_plan(m: int, n: int, k: int) -> Plan:
    """128 x 256 tiles where 128 x 128 ones take between one and four waves
    of blocks, else 128 x 128: measured on the H100 (``chip_smoke.py``'s
    ``plan_alternatives``), the wide tile wins by a fifth there (fewer, fuller
    waves and fewer L2 bytes per product) and loses up to a tenth with many
    waves or one. K is never split: the split cost more than the idle SMs it
    filled at every shape measured (PERF.md)."""
    tiles = math.ceil(m / WGMMA_BM) * math.ceil(n / 128)
    bn = 256 if SMS < tiles <= WGMMA_WIDE_WAVES * SMS else 128
    return Plan(WGMMA, bn, 1, max(1, k), WGMMA_BM, bn)


def _imad_plan(m: int, n: int, k: int) -> Plan:
    config = 0 if m <= 8 else (1 if m <= 32 else 2)
    bm, bn, bk = IMAD_CONFIGS[config]
    k_tiles = max(1, math.ceil(k / bk))
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    splits = max(1, min(k_tiles, math.ceil(_TARGET_BLOCKS / tiles)))
    per = math.ceil(k_tiles / splits)
    return Plan(IMAD, config, math.ceil(k_tiles / per), per * bk, bm, bn)


_counters = {}


def splitk_scratch(m: int, n: int, p: Plan, device):
    """``(ws, tile_count)`` of a split-K launch: the uint32 slices of the
    partial sums (``splits x M x N``, written before they are read) and the
    per-tile arrival counters, or ``(None, None)`` when K is not split. The
    counters are one zeroed buffer per device that every kernel leaves at
    zero (the last block of a tile resets its counter), so a launch needs no
    memset and a captured CUDA graph replays as it ran."""
    if p.splits == 1:
        return None, None
    tiles = math.ceil(m / p.bm) * math.ceil(n / p.bn)
    key = str(device)
    counters = _counters.get(key)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros((max(tiles, 4096),), dtype=torch.int32, device=device)
        _counters[key] = counters
    return torch.empty((p.splits * m * n,), dtype=torch.int32, device=device), counters


def ptr(t) -> int:
    """Device pointer of an optional tensor (``None`` -> null)."""
    return t.data_ptr() if t is not None else None
