"""Wrappers of the cache-decode attention kernels.

* ``gqa_decode_attention`` (``csrc/decode_attention.cu``) replaces the TPU
  kernel ``repro/kernels/decode_attention/kernel.py:_gqa_decode_kernel``
  (``gqa_decode``). :func:`gqa_plan` picks one of its two paths: at
  ``S >= TC_MIN_S`` (a prefill bucket, bound by its multiply-adds) the
  tensor-core tile loop of ``include/gqa_tile.cuh`` (3xTF32 ``mma.sync``,
  64 query rows a block); below (decode, bursts, small buckets, bound by the
  bytes of the K and V cache) the split-key path, which spreads each (batch
  row, kv head)'s key tiles over :func:`gqa_splits` blocks and merges their
  partial softmaxes in a second pass. Both skip the tiles past the block's
  last query position.
* ``mla_decode_attention`` (``csrc/mla_decode.cu``) replaces
  ``_mla_decode_kernel`` (``mla_decode``), the absorbed-form MLA decode. At
  full width it is bound by its multiply-adds; one block takes one query row
  and 32 of its heads as the rows of a tensor-core tile loop
  (``include/mla_attention.cuh``: 3xTF32 ``mma.sync``, shared with the MLA
  flash kernel), which serves all of them from each shared-memory tile of
  the latent cache, where the Pallas grid re-read the cache once per head,
  and splits the keys across blocks when there are too few (query, head
  block) blocks to fill the card (:func:`mla_splits`).

A CPU tensor runs the plain version (``*_ref``); a CUDA tensor launches the
kernel or raises; a meta tensor takes the plan and returns an empty meta
result. Each wrapper's ``launches`` counts its launches,
``instantiations`` them by path. Against the plain versions the outputs
agree to f32 reduction-order tolerance
(:data:`TOLERANCE`): the kernels sum scores and P·V in another order and
rescale per tile, and the tensor-core loops' 3xTF32 products keep about f32
accuracy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build, costs, entry, kernel_call
from .ref import gqa_decode_attention_ref, mla_decode_attention_ref

HEAD_DIMS = (32, 64, 112, 128)
# max |kernel - plain| allowed on unit-scale f32 inputs: a few ulps of
# reduction-order drift, with headroom
TOLERANCE = 2e-5


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gqa_decode_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                                      ctypes.c_float, p]
    lib.gqa_decode_launch.restype = i
    f = ctypes.c_float
    lib.mla_decode_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.mla_decode_launch.restype = i
    return lib


# the GQA kernel's paths: the tensor-core tile loop from TC_MIN_S query rows
# on (a 16-row MMA fragment), the split-key CUDA-core loop below. On the H100
# (chip_smoke.py's gqa_path_alternatives, PERF.md) the split keys were faster
# at decode and at bursts of 4 to 16 rows over a long key range, the tensor
# cores at prefill buckets (few keys) from 4 rows on; the host cannot see the
# positions, and 16 keeps every decode step and burst below it on the split
# keys and every prefill bucket from 16 rows on the tensor cores
TC_MIN_S = 16
TENSOR_CORES, SPLIT_KEYS = "tensor cores", "split keys"
# split-key geometry (csrc/decode_attention.cu): query rows per block, keys
# per tile
_GQA_ROWS_PER_BLOCK, _GQA_TILE = 16, 32
# split the keys across blocks until about two blocks per SM of an H100
_TARGET_BLOCKS = 264


class GqaPlan(NamedTuple):
    path: str    # TENSOR_CORES or SPLIT_KEYS
    splits: int  # key splits per (batch row, kv head, row block); 1 on the tensor cores


def _splits(blocks: int, n_tiles: int, target: int = _TARGET_BLOCKS) -> int:
    """Blocks to spread each of ``blocks`` blocks' ``n_tiles`` key tiles over:
    enough for about ``target`` blocks, at most one per key tile, and no
    split left without a tile."""
    if blocks >= target // 2:
        return 1
    splits = max(1, min(-(-target // blocks), n_tiles))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per)


def gqa_splits(b: int, s: int, h: int, t: int, kv: int) -> int:
    """Blocks the split-key path spreads each (batch row, kv head, 16-row
    group)'s key tiles over (split i takes tiles i, i + splits, ...).
    Counted from the row blocks of one query step, whatever ``s``: a
    query's result then does not depend on the rows it rides with, so a
    multi-token verify gives each position the bits of its single-token
    decode."""
    del s
    blocks = b * kv * -(-(h // kv) // _GQA_ROWS_PER_BLOCK)
    return _splits(blocks, -(-t // _GQA_TILE))


def gqa_plan(b: int, s: int, h: int, t: int, kv: int) -> GqaPlan:
    """The path and key splits of one GQA cache-attention call."""
    if s >= TC_MIN_S:
        return GqaPlan(TENSOR_CORES, 1)
    return GqaPlan(SPLIT_KEYS, gqa_splits(b, s, h, t, kv))


def head_map(h: int, kv: int, head_offset: int = 0, groups=None, name: str = "attention"):
    """``(groups, kv heads read)`` of a call whose ``h`` q heads, from global
    q head ``head_offset`` on, read kv head (head_offset + i) // groups of
    ``kv``; ``groups`` None: a whole call (h % kv == 0, groups = h // kv)."""
    if groups is None:
        if head_offset or h % kv:
            raise ValueError(f"{name}: {h} q heads over {kv} kv heads need groups=")
        return h // kv, kv
    if head_offset < 0 or groups < 1 or (head_offset + h - 1) // groups >= kv:
        raise ValueError(f"{name}: q heads {head_offset}..{head_offset + h - 1} at {groups} a "
                         f"kv head read past {kv} kv heads")
    return groups, (head_offset + h - 1) // groups - head_offset // groups + 1


def _launch(q, ck, cv, positions, scale: float, plan_dims=None, head_offset: int = 0,
            groups=None):
    dev = q.device
    for name, t in (("ck", ck), ("cv", cv), ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"gqa_decode_attention: q on {dev}, {name} on {t.device}")
    b, s, h, hd = q.shape
    _, t_len, kv, hd2 = ck.shape
    if cv.shape != ck.shape or hd2 != hd or ck.shape[0] != b or s == 0 or t_len == 0:
        raise ValueError(f"gqa_decode_attention: q {tuple(q.shape)}, ck {tuple(ck.shape)}, "
                         f"cv {tuple(cv.shape)}")
    groups, kv_read = head_map(h, kv, head_offset, groups, "gqa_decode_attention")
    if hd not in HEAD_DIMS:
        raise ValueError(f"gqa_decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype != torch.float32 or ck.dtype != torch.float32 or cv.dtype != torch.float32:
        raise ValueError("gqa_decode_attention: the kernel takes f32 queries and caches")
    if positions.shape != (b, s) or positions.dtype != torch.int32:
        raise ValueError("gqa_decode_attention: positions must be int32 (B, S)")
    q, ck, cv, positions = (t.contiguous() for t in (q, ck, cv, positions))
    if any(t.data_ptr() % 16 for t in (q, ck, cv)):
        raise ValueError("gqa_decode_attention: the kernel copies in 16-byte pieces; q, ck "
                         "and cv must be 16-byte aligned")
    out = torch.empty_like(q)
    # by default the plan counts the whole call's q heads (kv * groups)
    pb, ph, pkv = plan_dims if plan_dims is not None else (b, kv * groups, kv)
    path, splits = gqa_plan(pb, s, ph, t_len, pkv)
    inst = "tc" if path == TENSOR_CORES else "split"
    cost = functools.partial(costs.gqa_decode_attention, b, s, h, t_len, kv_read, hd)
    if dev.type == "meta":
        kernel_call(gqa_decode_attention, inst, cost, launched=False)
        return out
    ws = (torch.empty((b * s * h * splits * (hd + 4),), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    with torch.cuda.device(dev):
        status = _lib().gqa_decode_launch(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), positions.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, b, s, h, t_len, kv, hd, head_offset,
            groups, splits, int(path == TENSOR_CORES), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "gqa_decode_launch")
    kernel_call(gqa_decode_attention, inst, cost, launched=True)
    return out


@entry("gqa_decode_attention")
def gqa_decode_attention(q, ck, cv, positions, *, scale: float, plan_dims=None,
                         head_offset: int = 0, groups=None):
    """Cache-decode GQA attention: q (B, S, H, hd) against slot caches
    ck/cv (B, T, KV, hd) with per-query positions (B, S).

    ``plan_dims`` = (B, H, KV) of the whole batch and model where a rank
    holds a shard of them (tensor-parallel serving: local heads, local
    slots): the key splits are counted from them, so a row gets the bits it
    gets unsharded; by default, from the shapes given. ``head_offset`` and
    ``groups``: q head i is global head ``head_offset + i`` and reads kv
    head (head_offset + i) // groups of the caches (a rank's share of the q
    heads against the whole kv heads, read in place); by default H % KV == 0
    and groups = H // KV."""
    if not (q.is_cuda or q.is_meta):
        return gqa_decode_attention_ref(q, ck, cv, positions, scale=scale,
                                        head_offset=head_offset, groups=groups)
    return _launch(q, ck, cv, positions, scale, plan_dims, head_offset, groups)


# the MLA loop's four warps of a row group each keep 128 output columns in
# registers, so R <= 512
MAX_LATENT_DIM = 512
# MLA kernel geometry (include/mla_attention.cuh): heads per block (the MMA
# rows: two groups of 16), keys per tile; a block takes 224 KB of shared
# memory at full width, one an SM, so the key splits aim at one block an SM
# of an H100
_MLA_HEADS_PER_BLOCK, _MLA_TILE, _MLA_TARGET_BLOCKS = 32, 32, 132
# its shared memory holds two key tiles of R + r floats (rounded up to 32),
# Q's low parts and the score exchange: at most 227 KB on an H100, so
# R + r <= 576
_MLA_MAX_ROW = 576


# from this many query rows on (the prefill buckets) the MLA kernel has
# blocks to spare and runs unsplit; below it (decode steps, a speculative
# verify's k + 1 rows) the keys split
MLA_UNSPLIT_S = 16


def mla_splits(b: int, s: int, h: int, t: int) -> int:
    """Blocks the MLA kernel splits each (query, head block)'s keys over
    (split i takes tiles i, i + splits, ...). Below ``MLA_UNSPLIT_S`` query
    rows, counted from the blocks of one query step, whatever ``s``: a
    query's result then does not depend on the rows it rides with, so a
    multi-token verify gives each position the bits of its single-token
    decode, as ``gqa_splits`` does."""
    if s >= MLA_UNSPLIT_S:
        return 1
    return _splits(b * -(-h // _MLA_HEADS_PER_BLOCK), -(-t // _MLA_TILE), _MLA_TARGET_BLOCKS)


def _mla_launch(q_lat, q_rope, c_kv, k_rope, positions, scale: float, plan_dims=None):
    dev = q_lat.device
    for name, t in (("q_rope", q_rope), ("c_kv", c_kv), ("k_rope", k_rope),
                    ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"mla_decode_attention: q_lat on {dev}, {name} on {t.device}")
    b, s, h, r = q_lat.shape
    rd = q_rope.shape[-1]
    t_len = c_kv.shape[1]
    if (q_rope.shape[:3] != (b, s, h) or c_kv.shape != (b, t_len, r)
            or k_rope.shape != (b, t_len, rd)):
        raise ValueError(f"mla_decode_attention: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c_kv {tuple(c_kv.shape)}, k_rope "
                         f"{tuple(k_rope.shape)}")
    if not 0 < r <= MAX_LATENT_DIM or r % 4 or rd % 4 or r + rd > _MLA_MAX_ROW:
        raise ValueError(f"mla_decode_attention: latent dim {r} and rope dim {rd} must be "
                         f"multiples of 4, the latent dim in 4..{MAX_LATENT_DIM}, their sum "
                         f"at most {_MLA_MAX_ROW}")
    if any(t.dtype != torch.float32 for t in (q_lat, q_rope, c_kv, k_rope)):
        raise ValueError("mla_decode_attention: the kernel takes f32 queries and caches")
    if positions.shape != (b, s) or positions.dtype != torch.int32:
        raise ValueError("mla_decode_attention: positions must be int32 (B, S)")
    q_lat, q_rope, c_kv, k_rope, positions = (
        t.contiguous() for t in (q_lat, q_rope, c_kv, k_rope, positions))
    if c_kv.data_ptr() % 16 or k_rope.data_ptr() % 16:
        raise ValueError("mla_decode_attention: the kernel copies the caches in 16-byte "
                         "pieces; c_kv and k_rope must be 16-byte aligned")
    out = torch.empty_like(q_lat)
    pb, ph = plan_dims if plan_dims is not None else (b, h)
    splits = mla_splits(pb, s, ph, t_len)
    cost = functools.partial(costs.mla_decode_attention, b, s, h, t_len, r, rd)
    if dev.type == "meta":
        kernel_call(mla_decode_attention, "tc", cost, launched=False)
        return out
    ws = (torch.empty((b * s * h * splits * (r + 4),), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    with torch.cuda.device(dev):
        status = _lib().mla_decode_launch(
            q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(),
            positions.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
            b, s, h, t_len, r, rd, splits, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "mla_decode_launch")
    kernel_call(mla_decode_attention, "tc", cost, launched=True)
    return out


@entry("mla_decode_attention")
def mla_decode_attention(q_lat, q_rope, c_kv, k_rope, positions, *, scale: float,
                         plan_dims=None):
    """Absorbed-form MLA cache attention: q_lat (B, S, H, R) and q_rope
    (B, S, H, r) against the latent cache c_kv (B, T, R) and k_rope (B, T, r)
    with per-query positions (B, S). Returns the latent output (B, S, H, R) f32.
    ``plan_dims`` = (B, H) of the whole batch and model where a rank holds a
    shard of them: the key splits are counted from them."""
    if not (q_lat.is_cuda or q_lat.is_meta):
        return mla_decode_attention_ref(q_lat, q_rope, c_kv, k_rope, positions, scale=scale)
    return _mla_launch(q_lat, q_rope, c_kv, k_rope, positions, scale, plan_dims)
