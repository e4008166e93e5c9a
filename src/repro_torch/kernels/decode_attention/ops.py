"""Wrapper of the GQA cache-decode attention kernel (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``repro/kernels/decode_attention/kernel.py:
_gqa_decode_kernel`` (``gqa_decode``). On an H100 it is bound by the bytes of
the K and V cache, read once; the kernel streams T in shared-memory tiles
with an online softmax and skips tiles past the block's last query position.

A CPU tensor runs the plain version (:func:`gqa_decode_attention_ref`); a
CUDA tensor launches the kernel or raises. ``gqa_decode_attention.launches``
counts launches. Against the plain version the outputs agree to f32
reduction-order tolerance (:data:`TOLERANCE`): the kernel sums scores and
P·V in another order and rescales per tile.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import gqa_decode_attention_ref

HEAD_DIMS = (32, 64, 128)
# max |kernel - plain| allowed on unit-scale f32 inputs: a few ulps of
# reduction-order drift, with headroom
TOLERANCE = 2e-5


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gqa_decode_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    lib.gqa_decode_launch.restype = i
    return lib


def _launch(q, ck, cv, positions, scale: float):
    dev = q.device
    for name, t in (("ck", ck), ("cv", cv), ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"gqa_decode_attention: q on {dev}, {name} on {t.device}")
    b, s, h, hd = q.shape
    _, t_len, kv, hd2 = ck.shape
    if cv.shape != ck.shape or hd2 != hd or ck.shape[0] != b or h % kv:
        raise ValueError(f"gqa_decode_attention: q {tuple(q.shape)}, ck {tuple(ck.shape)}, "
                         f"cv {tuple(cv.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"gqa_decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype != torch.float32 or ck.dtype != torch.float32 or cv.dtype != torch.float32:
        raise ValueError("gqa_decode_attention: the kernel takes f32 queries and caches")
    if positions.shape != (b, s) or positions.dtype != torch.int32:
        raise ValueError("gqa_decode_attention: positions must be int32 (B, S)")
    q, ck, cv, positions = (t.contiguous() for t in (q, ck, cv, positions))
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        status = _lib().gqa_decode_launch(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, s, h, t_len, kv, hd, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "gqa_decode_launch")
    gqa_decode_attention.launches += 1
    return out


def gqa_decode_attention(q, ck, cv, positions, *, scale: float):
    """Cache-decode GQA attention: q (B, S, H, hd) against slot caches
    ck/cv (B, T, KV, hd) with per-query positions (B, S)."""
    if not q.is_cuda:
        return gqa_decode_attention_ref(q, ck, cv, positions, scale=scale)
    return _launch(q, ck, cv, positions, scale)


gqa_decode_attention.launches = 0
