"""Wrapper of the cache-free flash attention kernel.

``flash_attention`` (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:_flash_kernel``
(``flash_attention_bhsd``, model-layout entry ``ops.py:flash_attention``).
On an H100 it is bound by its multiply-adds; it runs the tensor-core tile
loop of ``include/gqa_tile.cuh`` (3xTF32 ``mma.sync``, about f32 accuracy):
a block takes 64 query rows of one head, streams 32-key K/V tiles through
shared memory with an online softmax, resolves the kv head by index (no
repeated K/V) and skips the tiles above the diagonal.

A CPU tensor runs the plain version (``flash_attention_ref``); a CUDA tensor
launches the kernel or raises; a meta tensor returns an empty meta result.
``flash_attention.launches`` counts launches. Against the plain version the
output agrees to f32 reduction-order tolerance (:data:`TOLERANCE`): the
kernel sums scores and P·V in another order, rescales per tile, and its
split products carry about f32's rounding. A (query, head) block never splits
its keys, so its bits do not depend on how many heads or rows a call holds:
a tensor-parallel rank's local heads need no plan from the global counts.
Where a rank's q heads are split over the model axis and the kv heads are
not (replicated kv heads), ``head_offset`` and ``groups`` map its q heads
onto the whole K and V, read in place.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build, costs, entry, kernel_call
from ..decode_attention.ops import head_map
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 112, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# max |kernel - plain| allowed on unit-scale f32 inputs: a few ulps of
# reduction-order drift, with headroom (the decode kernels' bar)
TOLERANCE = 2e-5


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                                           ctypes.c_float, p]
    lib.flash_attention_launch.restype = i
    return lib


def _launch(q, k, v, causal: bool, head_offset: int = 0, groups=None):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: q on {dev}, {name} on {t.device}")
    b, sq, h, d = q.shape
    _, sk, kv, d2 = k.shape
    if v.shape != k.shape or d2 != d or k.shape[0] != b or sq == 0 or sk == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    groups, kv_read = head_map(h, kv, head_offset, groups, "flash_attention")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes q, k, v of one type, f32 or "
                         f"bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel copies in 16-byte pieces; q, k and v "
                         "must be 16-byte aligned")
    out = torch.empty_like(q)
    cost = functools.partial(costs.flash_attention, b, sq, h, kv_read, d, q.element_size(),
                             causal)
    if dev.type == "meta":
        kernel_call(flash_attention, "tc", cost, launched=False)
        return out
    with torch.cuda.device(dev):
        status = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kv,
            head_offset, groups, d, DTYPES[q.dtype], int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "flash_attention_launch")
    kernel_call(flash_attention, "tc", cost, launched=True)
    return out


@entry("flash_attention")
def flash_attention(q, k, v, *, causal: bool = True, head_offset: int = 0, groups=None):
    """Cache-free attention in model layout: q (B, Sq, H, D) against k, v
    (B, Sk, KV, D), causal over the indices (query i sees keys j <= i).
    q head i reads kv head (head_offset + i) // groups (by default H % KV ==
    0 and groups = H // KV). Returns (B, Sq, H, D) in q's dtype."""
    if not (q.is_cuda or q.is_meta):
        return flash_attention_ref(q, k, v, causal=causal, head_offset=head_offset,
                                   groups=groups)
    return _launch(q, k, v, causal, head_offset, groups)
