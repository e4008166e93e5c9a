"""Wrapper of the cache-free MLA flash attention kernel.

``mla_flash_attention`` (``csrc/mla_flash.cu``) replaces the TPU kernel
``repro/kernels/mla_flash/kernel.py:_mla_flash_kernel`` (``mla_flash``,
model entry ``ops.py:mla_flash_attention``). At deepseek-v3 width it is
bound by its multiply-adds; one block takes one query row and 32 of its
heads as the rows of a tensor-core tile loop (3xTF32 ``mma.sync``, the MLA
cache kernel's ``include/mla_attention.cuh``), which share every
shared-memory tile of the latent ``[c_kv | k_rope]`` (the reference's head
broadcast).

A CPU tensor runs the plain version (``mla_flash_attention_ref``); a CUDA
tensor launches the kernel or raises. ``mla_flash_attention.launches``
counts launches. Against the plain version the output agrees to f32
reduction-order tolerance (:data:`TOLERANCE`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, count_launch, new_counts
from .ref import mla_flash_attention_ref

# max |kernel - plain| on unit-scale f32 inputs (the decode kernels' bar)
TOLERANCE = 2e-5
# the loop's four warps of a row group each keep 128 output columns in
# registers, so R <= 512
MAX_LATENT_DIM = 512
# shared memory holds two 32-key tiles of R + r floats (rounded up to 32),
# Q's low parts and the score exchange: at most 227 KB on an H100, so
# R + r <= 576
MAX_ROW = 576


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("mla_flash")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mla_flash_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.mla_flash_launch.restype = i
    return lib


def _launch(q_lat, q_rope, c_kv, k_rope, scale: float, causal: bool):
    dev = q_lat.device
    for name, t in (("q_rope", q_rope), ("c_kv", c_kv), ("k_rope", k_rope)):
        if t.device != dev:
            raise ValueError(f"mla_flash_attention: q_lat on {dev}, {name} on {t.device}")
    b, s, h, r = q_lat.shape
    rd = q_rope.shape[-1]
    t_len = c_kv.shape[1]
    if (q_rope.shape[:3] != (b, s, h) or c_kv.shape != (b, t_len, r)
            or k_rope.shape != (b, t_len, rd) or s == 0 or t_len == 0):
        raise ValueError(f"mla_flash_attention: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c_kv {tuple(c_kv.shape)}, k_rope "
                         f"{tuple(k_rope.shape)}")
    if not 0 < r <= MAX_LATENT_DIM or r % 4 or rd % 4 or r + rd > MAX_ROW:
        raise ValueError(f"mla_flash_attention: latent dim {r} and rope dim {rd} must be "
                         f"multiples of 4, the latent dim in 4..{MAX_LATENT_DIM}, their sum "
                         f"at most {MAX_ROW}")
    if any(t.dtype != torch.float32 for t in (q_lat, q_rope, c_kv, k_rope)):
        raise ValueError("mla_flash_attention: the kernel takes f32 queries and latents")
    q_lat, q_rope, c_kv, k_rope = (t.contiguous() for t in (q_lat, q_rope, c_kv, k_rope))
    if c_kv.data_ptr() % 16 or k_rope.data_ptr() % 16:
        raise ValueError("mla_flash_attention: the kernel copies the latents in 16-byte "
                         "pieces; c_kv and k_rope must be 16-byte aligned")
    out = torch.empty_like(q_lat)
    with torch.cuda.device(dev):
        status = _lib().mla_flash_launch(
            q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(),
            out.data_ptr(), b, s, h, t_len, r, rd, int(causal), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "mla_flash_launch")
    count_launch(mla_flash_attention, "tc")
    return out


def mla_flash_attention(q_lat, q_rope, c_kv, k_rope, *, scale: float, causal: bool = True):
    """Cache-free MLA attention in the absorbed form: q_lat (B, S, H, R) and
    q_rope (B, S, H, r) against the sequence's own latent c_kv (B, T, R) and
    k_rope (B, T, r); ``scale`` is the model's score scale, applied once.
    Causal over the indices. Returns the latent output (B, S, H, R) f32."""
    if not q_lat.is_cuda:
        return mla_flash_attention_ref(q_lat, q_rope, c_kv, k_rope, scale=scale, causal=causal)
    return _launch(q_lat, q_rope, c_kv, k_rope, scale, causal)


mla_flash_attention.launches = 0
mla_flash_attention.instantiations = new_counts("mla_flash_attention")
