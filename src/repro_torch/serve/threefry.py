"""The ``jax.random`` functions the reference's sampler reaches, in torch.

The reference samples with threefry-2x32 keys (``jax.random.PRNGKey``,
``fold_in``, ``categorical``). This module computes the same integers on any
device, so that a request's sampled stream is the reference's:

* :func:`threefry2x32`: the 20-round hash with the ``0x1BD11BDA`` key schedule;
* :func:`prng_key`, :func:`fold_in`: keys as ``(..., 2)`` words;
* :func:`random_bits`: the 32-bit bits of a shape in the *partitionable*
  layout (``jax_threefry_partitionable=True``, JAX's default since 0.5): the
  flat index of each element is the counter, split into its high and low
  words, and the bits are the xor of the hash's two outputs;
* :func:`uniform`, :func:`gumbel` (``mode="low"``), :func:`categorical`.

torch has no wrapping uint32 arithmetic on the CPU, so every word is held in
an int64 tensor masked to 32 bits. Nothing here reads the device or builds
a tensor from host values, so a CUDA graph can capture it. The integer
parts are bitwise JAX's; the Gumbel noise goes through f32 ``log`` twice,
whose last bits differ between libraries.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

__all__ = ["categorical", "fold_in", "gumbel", "prng_key", "random_bits", "threefry2x32",
           "uniform"]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of the counter words ``(x1, x2)`` under the key
    ``(k1, k2)``: int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the reference builds it, with JAX's
    64-bit mode off: the seed is cut to 32 bits, so the high word is 0."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of each key ``(..., 2)`` with its integer ``data``
    ``(...)``: the hash of the counter ``(0, data)``."""
    data = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for each key ``(..., 2)``, in
    the partitionable layout: shape ``(..., *shape)``, int64."""
    shape = tuple(shape)
    counts = torch.arange(int(np.prod(shape)), dtype=torch.int64,
                          device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    k1, k2 = keys[..., 0].reshape(lead), keys[..., 1].reshape(lead)
    y1, y2 = threefry2x32(k1, k2, counts >> 32, counts & MASK)
    return y1 ^ y2


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)`` and clamped
    below at ``minval``, in f32 arithmetic as ``jax._src.random._uniform``."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats * float(span) + float(lo), min=float(lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (f32, ``mode="low"``): ``-log(-log(u))`` with
    ``u`` uniform on ``[tiny, 1)``."""
    u = uniform(keys, shape, minval=float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row: the
    first index of the largest ``logits + gumbel``. keys ``(B, 2)``, logits
    ``(B, V)`` f32 -> int64 ``(B,)``."""
    return torch.argmax(logits + gumbel(keys, logits.shape[-1:]), dim=-1)
