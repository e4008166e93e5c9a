"""The ``jax.random`` functions the reference's sampler and its synthetic
data pipeline reach, in torch.

The reference samples with threefry-2x32 keys (``jax.random.PRNGKey``,
``fold_in``, ``split``, ``categorical``, ``uniform``, ``bernoulli``,
``normal``). This module computes the same integers on any device, so that a
request's sampled stream and a training batch are the reference's. It
follows the threefry convention of jax 0.9.0, the version the tests compare
against (``jax_threefry_partitionable=True``):

* :func:`threefry2x32`: the 20-round hash with the ``0x1BD11BDA`` key schedule;
* :func:`prng_key`, :func:`fold_in`: keys as ``(..., 2)`` words;
* :func:`random_bits`: the 32-bit bits of a shape in the *partitionable*
  layout (``jax_threefry_partitionable=True``, JAX's default since 0.5): the
  flat index of each element is the counter, split into its high and low
  words, and the bits are the xor of the hash's two outputs;
* :func:`split`: the fold-like split of that mode, key ``i`` the hash of
  the counter ``(0, i)``, both words kept;
* :func:`uniform`, :func:`bernoulli` (``uniform < p``), :func:`normal`
  (``sqrt(2) * erfinv(u)``, ``u`` uniform on ``(-1, 1)``), :func:`gumbel`
  (``mode="low"``), :func:`categorical`.

torch has no wrapping uint32 arithmetic on the CPU, so every word is held in
an int64 tensor masked to 32 bits. Nothing here reads the device or builds
a tensor from host values, so a CUDA graph can capture it. The integer
parts are bitwise JAX's, and so is ``uniform``; the Gumbel noise goes through
f32 ``log`` twice and ``normal`` through f32 ``erfinv``, whose last bits
differ between libraries.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

__all__ = ["bernoulli", "categorical", "fold_in", "gumbel", "normal", "prng_key", "random_bits",
           "split", "threefry2x32", "uniform"]


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


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of each key ``(..., 2)``: ``(..., num,
    2)``, key ``i`` the two words of the hash of the counter ``(0, i)``."""
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    k1, k2 = keys[..., 0, None], keys[..., 1, None]
    y1, y2 = threefry2x32(k1, k2, counts >> 32, counts & MASK)
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
    below at ``minval``, as ``jax._src.random._uniform``. XLA contracts the
    scale and shift into one fused multiply-add (one rounding). Where
    ``minval`` is 0, or the span a power of two (the sampler's ``gumbel``,
    ``bernoulli``, ``normal``), one f32 operation rounds and the f32
    expression is that. Else the product of two f32 values is exact in f64
    and the sum is rounded from f64, which gives the same f32 but for a
    double rounding once in ~2**29 draws."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    if lo == 0 or np.frexp(span)[0] == 0.5:
        scaled = floats * float(span) + float(lo)
    else:
        scaled = (floats.to(torch.float64) * float(span) + float(lo)).to(torch.float32)
    return torch.clamp(scaled, min=float(lo))


def bernoulli(keys: torch.Tensor, p: float, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli`` (``mode="low"``): ``uniform < p`` in f32."""
    return uniform(keys, shape) < float(np.float32(p))


def normal(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in f32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(keys, shape, minval=float(lo), maxval=1.0)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


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
