"""Unified iterative CORDIC, bit-faithful fixed point (port of ``repro.core.cordic``).

Every value is a raw int32 tensor with the binary point given by an
``FxPFormat``, iterated with the same shift-add recurrences as the reference:

* linear rotation  — multiply: ``y <- y0 + x0 * z0``
* linear vectoring — divide: ``z <- z0 + y0 / x0``
* hyperbolic rotation — ``(cosh z0, sinh z0)`` with the gain pre-compensated

``>>`` on int32 tensors is arithmetic and ``//`` floors, as in JAX. The
hyperbolic tables are computed with the reference's float64 Python math.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .fxp import FxPFormat, saturate, to_int32

__all__ = [
    "full_depth",
    "approx_depth",
    "linear_rotate",
    "linear_vectoring",
    "hyperbolic_rotate",
    "hyperbolic_sequence",
    "cordic_mul",
    "cordic_div",
    "cordic_exp",
    "signed_digit_round",
    "signed_digit_ints",
]


def full_depth(fmt: FxPFormat) -> int:
    """Iterations for 'accurate' mode: one per fractional bit plus the sign digit."""
    return fmt.frac + 1


def approx_depth(fmt: FxPFormat) -> int:
    """'Approximate' mode: 2/3 of full depth."""
    return max(2, (2 * full_depth(fmt)) // 3)


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


def _sign(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, 1, -1).to(torch.int32)


def linear_rotate(x, y, z, depth: int, z_fmt: FxPFormat):
    """Linear-mode rotation: drive z -> 0, accumulating ``y += x * z``.

    Returns ``(y_out, z_residual)``.
    """
    x, y, z = _i32(x), _i32(y), _i32(z)
    for k in range(depth):
        d = _sign(z)
        y = y + d * (x >> k)
        z = z - d * (z_fmt.one >> k)
    return y, z


def linear_vectoring(x, y, z, depth: int, z_fmt: FxPFormat):
    """Linear-mode vectoring: drive y -> 0, accumulating ``z += y / x``.

    Returns ``(z_out, y_residual)``.
    """
    x, y, z = _i32(x), _i32(y), _i32(z)
    for k in range(depth):
        d = torch.where((y >= 0) == (x >= 0), -1, 1).to(torch.int32)
        y = y + d * (x >> k)
        z = z - d * (z_fmt.one >> k)
    return z, y


@functools.lru_cache(maxsize=None)
def hyperbolic_sequence(depth: int) -> tuple:
    """Shift sequence 1,2,3,4,4,5,...,13,13,... (repeat k=4,13,40,... = 3k+1)."""
    seq = []
    k, next_repeat = 1, 4
    while len(seq) < depth:
        seq.append(k)
        if k == next_repeat and len(seq) < depth:
            seq.append(k)
            next_repeat = 3 * k + 1
        k += 1
    return tuple(seq[:depth])


@functools.lru_cache(maxsize=None)
def hyperbolic_tables(depth: int, frac: int):
    """``(shifts, atanh constants, inv_gain, max_angle)`` for ``depth`` steps."""
    seq = hyperbolic_sequence(depth)
    gain = 1.0
    for k in seq:
        gain *= math.sqrt(1.0 - 2.0 ** (-2 * k))
    atanh = np.round(np.array([math.atanh(2.0 ** -k) for k in seq]) * (1 << frac))
    inv_gain = int(round((1.0 / gain) * (1 << frac)))
    max_angle = float(np.sum([math.atanh(2.0 ** -k) for k in seq]))
    return (
        tuple(int(v) for v in seq),
        tuple(int(v) for v in np.array(atanh, np.int32)),
        inv_gain,
        max_angle,
    )


def hyperbolic_zmax(depth: int, frac: int) -> int:
    """Saturation bound of the rotation angle, raw in ``frac`` bits."""
    return int(hyperbolic_tables(depth, frac)[3] * (1 << frac))


def hyperbolic_rotate(z, depth: int, fmt: FxPFormat):
    """Hyperbolic rotation from (x0, y0) = 1/A_h: returns (cosh z, sinh z) raw."""
    seq, atanh_tab, inv_gain, _ = hyperbolic_tables(depth, fmt.frac)
    zmax = hyperbolic_zmax(depth, fmt.frac)
    z = torch.clamp(_i32(z), -zmax, zmax)
    x = torch.full_like(z, inv_gain)
    y = torch.zeros_like(z)
    for k, a in zip(seq, atanh_tab):
        d = _sign(z)
        x, y = x + d * (y >> k), y + d * (x >> k)
        z = z - d * a
    return x, y


def cordic_mul(x_raw, w_raw, depth: int, w_fmt: FxPFormat):
    """Elementwise fixed-point multiply via linear rotation: value(x) * value(w)."""
    x_b, w_b = torch.broadcast_tensors(_i32(x_raw), _i32(w_raw))
    y, _ = linear_rotate(x_b, torch.zeros_like(x_b), w_b, depth, w_fmt)
    return y


def cordic_div(num_raw, den_raw, depth: int, out_fmt: FxPFormat):
    """Fixed-point divide via linear vectoring: value(num)/value(den) in out_fmt."""
    num_b, den_b = torch.broadcast_tensors(_i32(num_raw), _i32(den_raw))
    z, _ = linear_vectoring(den_b, num_b, torch.zeros_like(num_b), depth, out_fmt)
    return z


LN2 = math.log(2.0)


def ln2_raw(frac: int) -> int:
    return int(round(LN2 * (1 << frac)))


def cordic_exp(x_raw, depth: int, fmt: FxPFormat):
    """exp(value(x)) in ``fmt`` via ln2 range reduction + hyperbolic rotation."""
    x = _i32(x_raw)
    ln2 = ln2_raw(fmt.frac)
    q = (2 * x + ln2) // (2 * ln2)  # floor division, as in the reference
    r = x - q * ln2
    c, s = hyperbolic_rotate(r, depth, fmt)
    e = c + s
    q = torch.clamp(q, -31, 29 - fmt.frac)
    e = torch.where(q >= 0, e << torch.where(q >= 0, q, 0), e >> torch.where(q < 0, -q, 0))
    return saturate(e, FxPFormat(32, fmt.frac))


def signed_digit_ints(w, depth: int, w_fmt: FxPFormat) -> torch.Tensor:
    """The depth-digit signed-digit multiplier as raw int32 (``grid * 2**frac``)."""
    z = to_int32(torch.round(torch.as_tensor(w, dtype=torch.float32) * float(1 << w_fmt.frac)))
    z = torch.clamp(z, w_fmt.qmin, w_fmt.qmax)
    acc = torch.zeros_like(z)
    for k in range(depth):
        d = _sign(z)
        step = w_fmt.one >> k
        z = z - d * step
        acc = acc + d * step
    return acc


def signed_digit_round(w, depth: int, w_fmt: FxPFormat) -> torch.Tensor:
    """Float32 values of the signed-digit-rounded multiplier (the reference's output)."""
    return signed_digit_ints(w, depth, w_fmt).to(torch.float32) * w_fmt.scale
