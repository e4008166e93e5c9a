"""Fixed-point (FxP) number formats and quantization (port of ``repro.core.fxp``).

A format is ``Q<int>.<frac>`` with one sign bit: ``bits = 1 + int_bits + frac``.
Raw values are carried as int32 tensors whatever the storage width, as in the
reference, so the CORDIC shift-add arithmetic has headroom.

Float -> int32 casts go through :func:`to_int32`, which reproduces JAX's
``astype(int32)``: out-of-range values saturate and NaN maps to 0, where
``Tensor.to(torch.int32)`` returns INT32_MIN for all of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FxPFormat",
    "FXP8",
    "FXP16",
    "FXP8_UNIT",
    "FXP16_UNIT",
    "quantize",
    "dequantize",
    "saturate",
    "requantize",
    "to_int32",
]

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class FxPFormat:
    """Signed fixed-point format: ``bits`` total (incl. sign), ``frac`` fractional bits."""

    bits: int
    frac: int

    def __post_init__(self):
        if self.frac < 0 or self.frac > self.bits - 1:
            raise ValueError(f"invalid FxP format Q{self.int_bits}.{self.frac} ({self.bits} bits)")

    @property
    def int_bits(self) -> int:
        return self.bits - 1 - self.frac

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac)

    @property
    def one(self) -> int:
        return 1 << self.frac

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def max_value(self) -> float:
        return self.qmax * self.scale

    @property
    def min_value(self) -> float:
        return self.qmin * self.scale

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.int8
        if self.bits <= 16:
            return torch.int16
        return torch.int32

    def __str__(self) -> str:
        return f"Q{self.int_bits}.{self.frac}"


FXP8 = FxPFormat(8, 6)
FXP16 = FxPFormat(16, 12)
FXP8_UNIT = FxPFormat(8, 6)
FXP16_UNIT = FxPFormat(16, 14)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 the way JAX casts: truncate, saturate, NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
    hi = x >= 2.0**31
    lo = x <= -(2.0**31)
    safe = torch.where(hi | lo, torch.zeros_like(x), x)
    out = safe.to(torch.int32)
    out = torch.where(hi, torch.full_like(out, INT32_MAX), out)
    return torch.where(lo, torch.full_like(out, INT32_MIN), out)


def saturate(raw: torch.Tensor, fmt: FxPFormat) -> torch.Tensor:
    """Clip raw int32 values into the representable range of ``fmt``."""
    return torch.clamp(raw, max(fmt.qmin, INT32_MIN), min(fmt.qmax, INT32_MAX))


def quantize(x, fmt: FxPFormat, *, rounding: str = "nearest") -> torch.Tensor:
    """Float -> raw int32 in ``fmt`` with saturation (round half to even)."""
    scaled = torch.as_tensor(x, dtype=torch.float32) * float(1 << fmt.frac)
    if rounding == "nearest":
        q = torch.round(scaled)
    elif rounding == "floor":
        q = torch.floor(scaled)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return saturate(to_int32(q), fmt)


def dequantize(raw: torch.Tensor, fmt: FxPFormat) -> torch.Tensor:
    return raw.to(torch.float32) * np.float32(fmt.scale).item()


def requantize(raw: torch.Tensor, src: FxPFormat, dst: FxPFormat) -> torch.Tensor:
    """Change binary point (and saturate into the destination format)."""
    raw = torch.as_tensor(raw, dtype=torch.int32)
    if dst.frac >= src.frac:
        out = raw << (dst.frac - src.frac)
    else:
        sh = src.frac - dst.frac
        out = (raw + (1 << (sh - 1))) >> sh
    return saturate(out, dst)
