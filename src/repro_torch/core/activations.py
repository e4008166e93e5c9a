"""CARMEN's time-multiplexed multi-AF block (port of ``repro.core.activations``).

The six elementwise activation functions — ReLU, GELU, Tanh, Sigmoid, Swish,
SELU — are compositions of the shared CORDIC sub-units (hyperbolic exp,
linear-vectoring divide, linear-rotation multiply), on raw int32 tensors,
bit for bit as in the reference. Softmax, the seventh, is the shared exp, an
int32 row sum and the shared divide (:func:`cordic_softmax`).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import numpy as np
import torch

from . import cordic
from .fxp import FxPFormat, dequantize, quantize, requantize, saturate

__all__ = [
    "AF_NAMES",
    "AF_INDEX",
    "ELEMENTWISE_AFS",
    "multi_af",
    "multi_af_float",
    "cordic_softmax",
    "softmax_shift",
    "internal_fmt",
    "af_constants",
    "af_ref",
]

AF_NAMES = ("relu", "gelu", "tanh", "sigmoid", "swish", "selu", "softmax")
AF_INDEX = {name: i for i, name in enumerate(AF_NAMES)}
ELEMENTWISE_AFS = ("relu", "gelu", "tanh", "sigmoid", "swish", "selu")

SELU_ALPHA = 1.6732632423543772
SELU_LAMBDA = 1.0507009873554805
GELU_C = math.sqrt(2.0 / math.pi)
GELU_CUBIC = 0.044715


def _q(value: float, fmt: FxPFormat) -> int:
    return int(quantize(np.float32(value), fmt))


@functools.lru_cache(maxsize=None)
def af_constants(fmt: FxPFormat) -> Dict[str, int]:
    """The raw constants the AFs multiply by, quantized to ``fmt``."""
    return {
        "gelu_cubic": _q(GELU_CUBIC, fmt),
        "gelu_c": _q(GELU_C, fmt),
        "half": _q(0.5, fmt),
        "selu_lambda": _q(SELU_LAMBDA, fmt),
        "selu_alpha": _q(SELU_ALPHA, fmt),
    }


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


def _exp_neg(x_raw, depth: int, fmt: FxPFormat):
    """exp(x) for x <= 0: result in (0, 1]."""
    return cordic.cordic_exp(torch.clamp(_i32(x_raw), max=0), depth, fmt)


def _tanh_raw(x_raw, depth: int, fmt: FxPFormat):
    x = _i32(x_raw)
    ax = torch.abs(x)
    t = _exp_neg(-(ax << 1), depth, fmt)
    mag = cordic.cordic_div(fmt.one - t, fmt.one + t, depth, fmt)
    return torch.where(x >= 0, mag, -mag)


def _sigmoid_raw(x_raw, depth: int, fmt: FxPFormat):
    x = _i32(x_raw)
    t = _exp_neg(-torch.abs(x), depth, fmt)
    num = torch.where(x >= 0, torch.full_like(t, fmt.one), t)
    return cordic.cordic_div(num, fmt.one + t, depth, fmt)


def _q1_sat(raw, fmt: FxPFormat):
    lim = (1 << (fmt.frac + 1)) - 1
    return torch.clamp(_i32(raw), -lim, lim)


def _mul_raw(a_raw, b_raw, depth: int, fmt: FxPFormat):
    a = _i32(a_raw)
    if isinstance(b_raw, torch.Tensor):
        b = b_raw.to(device=a.device, dtype=torch.int32)
    else:  # a host constant: filled on the device, so that a CUDA graph can capture it
        b = torch.full((), int(b_raw), dtype=torch.int32, device=a.device)
    return cordic.cordic_mul(a, _q1_sat(b, fmt), depth, fmt)


def _relu_fx(x, depth, fmt):
    return torch.clamp(x, min=0)


def _tanh_fx(x, depth, fmt):
    return saturate(_tanh_raw(x, depth, fmt), fmt)


def _sigmoid_fx(x, depth, fmt):
    return saturate(_sigmoid_raw(x, depth, fmt), fmt)


def _swish_fx(x, depth, fmt):
    s = _sigmoid_raw(x, depth, fmt)
    return saturate(_mul_raw(x, s, depth, fmt), fmt)


def _gelu_fx(x, depth, fmt):
    c = af_constants(fmt)
    x2 = _mul_raw(x, x, depth, fmt)
    x2c = _mul_raw(x2, c["gelu_cubic"], depth, fmt)
    x3c = _mul_raw(x, x2c, depth, fmt)
    arg = _mul_raw(x + x3c, c["gelu_c"], depth, fmt)
    t = _tanh_raw(arg, depth, fmt)
    out = _mul_raw(x, fmt.one + t, depth, fmt)
    return saturate(_mul_raw(out, c["half"], depth, fmt), fmt)


def _selu_fx(x, depth, fmt):
    c = af_constants(fmt)
    e = _exp_neg(x, depth, fmt)
    neg = _mul_raw(e - fmt.one, c["selu_alpha"], depth, fmt)
    pre = torch.where(x > 0, x, neg)
    return saturate(_mul_raw(pre, c["selu_lambda"], depth, fmt), fmt)


_FX_AFS = {
    "relu": _relu_fx,
    "gelu": _gelu_fx,
    "tanh": _tanh_fx,
    "sigmoid": _sigmoid_fx,
    "swish": _swish_fx,
    "selu": _selu_fx,
}


def multi_af(x_raw, mode: str, depth: int, fmt: FxPFormat) -> torch.Tensor:
    """Fixed-point multi-AF block: raw int32 in ``fmt`` -> raw int32 in ``fmt``.
    ``softmax`` reduces over the last axis."""
    if mode == "softmax":
        return cordic_softmax(x_raw, depth, fmt)
    return _FX_AFS[mode](_i32(x_raw), depth, fmt)


def softmax_shift(n: int, frac: int) -> int:
    """Right shift of the exponentials before a row sum of ``n`` lanes, so the
    int32 accumulator cannot overflow (the reference's Python arithmetic)."""
    headroom = int(math.ceil(math.log2(max(n, 2)))) + frac + 1
    return max(0, headroom - 31)


def cordic_softmax(x_raw, depth: int, fmt: FxPFormat, axis: int = -1) -> torch.Tensor:
    """Softmax = shared exp + int32 accumulate + shared divide, raw int32 in
    ``fmt``. The exponentials are pre-shifted by :func:`softmax_shift` when
    the lane count could overflow the accumulator; the quotient is shift
    invariant."""
    x = _i32(x_raw)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = _exp_neg(x - m, depth, fmt)  # every argument <= 0: values in (0, 1]
    e_s = e >> softmax_shift(x.shape[axis], fmt.frac)
    s = torch.sum(e_s, dim=axis, keepdim=True, dtype=torch.int32)
    return cordic.cordic_div(e_s, torch.clamp(s, min=1), depth, fmt)


def internal_fmt(fmt: FxPFormat) -> FxPFormat:
    """AF-datapath internal format: I/O width + guard bits (FxP8 -> Q3.12,
    FxP16 -> Q7.16), as in the reference."""
    if fmt.frac >= 16:
        return fmt
    if fmt.frac <= 8:
        return FxPFormat(16, 12)
    return FxPFormat(24, 16)


def internal_depth(depth: int, fmt: FxPFormat) -> int:
    """Iteration depth on the guard-bit datapath for an I/O-format depth."""
    return max(int(depth) + (internal_fmt(fmt).frac - fmt.frac), 2)


def multi_af_float(x, mode: str, depth: int, fmt: FxPFormat) -> torch.Tensor:
    """Float in/out: quantize I/O to ``fmt``, compute on the guard-bit internal
    datapath, requantize the result back to ``fmt``."""
    ifmt = internal_fmt(fmt)
    xi = requantize(quantize(x, fmt), fmt, ifmt)
    out = multi_af(xi, mode, internal_depth(depth, fmt), ifmt)
    return dequantize(requantize(out, ifmt, fmt), fmt)


_REFS: Dict[str, Callable] = {
    "relu": lambda x: torch.clamp(x, min=0.0),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + GELU_CUBIC * x**3))),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "swish": lambda x: x * torch.sigmoid(x),
    "selu": lambda x: SELU_LAMBDA * torch.where(x > 0, x, SELU_ALPHA * (torch.exp(x) - 1.0)),
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def af_ref(x, mode: str) -> torch.Tensor:
    """Exact float reference of one AF."""
    return _REFS[mode](torch.as_tensor(x, dtype=torch.float32))
