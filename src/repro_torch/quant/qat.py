"""Scaled-integer quantization substrate, the int8 regime (port of
``repro.quant.qat``).

Complements ``core/fxp.py`` (binary-point FxP, the silicon datapath regime):
here scales are per-tensor or per-channel floats, weights are stored int8
once, and the CORDIC depth maps to effective weight bits. The weight-bank
mechanics live in the int8 backend (``repro_torch.core.backends.int8``):
``quantize_params_int8`` and ``QuantizedLinear`` are thin shims over it.
Serving code uses ``repro_torch.core.prepare_params`` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.backends.int8 import int8_dot, k_major_bank, quantize_weight

__all__ = ["QuantizedLinear", "calibrate_activation_scales", "dequantize_params", "fake_quant",
           "quantize_params_int8"]


def fake_quant(x, bits: int = 8, axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric fake quantization with a straight-through gradient (the
    gradient of ``x`` passes unchanged)."""
    x = torch.as_tensor(x)
    qmax = 2.0 ** (bits - 1) - 1
    if axis is None:
        amax = torch.amax(torch.abs(x))
    else:
        amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()  # STE


def _is_float_matrix(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point() and p.ndim >= 2


def quantize_params_int8(params, *, per_channel: bool = True):
    """One-time weight-bank quantization: each 2-D+ float leaf becomes
    ``{"qvalue": int8, "qscale": f32}`` (per output channel, the last dim);
    small and 1-D leaves (norms, biases) stay float with ``qscale`` None."""
    def one(p):
        if isinstance(p, dict):
            return {k: one(v) for k, v in p.items()}
        if not _is_float_matrix(p):
            return {"qvalue": p, "qscale": None}
        q, scale = quantize_weight(p, per_channel=per_channel)
        return {"qvalue": q, "qscale": scale}

    return one(params)


def dequantize_params(qparams):
    def one(node):
        if isinstance(node, dict) and "qvalue" in node:
            if node["qscale"] is None:
                return node["qvalue"]
            return node["qvalue"].to(torch.float32) * node["qscale"]
        return {k: one(v) for k, v in node.items()}

    return one(qparams)


def calibrate_activation_scales(apply_fn, params, batches, taps) -> Dict[str, float]:
    """Max-abs activation calibration over a few batches (static scales)."""
    scales = {t: 0.0 for t in taps}
    for batch in batches:
        acts = apply_fn(params, batch)  # dict tap -> activation
        for t in taps:
            scales[t] = max(scales[t], float(torch.amax(torch.abs(acts[t]))))
    return {t: v / 127.0 for t, v in scales.items()}


@dataclasses.dataclass
class QuantizedLinear:
    """A pre-quantized weight bank and the int8 dot (one layer's serving
    path; ``prepare_params(..., mode="int8")`` is the whole-tree form). The
    bank is K-major, the MAC-array kernel's layout."""

    w_q: torch.Tensor  # int8 (in, out), K-major
    scale: torch.Tensor  # (1, out)

    @staticmethod
    def from_float(w):
        w_q, scale = quantize_weight(w)
        return QuantizedLinear(k_major_bank(w_q), scale)

    def __call__(self, x, *, effective_bits: int = 8):
        return int8_dot(x, self.w_q, effective_bits=effective_bits, w_scale=self.scale)
