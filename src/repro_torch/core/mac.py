"""CARMEN's runtime-adaptive iterative CORDIC MAC (port of ``repro.core.mac``).

Two fidelities of the same arithmetic:

* :func:`cordic_dot` / :func:`cordic_matmul`, bit-faithful: every product is
  the linear-rotation shift-add recurrence of ``core/cordic.py``, as the RTL
  executes it. Linear rotation is additive in ``y``, so chaining the
  accumulator through the K MACs equals summing the per-product outputs;
  the int32 sums wrap as the reference's do.
* :func:`carmen_matmul_fast`, the error model: the signed-digit rounding of
  the multiplier applied to the weights once, then one real matmul. At FxP8
  every product and partial sum sits on a grid that f32 carries exactly, so
  it equals the ``cordic_mac`` kernel bit for bit; at FxP16 the f32 matmul
  rounds in the order of its library, while the kernel's integer
  accumulator is exact.

:func:`mac_cycles` is the cycle model: one CORDIC iteration per cycle, so a
K-length dot at depth d costs K * d cycles, plus K accumulates.
"""
from __future__ import annotations

import torch

from . import cordic
from .fxp import FxPFormat, dequantize, quantize

__all__ = ["cordic_dot", "cordic_matmul", "carmen_matmul_fast", "mac_cycles"]


def mac_cycles(k: int, depth: int) -> int:
    """Cycle count of a K-length dot product on one iterative CORDIC PE."""
    return k * (depth + 1)


def cordic_dot(x_raw, w_raw, depth: int, w_fmt: FxPFormat) -> torch.Tensor:
    """Bit-faithful dot product over the last axis: sum_k cordic_mul(x[k], w[k]).

    ``x_raw``: raw int32 activations (any binary point); ``w_raw``: raw int32
    weights in ``w_fmt`` (Q1.f, |w| < 2). Returns int32 raw in x's binary
    point.
    """
    prod = cordic.cordic_mul(x_raw, w_raw, depth, w_fmt)
    return torch.sum(prod, dim=-1, dtype=torch.int32)


def cordic_matmul(x_raw, w_raw, depth: int, w_fmt: FxPFormat) -> torch.Tensor:
    """Bit-faithful fixed-point matmul: (M, K) @ (K, N) -> (M, N) int32 raw,
    one broadcast MAC per K step (every PE consumes activation column k)."""
    x = torch.as_tensor(x_raw, dtype=torch.int32)
    w = torch.as_tensor(w_raw, dtype=torch.int32)
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} vs {tuple(w.shape)}")
    acc = torch.zeros((m, w.shape[1]), dtype=torch.int32, device=x.device)
    for kk in range(k):
        acc = acc + cordic.cordic_mul(x[:, kk, None], w[None, kk, :], depth, w_fmt)
    return acc


def carmen_matmul_fast(x, w, depth: int, x_fmt: FxPFormat, w_fmt: FxPFormat) -> torch.Tensor:
    """CARMEN error-model matmul on float values: activations quantized to
    ``x_fmt``, weights to the depth-d signed-digit grid of ``w_fmt``, one f32
    matmul."""
    xq = dequantize(quantize(x, x_fmt), x_fmt)
    return xq @ cordic.signed_digit_round(w, depth, w_fmt)
