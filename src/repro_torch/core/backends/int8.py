"""int8 backend: int8 x int8 -> int32 dots (port of
``repro.core.backends.int8``).

Per-call path: per-output-channel weight scales recomputed every call.
Prepared path: ``prepare`` quantizes the weight bank once (int8 qvalues,
per-channel scales, CORDIC depth baked in as trailing-bit zeroing), so the
forward only computes the per-token activation scale.

The int32 dot is the port's MAC-array kernel
(:func:`repro_torch.kernels.cordic_mac.mac_matmul`: ``acc * x_scale *
w_scale``, exactly what :func:`int8_dot` computes), which on a CPU tensor
runs its plain version. Under autograd (QAT) it runs through
``mac_matmul_scaled_grad``, which gives the reference's gradient: none
through the integer operands, only through the two scales, that is through
the ``max(|.|)`` of ``x`` (per token) and of ``w`` (per output channel).
Banks are K-major, as every integer bank: ``(L, K, N)`` stacked banks with
``(L, 1, N)`` scales, viewed in the weight's logical shape. ``torch.round``
is half-to-even like ``jnp.round`` and ``>>`` on int32 is arithmetic as in
JAX; float -> integer casts saturate and send NaN to 0 (``fxp.to_int32``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import on_card
from repro_torch.kernels.int_dot import has_aligned_rows, k_major_empty, to_k_major

from .. import cordic
from ..fxp import to_int32
from .base import Backend, PreparedWeight

__all__ = ["Int8Backend", "effective_bits", "int8_dot", "k_major_bank", "quantize_tokens",
           "quantize_weight"]


def effective_bits(lp) -> int:
    """CORDIC depth -> effective weight bits (the int8 incarnation of depth)."""
    return max(2, min(8, int(np.ceil(lp.depth * 8 / cordic.full_depth(lp.fmt)))))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true f32 quotient: the divisor is a
    tensor, since CUDA torch divides by a host scalar as a product with its
    reciprocal, which is not the reference's quotient."""
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)


def _to_int8(q: torch.Tensor) -> torch.Tensor:
    return to_int32(q).to(torch.int8)


def _drop_bits(wq: torch.Tensor, eff_bits: int) -> torch.Tensor:
    drop = 8 - eff_bits
    return ((wq.to(torch.int32) >> drop) << drop).to(torch.int8)


def quantize_weight(w, *, per_channel: bool = True, stacked_axes: int = 0, eff_bits: int = 8,
                    in_axes: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-time weight-bank quantization: int8 qvalues + f32 scales.

    ``per_channel`` reduces over the ``in_axes`` contraction axes after the
    ``stacked_axes`` leading ones (keepdims; default: all but the last axis).
    ``eff_bits < 8`` zeroes trailing bits of the grid (reduced CORDIC depth,
    baked in). The qvalues come back in ``w``'s layout."""
    wf = torch.as_tensor(w, dtype=torch.float32)
    if in_axes is None:
        in_axes = wf.ndim - stacked_axes - 1
    if per_channel:
        amax = torch.amax(wf.abs(), dim=tuple(range(stacked_axes, stacked_axes + in_axes)),
                          keepdim=True)
    else:
        amax = torch.amax(wf.abs()).reshape((1,) * wf.ndim)
    scale = _scale(amax)
    wq = _to_int8(torch.clamp(torch.round(wf / scale), -127, 127))
    if eff_bits < 8:
        wq = _drop_bits(wq, eff_bits)
    return wq, scale.to(torch.float32)


def quantize_tokens(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(M, K)`` float activations -> int8 ``(M, K)`` and their per-token
    f32 scales ``(M, 1)``: the dynamic half of :func:`int8_dot`. On a CUDA
    device the rows are 16-byte aligned, as the MAC-array kernel takes them
    (padded storage when K is not)."""
    xf = torch.as_tensor(x).to(torch.float32)
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    x_scale = _scale(amax)
    xq = _to_int8(torch.clamp(torch.round(xf / x_scale), -127, 127))
    if on_card(xq) and not has_aligned_rows(xq):
        xq = to_k_major(xq.T).T  # (M, K_pad) storage viewed as (M, K)
    return xq, x_scale


def int8_dot(x, w, *, effective_bits: int = 8, w_scale=None) -> torch.Tensor:
    """``(..., K)`` float by ``(K, N)``: int8 x int8 -> int32 dot with a
    per-token activation scale and per-output-channel weight scales, f32
    out. ``w_scale`` given: ``w`` is a prepared int8 bank (K-major on a CUDA
    device) and ``(1, N)`` its scales; else ``w`` is float and quantized
    here. ``effective_bits < 8`` zeroes trailing bits of the weight grid."""
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    xq, x_scale = quantize_tokens(x.reshape(-1, x.shape[-1]))
    per_call = w_scale is None
    if per_call:
        wq, w_scale = quantize_weight(w)
    else:
        wq = w
    if effective_bits < 8:
        wq = _drop_bits(wq, effective_bits)
    if per_call and on_card(wq):
        wq = to_k_major(wq)  # the kernel's bank layout
    from repro_torch.kernels.cordic_mac import mac_matmul, mac_matmul_scaled_grad

    w_scale = w_scale.reshape(1, -1)
    # The Function only where a gradient is asked for: torch.func transforms
    # (``sensitivity_scan``'s jvp) refuse an autograd.Function without
    # ``setup_context``, and the reference's int8 dot is plain jnp, which
    # jax.jvp goes through.
    if torch.is_grad_enabled() and (x_scale.requires_grad or w_scale.requires_grad):
        out = mac_matmul_scaled_grad(xq, wq, x_scale, w_scale)
    else:
        out = mac_matmul(xq, wq, x_scale, w_scale)
    return out.reshape(shape)


def k_major_bank(wq: torch.Tensor, stacked_axes: int = 0, in_axes: int = 1) -> torch.Tensor:
    """An int8 bank in the kernel's layout: the ``in_axes`` contraction axes
    after the ``stacked_axes`` leading ones innermost in memory, K padded to
    whole 16 bytes, viewed in ``wq``'s logical shape."""
    lead = tuple(wq.shape[:stacked_axes])
    k = math.prod(wq.shape[stacked_axes:stacked_axes + in_axes])
    n = math.prod(wq.shape[stacked_axes + in_axes:])
    out = k_major_empty(lead, k, n, torch.int8, wq.device).reshape(wq.shape)
    out.copy_(wq)
    return out


class Int8Backend(Backend):
    name = "int8"

    def prepare(self, w, lp, *, stacked_axes: int = 0, in_axes: Optional[int] = None):
        eff = effective_bits(lp)
        w = torch.as_tensor(w)
        in_axes = w.ndim - stacked_axes - 1 if in_axes is None else in_axes
        wq, scale = quantize_weight(w, stacked_axes=stacked_axes, eff_bits=eff, in_axes=in_axes)
        # depth is recorded for the runtime cycle model; the arithmetic
        # consumes only the pre-baked effective_bits grid
        return PreparedWeight(k_major_bank(wq, stacked_axes, in_axes), self.name, scale=scale,
                              meta=(("effective_bits", eff), ("depth", int(lp.depth))))

    def dot(self, ctx, x, w, *, name: str = ""):
        if isinstance(w, PreparedWeight):
            # depth already baked into the stored grid: activation side only
            out = int8_dot(x, w.data, effective_bits=8, w_scale=w.scale)
        else:
            lp = ctx.layer_precision(name)
            out = int8_dot(x, w, effective_bits=effective_bits(lp))
        return out.to(ctx.compute_dtype)
