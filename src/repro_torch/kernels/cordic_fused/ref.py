"""Plain PyTorch version of the fused dot+AF chain (port of
``repro.kernels.cordic_fused.ref`` and ``kernel.af_epilogue``), in two
pieces that compose to it: the int32 dot (:func:`fused_dot_partial_ref`,
the twin of the kernel's partial-sum instantiation) and the epilogue
(:func:`fused_epilogue_ref`, the twin of its epilogue kernel).

It runs on CPU and CUDA tensors alike and is bitwise equal to the reference
and to the Hopper kernel:

* the exact integer dot is a float64 matmul of the integer operands, exact
  while every partial sum stays below 2**53 (FxP8 and FxP16 at any
  K <= 2**22), then int64 -> int32 with wrap-around, as int32 ``dot_general``;
* the descale multiplies by exact powers of two built from their bits, in the
  reference's order ``(acc * 2^-x_frac) * 2^-w_frac``;
* every float -> int32 cast goes through ``fxp.to_int32`` (JAX semantics).
"""
from __future__ import annotations

import torch

from repro_torch.core import activations as afs
from repro_torch.core import fxp

# params-vector indices (make_point)
P_DEPTH, P_XFRAC, P_XQMIN, P_XQMAX, P_WFRAC = range(5)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**e for int32 ``e`` in [-126, 127], from the bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement)."""
    v = torch.remainder(v, 2**32)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def af_epilogue(h: torch.Tensor, af_mode: str, af_depth: int, af_fmt: fxp.FxPFormat,
                compute_round: bool) -> torch.Tensor:
    """The activation chain applied to the f32 dot output ``h``."""
    if af_mode == "identity":
        return h
    if compute_round:
        h = h.to(torch.bfloat16).to(torch.float32)
    ifmt = afs.internal_fmt(af_fmt)
    xq = fxp.requantize(fxp.quantize(h, af_fmt), af_fmt, ifmt)
    raw = afs.multi_af(xq, af_mode, afs.internal_depth(af_depth, af_fmt), ifmt)
    return fxp.dequantize(fxp.requantize(raw, ifmt, af_fmt), af_fmt)


def fused_dot_partial_ref(x, w, point) -> torch.Tensor:
    """The exact int32 dot of the fused chain, before its epilogue: ``x:
    (..., K) float`` quantized at the point's x grid, times ``w: (K, N)``
    signed-digit integers, wrapped modulo 2**32. Sums of such partials over
    K shards, wrapped the same way, equal the dot over the whole of K."""
    pt = point.to(torch.int32)
    scaled = torch.round(x.to(torch.float32) * pow2(pt[P_XFRAC]))
    xq = fxp.to_int32(torch.clamp(scaled, pt[P_XQMIN].float(), pt[P_XQMAX].float()))
    return wrap_int32((xq.to(torch.float64) @ w.to(torch.float64)).to(torch.int64))


def fused_epilogue_ref(acc, point, *, af_mode: str = "identity", af_depth: int = 8,
                       af_fmt: fxp.FxPFormat = fxp.FXP8, compute_round: bool = False):
    """The fused chain's epilogue on an int32 dot ``acc``: descale by the
    point's exact powers of two, then :func:`af_epilogue`. f32 out."""
    pt = point.to(torch.int32)
    h = (acc.to(torch.float32) * pow2(-pt[P_XFRAC])) * pow2(-pt[P_WFRAC])
    return af_epilogue(h, af_mode, af_depth, af_fmt, compute_round)


def fused_dot_af_ref(x, w, point, *, af_mode: str = "identity", af_depth: int = 8,
                     af_fmt: fxp.FxPFormat = fxp.FXP8, compute_round: bool = False):
    """``x: (..., K) float``, ``w: (K, N)`` signed-digit weight integers,
    ``point: int32[5]``. Returns f32 ``(..., N)``: the epilogue of the dot."""
    return fused_epilogue_ref(fused_dot_partial_ref(x, w, point), point, af_mode=af_mode,
                              af_depth=af_depth, af_fmt=af_fmt, compute_round=compute_round)
