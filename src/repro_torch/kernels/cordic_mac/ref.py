"""Plain PyTorch version of the MAC-array matmul (port of
``repro.kernels.cordic_mac.ref.mac_matmul_ref``), in two pieces that compose
to it: the int32 dot (:func:`mac_matmul_partial_ref`, the twin of the
kernel's partial-sum instantiation) and the scale epilogue
(:func:`mac_epilogue_ref`, the twin of its epilogue kernel).

    out = (x_q . w_q) * x_scale * w_scale   [then max(out, 0)]

The integer dot is a float64 matmul of the integer operands, exact while
every partial sum stays below 2**53 (int16 x int16 at any K <= 2**22), then
wrapped modulo 2**32 to int32 as XLA's int32 ``dot_general`` wraps. It runs
on CPU and CUDA tensors alike and is bitwise equal to the reference and to
the Hopper kernel.
"""
from __future__ import annotations

import torch

from ..cordic_fused.ref import wrap_int32


def mac_matmul_partial_ref(x_q, w_q) -> torch.Tensor:
    """The exact int32 dot of ``x_q: (M, K)`` and ``w_q: (K, N)`` integers,
    wrapped modulo 2**32. Sums of such partials over K shards, wrapped the
    same way, equal the dot over the whole of K."""
    return wrap_int32((x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int64))


def mac_epilogue_ref(acc, x_scale, w_scale, *, fuse_relu: bool = False) -> torch.Tensor:
    """The epilogue on an int32 dot ``acc (M, N)``: ``(float(acc) * x_scale)
    * w_scale`` with ``x_scale: (M, 1)`` and ``w_scale: (1, N)`` f32, then
    the optional ReLU. f32 out."""
    out = acc.to(torch.float32) * x_scale * w_scale
    if fuse_relu:
        out = torch.clamp(out, min=0.0)
    return out


def mac_matmul_ref(x_q, w_q, x_scale, w_scale, *, fuse_relu: bool = False) -> torch.Tensor:
    """``x_q: (M, K)`` and ``w_q: (K, N)`` integers, ``x_scale: (M, 1)`` and
    ``w_scale: (1, N)`` f32. Returns f32 ``(M, N)``."""
    return mac_epilogue_ref(mac_matmul_partial_ref(x_q, w_q), x_scale, w_scale,
                            fuse_relu=fuse_relu)
