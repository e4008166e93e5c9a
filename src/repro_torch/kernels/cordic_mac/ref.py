"""Plain PyTorch version of the MAC-array matmul (port of
``repro.kernels.cordic_mac.ref.mac_matmul_ref``).

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


def mac_matmul_ref(x_q, w_q, x_scale, w_scale, *, fuse_relu: bool = False) -> torch.Tensor:
    """``x_q: (M, K)`` and ``w_q: (K, N)`` integers, ``x_scale: (M, 1)`` and
    ``w_scale: (1, N)`` f32. Returns f32 ``(M, N)``."""
    acc = wrap_int32((x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int64))
    out = acc.to(torch.float32) * x_scale * w_scale
    if fuse_relu:
        out = torch.clamp(out, min=0.0)
    return out
