"""Plain PyTorch versions of the standalone multi-AF block (port of
``repro.kernels.cordic_af.kernel._af_elementwise_kernel`` and
``_af_softmax_kernel``).

Both are ``core.activations.multi_af_float`` on f32: quantize to ``fmt``,
requantize to the guard-bit internal format, the CORDIC AF at
``max(depth + guard, 2)`` (softmax over the last axis), requantize back,
dequantize. They run on CPU and CUDA tensors alike and are bitwise equal to
the reference and to the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import activations as afs
from repro_torch.core.fxp import FXP8, FxPFormat


def multi_af_ref(x, mode: str, *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """Float in, f32 out, of the same shape; ``mode`` names an elementwise AF."""
    return afs.multi_af_float(torch.as_tensor(x).to(torch.float32), mode, int(depth), fmt)


def af_softmax_ref(x, *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """Row softmax over the last axis: float in, f32 out, of the same shape."""
    return multi_af_ref(x, "softmax", depth=depth, fmt=fmt)
