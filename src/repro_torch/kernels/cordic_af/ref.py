"""Plain PyTorch version of the standalone multi-AF block (port of
``repro.kernels.cordic_af.kernel._af_elementwise_kernel``).

It is ``core.activations.multi_af_float`` on f32: quantize to ``fmt``,
requantize to the guard-bit internal format, the CORDIC AF at
``max(depth + guard, 2)``, requantize back, dequantize. It runs on CPU and
CUDA tensors alike and is bitwise equal to the reference and to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import activations as afs
from repro_torch.core.fxp import FXP8, FxPFormat


def multi_af_ref(x, mode: str, *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """Float in, f32 out, of the same shape; ``mode`` names an elementwise AF."""
    return afs.multi_af_float(torch.as_tensor(x).to(torch.float32), mode, int(depth), fmt)
