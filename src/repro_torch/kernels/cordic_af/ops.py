"""Wrapper of the standalone multi-AF kernel (``csrc/cordic_af.cu``).

Replaces the TPU kernel ``repro/kernels/cordic_af/kernel.py:
_af_elementwise_kernel`` (``af_elementwise``, called by
``ops.multi_af_pallas``). On an H100 it is bound by the CORDIC loops' int32
operations, not by its 8 bytes per element; the kernel is a grid-stride
elementwise pass over the flat tensor that runs the same integer datapath as
the fused dot+AF kernel's epilogue (``kernels/include/cordic_af.cuh``).

A CPU tensor runs the plain version (:func:`multi_af_ref`); a CUDA tensor
launches the kernel or raises. ``multi_af.launches`` counts launches. The
kernel is bitwise equal to the plain version. Softmax, the seventh AF, is
the ``af_softmax`` kernel's and is not yet ported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.core.activations import ELEMENTWISE_AFS
from repro_torch.core.fxp import FXP8, FxPFormat

from .. import _build
from ..af_table import af_table_on
from .ref import multi_af_ref


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("cordic_af")
    p = ctypes.c_void_p
    lib.cordic_af_launch.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p]
    lib.cordic_af_launch.restype = ctypes.c_int
    return lib


def _mode_name(mode: Union[str, int]) -> str:
    if isinstance(mode, str):
        if mode == "softmax":
            raise NotImplementedError(
                "softmax needs the af_softmax kernel, not yet ported")
        if mode not in ELEMENTWISE_AFS:
            raise ValueError(f"mode must be one of {ELEMENTWISE_AFS}, got {mode!r}")
        return mode
    if not 0 <= int(mode) < len(ELEMENTWISE_AFS):
        raise ValueError(f"mode index {mode} out of range for {ELEMENTWISE_AFS}")
    return ELEMENTWISE_AFS[int(mode)]


def _launch(x, mode: str, depth: int, fmt: FxPFormat):
    dev = x.device
    flat = x.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty_like(flat)
    if flat.numel() == 0:
        return out.reshape(x.shape)
    tab = af_table_on(dev, depth, fmt)
    with torch.cuda.device(dev):
        status = _lib().cordic_af_launch(
            flat.data_ptr(), out.data_ptr(), tab.data_ptr(), flat.numel(),
            ELEMENTWISE_AFS.index(mode), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_af_launch")
    multi_af.launches += 1
    return out.reshape(x.shape)


def multi_af(x, mode: Union[str, int], *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """One elementwise AF of the multi-AF block on a float tensor of any shape.

    ``mode`` is a name or an index into ``ELEMENTWISE_AFS``; ``depth`` is the
    I/O-format CORDIC depth and ``fmt`` the I/O format. Returns f32 of the
    input's shape.
    """
    name = _mode_name(mode)
    if not x.is_cuda:
        return multi_af_ref(x, name, depth=depth, fmt=fmt)
    return _launch(x, name, int(depth), fmt)


multi_af.launches = 0
