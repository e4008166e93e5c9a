"""Wrappers of the standalone multi-AF kernels: the six elementwise AFs
(``csrc/cordic_af.cu``) and the row softmax (``csrc/af_softmax.cu``).

They replace the TPU kernels ``repro/kernels/cordic_af/kernel.py:
_af_elementwise_kernel`` (``af_elementwise``) and ``_af_softmax_kernel``
(``af_softmax``), both called by ``ops.multi_af_pallas``. On an H100 both
are bound by the CORDIC loops' int32 operations, not by their 8 bytes per
element, and both run the same integer datapath as the fused dot+AF
kernel's epilogue (``kernels/include/cordic_af.cuh``). The elementwise
kernel is a grid-stride pass over the flat tensor; the softmax kernel takes
one row per block.

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises. ``multi_af.launches`` counts elementwise launches and
``af_softmax.launches`` softmax launches. Both kernels are bitwise equal to
their plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.core.activations import ELEMENTWISE_AFS, internal_fmt, softmax_shift
from repro_torch.core.fxp import FXP8, FxPFormat

from .. import _build
from ..af_table import af_table_on
from .ref import af_softmax_ref, multi_af_ref


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("cordic_af")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cordic_af_launch.argtypes = [p, p, p, ctypes.c_longlong, i, p]
    lib.cordic_af_launch.restype = i
    lib.af_softmax_launch.argtypes = [p, p, p, i, i, i, p]
    lib.af_softmax_launch.restype = i
    return lib


def af_index(mode: str) -> int:
    """Runtime mode index of a named AF (elementwise set)."""
    if mode == "softmax":
        raise ValueError("softmax routes to the reduction kernel; pass mode='softmax'")
    return ELEMENTWISE_AFS.index(mode)


def _mode_name(mode: Union[str, int]) -> str:
    if isinstance(mode, str):
        if mode not in ELEMENTWISE_AFS:
            raise ValueError(f"mode must be one of {ELEMENTWISE_AFS} or 'softmax', "
                             f"got {mode!r}")
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
            af_index(mode), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_af_launch")
    multi_af.launches += 1
    return out.reshape(x.shape)


def _launch_softmax(x2, depth: int, fmt: FxPFormat):
    dev = x2.device
    out = torch.empty_like(x2)
    rows, n = x2.shape
    if rows == 0 or n == 0:
        return out
    tab = af_table_on(dev, depth, fmt)
    with torch.cuda.device(dev):
        status = _lib().af_softmax_launch(
            x2.data_ptr(), out.data_ptr(), tab.data_ptr(), rows, n,
            softmax_shift(n, internal_fmt(fmt).frac), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "af_softmax_launch")
    af_softmax.launches += 1
    return out


def af_softmax(x, *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """Row-wise fixed-point softmax of a float ``(M, N)`` tensor -> f32 ``(M, N)``."""
    if x.ndim != 2:
        raise ValueError(f"af_softmax takes (M, N) rows, got {tuple(x.shape)}")
    if not x.is_cuda:
        return af_softmax_ref(x, depth=depth, fmt=fmt)
    return _launch_softmax(x.to(torch.float32).contiguous(), int(depth), fmt)


af_softmax.launches = 0


def multi_af(x, mode: Union[str, int], *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """One AF of the multi-AF block on a float tensor of any shape.

    ``mode`` is a name or an index into ``ELEMENTWISE_AFS``; ``"softmax"``
    must be named and reduces over the last axis. ``depth`` is the I/O-format
    CORDIC depth and ``fmt`` the I/O format. Returns f32 of the input's shape.
    """
    if isinstance(mode, str) and mode == "softmax":
        x = torch.as_tensor(x)
        return af_softmax(x.reshape(-1, x.shape[-1]), depth=depth, fmt=fmt).reshape(x.shape)
    name = _mode_name(mode)
    if not x.is_cuda:
        return multi_af_ref(x, name, depth=depth, fmt=fmt)
    return _launch(x, name, int(depth), fmt)


multi_af.launches = 0
