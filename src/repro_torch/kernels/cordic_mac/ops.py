"""Wrapper of the MAC-array matmul kernel (``csrc/cordic_mac.cu``) and the
CARMEN semantics around it (port of ``repro.kernels.cordic_mac.ops``):

* activations -> binary-point quantization into ``x_fmt`` (saturating),
  stored int8/int16: the PE's activation memory bank;
* weights -> depth-d signed-digit rounding in ``w_fmt`` (the whole arithmetic
  effect of a depth-d linear-CORDIC multiplier), stored int8/int16: the PE's
  weight memory bank;
* :func:`mac_matmul` -> the integer matmul with the requant (+ReLU) epilogue.

Replaces the TPU kernel ``repro/kernels/cordic_mac/kernel.py:_mac_kernel``.
On an H100 it is bound by the weight bytes at decode and by integer
multiply-adds at a prefill bucket; see the source's header note. The kernel
masks ragged edges, so nothing is padded to the reference's 256-tiles. The
two quantizations stay PyTorch ops, as the reference leaves them to XLA
outside its Pallas kernel.

``mac_matmul`` on a CPU tensor runs the plain version (:func:`mac_matmul_ref`);
on a CUDA tensor it launches the kernel or raises. ``mac_matmul.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import cordic, fxp
from repro_torch.core.fxp import FXP8, FXP8_UNIT, FxPFormat

from .. import _build
from ..int_dot import plan, ptr, splitk_scratch, vector_loads
from .ref import mac_matmul_ref

_INT_TYPES = (torch.int8, torch.int16)


def quantize_weights(w, depth: int, w_fmt: FxPFormat = FXP8_UNIT):
    """Weight memory bank: contiguous signed-digit ints + the (scalar) bank scale."""
    w_q = cordic.signed_digit_ints(w, int(depth), w_fmt).to(w_fmt.storage_dtype)
    return w_q.contiguous(), float(np.float32(w_fmt.scale))


def quantize_activations(x, x_fmt: FxPFormat = FXP8):
    """Activation memory bank: saturating quantization into ``x_fmt``, int8/int16."""
    return fxp.quantize(x, x_fmt).to(x_fmt.storage_dtype), float(np.float32(x_fmt.scale))


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("cordic_mac")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cordic_mac_launch.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.cordic_mac_launch.restype = i
    return lib


def _launch(x_q, w_q, x_scale, w_scale, fuse_relu: bool):
    dev = x_q.device
    for name, t in (("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if t.device != dev:
            raise ValueError(f"mac_matmul: x_q on {dev}, {name} on {t.device}")
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.dtype not in _INT_TYPES or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"mac_matmul: {name} must be contiguous 2-D int8/int16, got "
                             f"{t.dtype} {tuple(t.shape)}")
    m, k = x_q.shape
    n = w_q.shape[1]
    xs = x_scale.reshape(-1).contiguous()
    wsc = w_scale.reshape(-1).contiguous()
    if xs.dtype != torch.float32 or wsc.dtype != torch.float32 or xs.numel() != m \
            or wsc.numel() != n:
        raise ValueError(f"mac_matmul: scales must be f32 ({m}, 1) and (1, {n}), got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)} and {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    config, splits, k_per_split = plan(m, n, k)
    ws, counts = splitk_scratch(m, n, config, splits, dev)
    with torch.cuda.device(dev):
        status = _lib().cordic_mac_launch(
            x_q.data_ptr(), x_q.element_size(), w_q.data_ptr(), w_q.element_size(),
            xs.data_ptr(), wsc.data_ptr(), out.data_ptr(), ptr(ws), ptr(counts), m, n, k,
            config, splits, k_per_split, int(fuse_relu), vector_loads(w_q),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_mac_launch")
    mac_matmul.launches += 1
    return out


def mac_matmul(x_q, w_q, x_scale, w_scale, *, fuse_relu: bool = False) -> torch.Tensor:
    """Blocked integer matmul with the requant (+ReLU) epilogue.

    ``x_q: (M, K)`` int8/int16 quantized activations, ``w_q: (K, N)``
    int8/int16 signed-digit weights, ``x_scale: (M, 1)`` and ``w_scale:
    (1, N)`` f32. Returns f32 ``(M, N)``.
    """
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"mac_matmul: shapes {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if not x_q.is_cuda:
        return mac_matmul_ref(x_q, w_q, x_scale, w_scale, fuse_relu=fuse_relu)
    return _launch(x_q, w_q, x_scale, w_scale, fuse_relu)


mac_matmul.launches = 0


def cordic_mac(x, w, *, depth: int, x_fmt: FxPFormat = FXP8, w_fmt: FxPFormat = FXP8_UNIT,
               fuse_relu: bool = False, w_prequantized: bool = False) -> torch.Tensor:
    """CARMEN MAC-array matmul: float ``(M, K)`` x ``(K, N)`` -> f32 ``(M, N)``.

    ``w_prequantized=True`` declares that ``w`` already carries depth-``depth``
    signed-digit values (a prepared weight bank): the rounding recurrence is
    skipped and the values are cast straight onto the integer grid.
    """
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    x_q, xs = quantize_activations(x, x_fmt)
    if w_prequantized:
        grid = torch.round(torch.as_tensor(w, dtype=torch.float32) * float(1 << w_fmt.frac))
        w_q = fxp.to_int32(grid).to(w_fmt.storage_dtype).contiguous()
        ws = float(np.float32(w_fmt.scale))
    else:
        w_q, ws = quantize_weights(w, depth, w_fmt)
    n = w_q.shape[1]
    x_scale = torch.full((m, 1), xs, dtype=torch.float32, device=x_q.device)
    w_scale = torch.full((1, n), ws, dtype=torch.float32, device=x_q.device)
    return mac_matmul(x_q.contiguous(), w_q, x_scale, w_scale, fuse_relu=fuse_relu)
