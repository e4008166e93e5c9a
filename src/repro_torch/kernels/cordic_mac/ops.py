"""Wrapper of the MAC-array matmul kernel (``csrc/cordic_mac.cu``) and the
CARMEN semantics around it (port of ``repro.kernels.cordic_mac.ops``):

* activations -> binary-point quantization into ``x_fmt`` (saturating),
  stored int8/int16: the PE's activation memory bank;
* weights -> depth-d signed-digit rounding in ``w_fmt`` (the whole arithmetic
  effect of a depth-d linear-CORDIC multiplier), stored int8/int16: the PE's
  weight memory bank;
* :func:`mac_matmul` -> the integer matmul with the requant (+ReLU) epilogue.

Replaces the TPU kernel ``repro/kernels/cordic_mac/kernel.py:_mac_kernel``.
Both banks are K-major: ``x_q`` is ``(M, K)`` with 16-byte-aligned rows and
the weight bank ``(K, N)`` is stored as N rows of K (``stride == (1,
K_pad)``); the kernel refuses any other layout. ``int_dot.plan`` picks the
path: int8 at prefill (M > 16) on the int8 tensor cores (TMA + ``wgmma``),
bound by the multiply-adds; int8 at decode a loop that streams every weight
byte once, bound by the weight bytes; FxP16 the int32 CUDA-core loop. See
the source's header note. The kernel masks ragged edges, so nothing is
padded to the reference's 256-tiles. The two quantizations stay PyTorch
ops, as the reference leaves them to XLA outside its Pallas kernel.

``mac_matmul`` on a CPU tensor runs the plain version (:func:`mac_matmul_ref`);
on a CUDA tensor it launches the kernel or raises; on a meta tensor it takes
the plan and returns an empty meta result. ``mac_matmul.launches``
counts launches, ``mac_matmul.instantiations`` them by path.

:func:`mac_matmul_scaled_grad` is ``mac_matmul`` under autograd, with the
reference's gradient (``repro.core.backends.int8.int8_dot`` computes
``acc.astype(f32) * x_scale * w_scale``): the integer operands carry none,
the scales the VJP of that product, ``Σ_n g·acc·w_scale`` to ``x_scale``
and ``Σ_m g·acc·x_scale`` to ``w_scale``. Its backward takes ``float(acc)``
from a second launch of the kernel at unit scales (counted like any other);
on CPU tensors both launches are the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import cordic, fxp
from repro_torch.core.fxp import FXP8, FXP8_UNIT, FxPFormat

from .. import _build, costs, entry, kernel_call
from ..int_dot import (PATH_NAMES, has_aligned_rows, is_k_major, plan, ptr, splitk_scratch,
                       to_k_major)
from .ref import mac_matmul_ref

_INT_TYPES = (torch.int8, torch.int16)


def quantize_weights(w, depth: int, w_fmt: FxPFormat = FXP8_UNIT):
    """Weight memory bank: K-major signed-digit ints + the (scalar) bank scale."""
    w_q = cordic.signed_digit_ints(w, int(depth), w_fmt).to(w_fmt.storage_dtype)
    return to_k_major(w_q), float(np.float32(w_fmt.scale))


def quantize_activations(x, x_fmt: FxPFormat = FXP8):
    """Activation memory bank: saturating quantization into ``x_fmt``, int8/int16,
    ``(M, K)`` rows 16-byte aligned (padded when K is not)."""
    x_q = fxp.quantize(x, x_fmt).to(x_fmt.storage_dtype)
    if x_q.ndim == 2 and not has_aligned_rows(x_q):
        x_q = to_k_major(x_q.T).T  # (M, K_pad) storage viewed as (M, K)
    return x_q, float(np.float32(x_fmt.scale))


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("cordic_mac")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cordic_mac_launch.argtypes = [i, i, i, i, p, i, i, p, i, i, p, p, p, p, p, i, i, i, i, p]
    lib.cordic_mac_launch.restype = i
    return lib


def _launch(x_q, w_q, x_scale, w_scale, fuse_relu: bool):
    dev = x_q.device
    for name, t in (("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if t.device != dev:
            raise ValueError(f"mac_matmul: x_q on {dev}, {name} on {t.device}")
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.dtype not in _INT_TYPES or t.ndim != 2:
            raise ValueError(f"mac_matmul: {name} must be 2-D int8/int16, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not has_aligned_rows(x_q):
        raise ValueError(f"mac_matmul: x_q must be (M, K) with K contiguous and 16-byte-aligned "
                         f"rows, got stride {tuple(x_q.stride())}")
    if not is_k_major(w_q):
        raise ValueError(f"mac_matmul: w_q must be a K-major bank (stride (1, K_pad), K_pad * "
                         f"{w_q.element_size()} bytes a multiple of 16, 16-byte aligned), got "
                         f"stride {tuple(w_q.stride())}")
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
    p = plan(m, n, k, x_q.element_size(), w_q.element_size())
    cost = functools.partial(costs.cordic_mac, m, n, k, x_q.element_size())
    if dev.type == "meta":
        kernel_call(mac_matmul, PATH_NAMES[p.path], cost, launched=False)
        return out
    ws, counts = splitk_scratch(m, n, p, dev)
    with torch.cuda.device(dev):
        status = _lib().cordic_mac_launch(
            p.path, p.config, p.splits, p.k_per_split, x_q.data_ptr(), x_q.element_size(),
            x_q.stride(0), w_q.data_ptr(), w_q.element_size(), w_q.stride(1), xs.data_ptr(),
            wsc.data_ptr(), out.data_ptr(), ptr(ws), ptr(counts), m, n, k, int(fuse_relu),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_mac_launch")
    kernel_call(mac_matmul, PATH_NAMES[p.path], cost, launched=True)
    return out


@entry("cordic_mac")
def mac_matmul(x_q, w_q, x_scale, w_scale, *, fuse_relu: bool = False) -> torch.Tensor:
    """Blocked integer matmul with the requant (+ReLU) epilogue.

    ``x_q: (M, K)`` int8/int16 quantized activations, ``w_q: (K, N)``
    int8/int16 signed-digit weights (on a CUDA device: 16-byte-aligned rows
    and a K-major bank), ``x_scale: (M, 1)`` and ``w_scale: (1, N)`` f32.
    Returns f32 ``(M, N)``.
    """
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"mac_matmul: shapes {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if not (x_q.is_cuda or x_q.is_meta):
        return mac_matmul_ref(x_q, w_q, x_scale, w_scale, fuse_relu=fuse_relu)
    return _launch(x_q, w_q, x_scale, w_scale, fuse_relu)


class MacMatmulScaledGrad(torch.autograd.Function):
    """``mac_matmul`` forward; the backward of ``(acc * x_scale) * w_scale``
    to the two scales."""

    @staticmethod
    def forward(ctx, x_q, w_q, x_scale, w_scale):
        ctx.save_for_backward(x_q, w_q, x_scale, w_scale)
        return mac_matmul(x_q, w_q, x_scale, w_scale)

    @staticmethod
    def backward(ctx, g):
        x_q, w_q, x_scale, w_scale = ctx.saved_tensors
        acc = mac_matmul(x_q, w_q, torch.ones_like(x_scale), torch.ones_like(w_scale))
        d_x_scale = d_w_scale = None
        if ctx.needs_input_grad[2]:
            d_x_scale = torch.sum(g * w_scale.reshape(1, -1) * acc, dim=1,
                                  keepdim=True).reshape(x_scale.shape)
        if ctx.needs_input_grad[3]:
            d_w_scale = torch.sum(g * (acc * x_scale.reshape(-1, 1)), dim=0,
                                  keepdim=True).reshape(w_scale.shape)
        return None, None, d_x_scale, d_w_scale


def mac_matmul_scaled_grad(x_q, w_q, x_scale, w_scale):
    """:func:`mac_matmul`, differentiable in ``x_scale`` and ``w_scale``."""
    return MacMatmulScaledGrad.apply(x_q, w_q, x_scale, w_scale)


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
        w_q = to_k_major(fxp.to_int32(grid).to(w_fmt.storage_dtype))
        ws = float(np.float32(w_fmt.scale))
    else:
        w_q, ws = quantize_weights(w, depth, w_fmt)
    n = w_q.shape[1]
    x_scale = torch.full((m, 1), xs, dtype=torch.float32, device=x_q.device)
    w_scale = torch.full((1, n), ws, dtype=torch.float32, device=x_q.device)
    return mac_matmul(x_q, w_q, x_scale, w_scale, fuse_relu=fuse_relu)
