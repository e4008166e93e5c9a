"""Wrapper of the fused CORDIC dot+AF kernel (``csrc/cordic_fused.cu``).

Replaces the TPU kernel ``repro/kernels/cordic_fused/kernel.py:fused_kernel``
(``ops.fused_dot_af``). The bank ``w`` is K-major (``w.stride() == (1,
K_pad)``, columns 16-byte aligned), as ``prepare_params`` stores it; any
other layout is refused, never copied. ``int_dot.plan`` picks the path: at
prefill (M > 16, int8) x is quantized once to int8 and the product runs on
the int8 tensor cores (TMA + ``wgmma``), bound by the multiply-adds; at
decode (M <= 16) a loop that streams every weight byte once, bound by the
weight bytes, splitting K where columns are few; FxP16 (int16) banks run the
int32 CUDA-core loop. See the source's header note.

A CPU tensor runs the plain version (:func:`fused_dot_af_ref`); a CUDA tensor
launches the kernel or raises; a meta tensor takes the plan and returns an
empty meta result. ``fused_dot_af.launches`` counts calls that launch (one
per call, the quantize pass of the prefill path included), and
``fused_dot_af.instantiations`` the same calls by path.

For tensor-parallel row products the chain runs in two launches around a
cross-rank int32 sum: :func:`fused_dot_partial` (the partial-sum
instantiations of the same three paths: the int32 dot, no epilogue) and
:func:`fused_epilogue` (the descale, bf16 round and AF on the reduced sums),
counted on their own wrappers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import activations as afs
from repro_torch.core.backends.kernel import POINT_LEN
from repro_torch.core.fxp import FXP8, FxPFormat

from .. import _build, costs, entry, kernel_call
from ..af_table import af_table_on
from ..int_dot import PATH_NAMES, WGMMA, is_k_major, padded_k, plan, ptr, splitk_scratch
from .ref import fused_dot_af_ref, fused_dot_partial_ref, fused_epilogue_ref

FUSED_AFS = ("identity",) + afs.ELEMENTWISE_AFS


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("cordic_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cordic_fused_launch.argtypes = [i, i, i, i, p, p, i, p, i, i, p, p, p, p, p, i, i, i, i,
                                        i, p]
    lib.cordic_fused_launch.restype = i
    lib.cordic_fused_partial_launch.argtypes = [i, i, i, i, p, p, i, p, i, i, p, p, p, p, i, i,
                                                i, p]
    lib.cordic_fused_partial_launch.restype = i
    lib.cordic_fused_epilogue_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.cordic_fused_epilogue_launch.restype = i
    return lib


def _check_operands(x2, w, point):
    dev = x2.device
    if w.device != dev or point.device != dev:
        raise ValueError(f"fused_dot_af: x on {dev}, w on {w.device}, point on {point.device}")
    if w.dtype not in (torch.int8, torch.int16) or w.ndim != 2:
        raise ValueError(f"fused_dot_af: w must be a 2-D int8/int16 bank, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if not is_k_major(w):
        raise ValueError(f"fused_dot_af: w must be a K-major bank (stride (1, K_pad), K_pad * "
                         f"{w.element_size()} bytes a multiple of 16, 16-byte aligned), got "
                         f"stride {tuple(w.stride())}")
    if point.dtype != torch.int32 or point.numel() != POINT_LEN or not point.is_contiguous():
        raise ValueError("fused_dot_af: point must be a contiguous int32[5]")


def _launch(x2, w, point, mode: int, af_depth: int, af_fmt: FxPFormat, compute_round: bool):
    _check_operands(x2, w, point)
    dev = x2.device
    m, k = x2.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    p = plan(m, n, k, w.element_size(), w.element_size())
    cost = functools.partial(costs.fused_dot_af, m, n, k, w.element_size(), FUSED_AFS[mode],
                             af_depth, af_fmt)
    if dev.type == "meta":
        kernel_call(fused_dot_af, PATH_NAMES[p.path], cost, launched=False)
        return out
    ws, counts = splitk_scratch(m, n, p, dev)
    xq, ldq = None, 0
    if p.path == WGMMA:  # x quantized once, to int8 rows TMA can read
        ldq = padded_k(k, 1)
        xq = torch.empty((m, ldq), dtype=torch.int8, device=dev)
    tab = af_table_on(dev, af_depth, af_fmt)
    with torch.cuda.device(dev):
        status = _lib().cordic_fused_launch(
            p.path, p.config, p.splits, p.k_per_split, x2.data_ptr(), ptr(xq), ldq,
            w.data_ptr(), w.element_size(), w.stride(1), point.data_ptr(), tab.data_ptr(),
            out.data_ptr(), ptr(ws), ptr(counts), m, n, k, mode, int(compute_round),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_fused_launch")
    kernel_call(fused_dot_af, PATH_NAMES[p.path], cost, launched=True)
    return out


@entry("fused_dot_af")
def fused_dot_af(x, w, point, *, af_mode: str = "identity", af_depth: int = 8,
                 af_fmt: FxPFormat = FXP8, compute_round: bool = False):
    """Fused prepared dot + activation: float ``(..., K)`` x int ``(K, N)`` -> f32 ``(..., N)``.

    ``w`` holds the signed-digit weight integers (int8 / int16), K-major on
    a CUDA device; ``point`` is the int32[5] execution-point vector read by
    the kernel at run time.
    """
    if af_mode not in FUSED_AFS:
        raise ValueError(f"af_mode must be one of {FUSED_AFS}, got {af_mode!r}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if not (x.is_cuda or x.is_meta):
        return fused_dot_af_ref(x, w, point, af_mode=af_mode, af_depth=af_depth,
                                af_fmt=af_fmt, compute_round=compute_round)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    out = _launch(x2, w, point, FUSED_AFS.index(af_mode), int(af_depth), af_fmt,
                  compute_round)
    return out.reshape(*lead, w.shape[1])


def _launch_partial(x2, w, point):
    _check_operands(x2, w, point)
    dev = x2.device
    m, k = x2.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    p = plan(m, n, k, w.element_size(), w.element_size())
    cost = functools.partial(costs.fused_dot_partial, m, n, k, w.element_size())
    if dev.type == "meta":
        kernel_call(fused_dot_partial, PATH_NAMES[p.path], cost, launched=False)
        return out
    ws, counts = splitk_scratch(m, n, p, dev)
    xq, ldq = None, 0
    if p.path == WGMMA:
        ldq = padded_k(k, 1)
        xq = torch.empty((m, ldq), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        status = _lib().cordic_fused_partial_launch(
            p.path, p.config, p.splits, p.k_per_split, x2.data_ptr(), ptr(xq), ldq,
            w.data_ptr(), w.element_size(), w.stride(1), point.data_ptr(), out.data_ptr(),
            ptr(ws), ptr(counts), m, n, k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_fused_partial_launch")
    kernel_call(fused_dot_partial, PATH_NAMES[p.path], cost, launched=True)
    return out


@entry("fused_dot_partial")
def fused_dot_partial(x, w, point):
    """The int32 dot of :func:`fused_dot_af` without its epilogue: float
    ``(..., K)`` x int ``(K, N)`` -> int32 ``(..., N)``, wrapped modulo 2**32.
    A row-parallel product sums these over its K shards (an int32 sum, exact
    in any order) and runs :func:`fused_epilogue` on the sum. Same operands,
    layout rules and paths (``int_dot.plan``) as the fused wrapper."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if not (x.is_cuda or x.is_meta):
        return fused_dot_partial_ref(x, w, point)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    return _launch_partial(x2, w, point).reshape(*lead, w.shape[1])


def _launch_epilogue(acc2, point, mode: int, af_depth: int, af_fmt: FxPFormat,
                     compute_round: bool):
    dev = acc2.device
    if point.device != dev:
        raise ValueError(f"fused_epilogue: acc on {dev}, point on {point.device}")
    if acc2.dtype != torch.int32:
        raise ValueError(f"fused_epilogue: acc must be int32, got {acc2.dtype}")
    if point.dtype != torch.int32 or point.numel() != POINT_LEN or not point.is_contiguous():
        raise ValueError("fused_epilogue: point must be a contiguous int32[5]")
    m, n = acc2.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    cost = functools.partial(costs.fused_epilogue, m, n, FUSED_AFS[mode], af_depth, af_fmt)
    if dev.type == "meta":
        kernel_call(fused_epilogue, "elementwise", cost, launched=False)
        return out
    if m == 0 or n == 0:
        return out
    tab = af_table_on(dev, af_depth, af_fmt)
    with torch.cuda.device(dev):
        status = _lib().cordic_fused_epilogue_launch(
            acc2.data_ptr(), point.data_ptr(), tab.data_ptr(), out.data_ptr(), m, n, mode,
            int(compute_round), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "cordic_fused_epilogue_launch")
    kernel_call(fused_epilogue, "elementwise", cost, launched=True)
    return out


@entry("fused_epilogue")
def fused_epilogue(acc, point, *, af_mode: str = "identity", af_depth: int = 8,
                   af_fmt: FxPFormat = FXP8, compute_round: bool = False):
    """The epilogue of :func:`fused_dot_af` on int32 dot sums ``acc (..., N)``:
    the point's descale, the optional bf16 round and the AF; f32 out.
    ``fused_epilogue(fused_dot_partial(x, w, p), p, ...)`` is bitwise
    ``fused_dot_af(x, w, p, ...)``."""
    if af_mode not in FUSED_AFS:
        raise ValueError(f"af_mode must be one of {FUSED_AFS}, got {af_mode!r}")
    if not (acc.is_cuda or acc.is_meta):
        return fused_epilogue_ref(acc, point, af_mode=af_mode, af_depth=af_depth,
                                  af_fmt=af_fmt, compute_round=compute_round)
    lead = acc.shape[:-1]
    acc2 = acc.reshape(-1, acc.shape[-1]).contiguous()
    out = _launch_epilogue(acc2, point, FUSED_AFS.index(af_mode), int(af_depth), af_fmt,
                           compute_round)
    return out.reshape(*lead, acc.shape[-1])
