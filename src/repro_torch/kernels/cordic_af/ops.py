"""Wrappers of the standalone multi-AF kernels: the six elementwise AFs
(``csrc/cordic_af.cu``) and the row softmax (``csrc/af_softmax.cu``).

They replace the TPU kernels ``repro/kernels/cordic_af/kernel.py:
_af_elementwise_kernel`` (``af_elementwise``) and ``_af_softmax_kernel``
(``af_softmax``), both called by ``ops.multi_af_pallas``. On an H100 both
are bound by the CORDIC loops' int32 operations, not by their 8 bytes per
element, and both run the same integer datapath as the fused dot+AF
kernel's epilogue (``kernels/include/cordic_af.cuh``). The elementwise
kernel is a grid-stride pass over the flat tensor. The softmax kernel splits
each row over a thread-block cluster of 1 to 16 CTAs, as
:func:`softmax_plan` decides from the row count and width, and reduces the
row max and sum through the cluster's distributed shared memory; a slice
waits in shared memory, or, past ``SLICE_BYTES_CAP`` a CTA, in the output
row (the "staged" path).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises. ``multi_af.launches`` counts elementwise launches and
``af_softmax.launches`` softmax launches. Both kernels are bitwise equal to
their plain versions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple, Union

import torch

from repro_torch.core.activations import ELEMENTWISE_AFS, internal_fmt, softmax_shift
from repro_torch.core.fxp import FXP8, FxPFormat

from .. import _build, count_launch, new_counts
from ..af_table import af_table_on
from .ref import af_softmax_ref, multi_af_ref


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.library("cordic_af")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cordic_af_launch.argtypes = [p, p, p, ctypes.c_longlong, i, p]
    lib.cordic_af_launch.restype = i
    lib.af_softmax_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.af_softmax_launch.restype = i
    lib.af_softmax_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.af_softmax_max_clusters.restype = i
    return lib


CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is the H100's largest (non-portable) cluster
# no CTA takes fewer elements of a row, unless the row is shorter: a cluster
# launch costs ~2 us more than a plain one (benchmarks/softmax_probe.py on an
# H100), the time one CTA takes for ~1000 elements
MIN_SLICE = 1024
MAX_THREADS = 1024
SLICE_BYTES_CAP = 224 * 1024  # shared memory a CTA may hold its slice in (csrc: MAX_SLICE_BYTES)
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SoftmaxPlan:
    """How ``af_softmax_cluster_kernel`` runs a ``(rows, n)`` softmax: a
    cluster of ``cluster`` CTAs a row, CTA ``r`` on elements ``[r * slice,
    (r + 1) * slice)`` of it (cut at ``n``), ``threads`` threads a CTA and
    ``smem_bytes`` of dynamic shared memory for its slice (``path ==
    "shared"``) or none (``"staged"``: the slice waits in the output row).
    ``planned_cluster`` is the size :func:`softmax_plan` chose before the
    device refused to schedule it, else equal to ``cluster``."""
    rows: int
    n: int
    cluster: int
    slice: int
    threads: int
    smem_bytes: int
    path: str
    planned_cluster: int

    def bounds(self) -> List[Tuple[int, int]]:
        """``(lo, hi)`` of each CTA's slice of a row, in rank order."""
        return [(min(r * self.slice, self.n), min((r + 1) * self.slice, self.n))
                for r in range(self.cluster)]


def _slice(n: int, c: int) -> int:
    return -(-n // c)


def softmax_plan(rows: int, n: int, *, sms: int = H100_SMS, max_cluster: int = 16) -> SoftmaxPlan:
    """The launch plan of a ``(rows, n)`` row softmax on a card of ``sms``
    SMs: the smallest cluster size that gives ``rows * c >= sms`` CTAs (at
    most ``max_cluster``), cut down until no slice is shorter than
    ``MIN_SLICE``, then raised until a slice fits ``SLICE_BYTES_CAP`` of
    shared memory; where none does, the largest allowed size on the staged
    path. Threads: up to ``MAX_THREADS``, each taking an equal share of the
    slice, a whole number of warps. Pure Python."""
    if rows <= 0 or n <= 0:
        raise ValueError(f"softmax_plan needs rows > 0 and n > 0, got ({rows}, {n})")
    sizes = [c for c in CLUSTER_SIZES if c <= max_cluster]
    if not sizes:
        raise ValueError(f"max_cluster must be >= 1, got {max_cluster}")
    long_enough = [c for c in sizes if c == 1 or _slice(n, c) >= MIN_SLICE]
    c = next((c for c in long_enough if rows * c >= sms), long_enough[-1])
    fits = [c2 for c2 in sizes if c2 >= c and _slice(n, c2) * 4 <= SLICE_BYTES_CAP]
    path = "shared" if fits else "staged"
    c = fits[0] if fits else sizes[-1]
    slice_ = _slice(n, c)
    return SoftmaxPlan(rows=rows, n=n, cluster=c, slice=slice_, threads=slice_threads(slice_),
                       smem_bytes=4 * slice_ if path == "shared" else 0, path=path,
                       planned_cluster=c)


def slice_threads(slice_: int) -> int:
    """Threads a CTA for a slice: at most ``MAX_THREADS``, the fewest whole
    warps that give no thread more elements than ``MAX_THREADS`` would."""
    per_thread = _slice(slice_, MAX_THREADS)
    return 32 * _slice(_slice(slice_, per_thread), 32)


@functools.lru_cache(maxsize=None)
def _schedulable(device_index: int, cluster: int, threads: int, smem_bytes: int) -> bool:
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        status = _lib().af_softmax_max_clusters(cluster, threads, smem_bytes, ctypes.byref(count))
    _build.check(status, "af_softmax_max_clusters")
    return count.value > 0


def launch_plan(rows: int, n: int, device) -> SoftmaxPlan:
    """:func:`softmax_plan` for the card ``device``, with every cluster size
    the card cannot schedule (``cudaOccupancyMaxActiveClusters`` = 0: a
    GPC short of free SMs) replaced by the next one down; the plan keeps
    the size first chosen in ``planned_cluster``. Raises when not even one
    CTA a row can be scheduled."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = softmax_plan(rows, n, sms=sms)
    first = plan.cluster
    while not _schedulable(index, plan.cluster, plan.threads, plan.smem_bytes):
        if plan.cluster == 1:
            raise RuntimeError(f"af_softmax: the card cannot schedule {plan}")
        plan = dataclasses.replace(softmax_plan(rows, n, sms=sms, max_cluster=plan.cluster // 2),
                                   planned_cluster=first)
    return plan


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
    count_launch(multi_af, "elementwise")
    return out.reshape(x.shape)


def _launch_softmax(x2, depth: int, fmt: FxPFormat):
    dev = x2.device
    out = torch.empty_like(x2)
    rows, n = x2.shape
    if rows == 0 or n == 0:
        return out
    tab = af_table_on(dev, depth, fmt)
    plan = launch_plan(rows, n, dev)
    with torch.cuda.device(dev):
        status = _lib().af_softmax_launch(
            x2.data_ptr(), out.data_ptr(), tab.data_ptr(), rows, n, plan.cluster, plan.slice,
            plan.threads, plan.smem_bytes, int(plan.path == "staged"),
            softmax_shift(n, internal_fmt(fmt).frac), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "af_softmax_launch")
    count_launch(af_softmax, "cluster")
    return out


def af_softmax(x, *, depth: int, fmt: FxPFormat = FXP8) -> torch.Tensor:
    """Row-wise fixed-point softmax of a float ``(M, N)`` tensor -> f32 ``(M, N)``."""
    if x.ndim != 2:
        raise ValueError(f"af_softmax takes (M, N) rows, got {tuple(x.shape)}")
    if not x.is_cuda:
        return af_softmax_ref(x, depth=depth, fmt=fmt)
    return _launch_softmax(x.to(torch.float32).contiguous(), int(depth), fmt)


af_softmax.launches = 0
af_softmax.instantiations = new_counts("af_softmax")


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
multi_af.instantiations = new_counts("af_elementwise")
