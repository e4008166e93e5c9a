"""PyTorch port: the launch plan of the row-softmax kernel
(``kernels/cordic_af/ops.softmax_plan``) and a slice-by-slice emulation of
what the kernel computes under it.

The Hopper kernel splits each row over a cluster of CTAs, one contiguous
slice a CTA, and combines the slices' partial maxima and partial shifted
sums in rank order. Here the plan is checked on the shapes ``chip_smoke.py``
times and on its edges (one element, rows shorter than the cluster would
be, ragged slices, rows past the shared-memory cap), and the emulation,
built from the port's ``core`` functions on the plan's slice bounds, is
held bitwise against the reference's ``multi_af_pallas`` (Pallas in
interpret mode on the CPU). The kernel itself is held against its plain
version on the card in ``test_torch_kernels_gpu.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fxp import FXP8 as J8, FXP16 as J16  # noqa: E402
from repro.kernels.cordic_af.ops import multi_af_pallas  # noqa: E402
from repro_torch.core import FXP8, FXP16, cordic, fxp  # noqa: E402
from repro_torch.core import activations as afs  # noqa: E402
from repro_torch.kernels.cordic_af import af_softmax, ops  # noqa: E402
from repro_torch.kernels.cordic_af.ops import (  # noqa: E402
    MAX_THREADS,
    MIN_SLICE,
    SLICE_BYTES_CAP,
    softmax_plan,
)
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

FMTS = {"fxp8": (FXP8, J8), "fxp16": (FXP16, J16)}
INT_MIN = -(2**31)
CAP_N = 16 * SLICE_BYTES_CAP // 4  # the widest row the shared path holds at c = 16

# (rows, n) -> (cluster, path) on an H100's 132 SMs
PLANS = {
    (64, 512): (1, "shared"),
    (1, 2 * MIN_SLICE - 2): (1, "shared"),  # two slices would be short of MIN_SLICE
    (1, 2 * MIN_SLICE): (2, "shared"),
    (5, 300): (1, "shared"),
    (4, 50304): (16, "shared"),
    (1, 50304): (16, "shared"),
    (4096, 64): (1, "shared"),
    (7, 17): (1, "shared"),
    (3, 1): (1, "shared"),
    (1, 1): (1, "shared"),
    (1, 5): (1, "shared"),  # the SM count asks for 16 CTAs, the row has 5 elements
    (1, 50305): (16, "shared"),  # 50305 = 16 x 3145 - 15: a short last slice
    (64, 50304): (4, "shared"),
    (200, 300_000): (8, "shared"),  # the SM count asks for 1, shared memory for 8
    (1, CAP_N): (16, "shared"),
    (1, CAP_N + 1): (16, "staged"),
    (2, 1_000_000): (16, "staged"),
}


def _check_plan(plan, rows, n):
    assert (plan.rows, plan.n) == (rows, n)
    bounds = plan.bounds()
    assert len(bounds) == plan.cluster
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):  # contiguous, in rank order
        assert lo <= hi == lo2
    covered = np.zeros(n, np.int64)
    for lo, hi in bounds:
        assert hi - lo <= plan.slice
        covered[lo:hi] += 1
    assert (covered == 1).all()  # every element in exactly one slice
    assert all(hi > lo for lo, hi in bounds)  # no CTA idles
    if plan.cluster > 1:
        assert min(hi - lo for lo, hi in bounds[:-1]) >= MIN_SLICE
    assert plan.smem_bytes == (4 * plan.slice if plan.path == "shared" else 0)
    assert plan.smem_bytes <= SLICE_BYTES_CAP
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    # the slice spread evenly: no thread takes more elements than it must
    assert -(-plan.slice // plan.threads) == -(-plan.slice // MAX_THREADS)


@pytest.mark.parametrize("rows,n", sorted(PLANS), ids=[f"{r}x{n}" for r, n in sorted(PLANS)])
def test_softmax_plan(rows, n):
    plan = softmax_plan(rows, n)
    assert (plan.cluster, plan.path) == PLANS[(rows, n)]
    assert plan.planned_cluster == plan.cluster
    _check_plan(plan, rows, n)


def test_softmax_plan_fields_at_decode_width():
    plan = softmax_plan(4, 50304)
    assert (plan.slice, plan.threads, plan.smem_bytes) == (3144, 800, 12576)
    assert plan.bounds()[:2] == [(0, 3144), (3144, 6288)]
    staged = softmax_plan(2, 1_000_000)
    assert (staged.slice, staged.threads, staged.smem_bytes) == (62500, 1024, 0)


@pytest.mark.parametrize("rows,n", [(0, 512), (4, 0), (-1, 5)])
def test_softmax_plan_refuses_empty(rows, n):
    with pytest.raises(ValueError, match="rows > 0 and n > 0"):
        softmax_plan(rows, n)


@pytest.mark.parametrize("max_cluster,want", [(8, (8, "shared")), (2, (2, "shared")),
                                              (1, (1, "shared"))])
def test_softmax_plan_capped_cluster(max_cluster, want):
    plan = softmax_plan(4, 50304, max_cluster=max_cluster)
    assert (plan.cluster, plan.path) == want
    _check_plan(plan, 4, 50304)
    # a row too wide for shared memory at the cap stages at the cap
    wide = softmax_plan(1, CAP_N // 2 + 1, max_cluster=8)
    assert (wide.cluster, wide.path) == (8, "staged")


def test_softmax_plan_many_sms_widens_few_rows():
    # more SMs than an H100's: still at most 16 CTAs a row
    assert softmax_plan(4, 50304, sms=1000).cluster == 16
    assert softmax_plan(4, 50304, sms=8).cluster == 2


def test_launch_plan_replans_unschedulable_clusters(monkeypatch):
    refused = {16}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(ops, "_schedulable",
                        lambda index, c, threads, smem: c not in refused)
    plan = ops.launch_plan(4, 50304, "cuda:0")
    assert (plan.cluster, plan.planned_cluster, plan.path) == (8, 16, "shared")
    _check_plan(plan, 4, 50304)
    refused.update({8, 4, 2, 1})
    with pytest.raises(RuntimeError, match="cannot schedule"):
        ops.launch_plan(4, 50304, "cuda:0")


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the kernel's wrapping adds)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _emulate(x: np.ndarray, depth: int, fmt, plan) -> torch.Tensor:
    """The kernel's arithmetic, slice by slice on ``plan``'s bounds: each
    slice's partial max and partial shifted sum, combined in rank order."""
    ifmt, d = afs.internal_fmt(fmt), afs.internal_depth(depth, fmt)
    xi = fxp.requantize(fxp.quantize(torch.from_numpy(x), fmt), fmt, ifmt)
    shift = afs.softmax_shift(x.shape[1], ifmt.frac)
    bounds = plan.bounds()
    m = torch.full((x.shape[0],), INT_MIN, dtype=torch.int32)
    for lo, hi in bounds:
        m = torch.maximum(m, torch.amax(xi[:, lo:hi], dim=1))
    e = cordic.cordic_exp(torch.clamp(xi - m[:, None], max=0), d, ifmt) >> shift
    s = torch.zeros((x.shape[0],), dtype=torch.int32)
    for lo, hi in bounds:
        s = _wrap32(s.to(torch.int64) + e[:, lo:hi].to(torch.int64).sum(dim=1))
    q = cordic.cordic_div(e, torch.clamp(s, min=1)[:, None], d, ifmt)
    return fxp.dequantize(fxp.requantize(q, ifmt, fmt), fmt)


def _rows(shape, seed):
    """N(0, 9) rows; with three rows or more, row 1 holds NaN and +-inf and
    the last row is constant."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3.0).astype(np.float32)
    if shape[0] >= 3:
        x[1, :3] = [np.nan, np.inf, -np.inf]
        x[-1] = 0.75
    return x


@pytest.mark.parametrize("name", sorted(FMTS))
@pytest.mark.parametrize("shape", [(4, 50304), (5, 300), (1, 1), (3, 4100)],
                         ids=["4x50304", "5x300", "1x1", "3x4100"])
def test_slice_emulation_bitwise_equal_to_pallas(shape, name):
    fmt, jfmt = FMTS[name]
    x = _rows(shape, seed=shape[1])
    depth = cordic.full_depth(fmt)
    plan = softmax_plan(*shape)
    want = np.asarray(multi_af_pallas(x, "softmax", depth=depth, fmt=jfmt))
    got = _emulate(x, depth, fmt, plan)
    np.testing.assert_array_equal(got.numpy(), want)
    # every other split gives the same bits, and so does the port's plain version
    for c in (1, 4):
        alt = softmax_plan(*shape, max_cluster=c)
        assert torch.equal(_emulate(x, depth, fmt, alt), got)
    assert torch.equal(af_softmax(torch.from_numpy(x), depth=depth, fmt=fmt), got)


def test_slice_emulation_special_rows():
    """NaN (quantized to 0) and +-inf (saturated) in rows split over 16
    CTAs; a constant row gives 1/n everywhere."""
    x = _rows((4, 50304), seed=7)
    x[0, 3144 * 5 + 17] = np.inf  # the max sits in rank 5's slice
    x[2, 3144 * 15:] = -np.inf  # rank 15's slice contributes only the floor
    plan = softmax_plan(*x.shape)
    assert plan.cluster == 16
    for fmt, jfmt in FMTS.values():
        depth = cordic.full_depth(fmt)
        want = np.asarray(multi_af_pallas(x, "softmax", depth=depth, fmt=jfmt))
        got = _emulate(x, depth, fmt, plan)
        np.testing.assert_array_equal(got.numpy(), want)
        const = got[-1]
        assert bool((const == const[0]).all()) and float(const[0]) < 1e-3
