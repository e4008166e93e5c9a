"""PyTorch port: the standalone multi-AF block (``kernels/cordic_af``) against
the reference's ``multi_af_pallas`` (Pallas in interpret mode on the CPU).

Fixed-point paths agree bitwise: every elementwise AF, FxP8 and FxP16, at
depths 2, 4 and full, over 1-D, 3-D and ragged shapes, with out-of-range and
non-finite inputs; and the row softmax (``cordic_softmax``), raw and through
the float block, including rows wide enough for the accumulator pre-shift.
The Hopper kernels are held against the plain versions on the card in
``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EngineContext as JCtx  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core import activations as jafs  # noqa: E402
from repro.core.fxp import FXP8 as J8, FXP16 as J16  # noqa: E402
from repro.core.fxp import FxPFormat as JFormat  # noqa: E402
from repro.kernels.cordic_af.ops import multi_af_pallas  # noqa: E402
from repro_torch.core import FXP8, FXP16, EngineContext, FxPFormat, PrecisionPolicy  # noqa: E402
from repro_torch.core import activations as afs, cordic  # noqa: E402
from repro_torch.kernels.cordic_af import (  # noqa: E402
    ELEMENTWISE_AFS,
    af_index,
    af_softmax,
    af_softmax_ref,
    multi_af,
    multi_af_ref,
)
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

FMTS = {"fxp8": (FXP8, J8), "fxp16": (FXP16, J16)}


def _inputs(shape, seed, spread=1.9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-spread, spread, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:5] = [np.nan, np.inf, -np.inf, 300.0, -300.0]
    return x


def _depth(kind, fmt):
    return cordic.full_depth(fmt) if kind == "full" else int(kind)


@pytest.mark.parametrize("depth_kind", ["2", "4", "full"])
@pytest.mark.parametrize("name", sorted(FMTS))
@pytest.mark.parametrize("mode", ELEMENTWISE_AFS)
def test_multi_af_bitwise_equal_to_pallas(mode, name, depth_kind):
    fmt, jfmt = FMTS[name]
    depth = _depth(depth_kind, fmt)
    x = _inputs((64, 128), seed=depth)
    want = np.asarray(multi_af_pallas(x, mode, depth=depth, fmt=jfmt))
    got = multi_af(torch.from_numpy(x), mode, depth=depth, fmt=fmt)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1000,), (2, 10, 64), (3, 1000), (100, 300), (7, 5, 3)],
                         ids=["1d", "3d", "ragged_3x1000", "ragged_100x300", "3d_tiny"])
def test_multi_af_shapes_bitwise(shape):
    x = _inputs(shape, seed=len(shape))
    want = np.asarray(multi_af_pallas(x, "gelu", depth=7, fmt=J8))
    got = multi_af(torch.from_numpy(x), "gelu", depth=7, fmt=FXP8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mode_by_index_and_name_agree():
    x = torch.from_numpy(_inputs((8, 128), seed=3, spread=1.5))
    outs = {}
    for i, mode in enumerate(ELEMENTWISE_AFS):
        outs[mode] = multi_af(x, i, depth=7, fmt=FXP8)
        assert torch.equal(outs[mode], multi_af(x, mode, depth=7, fmt=FXP8))
        assert torch.equal(outs[mode], multi_af_ref(x, mode, depth=7, fmt=FXP8))
    assert not torch.equal(outs["relu"], outs["tanh"])


def test_softmax_and_unknown_modes_raise():
    """Softmax has no elementwise index: it must be named, as in the
    reference's ``af_index``; unknown names and indices raise."""
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="softmax routes to the reduction kernel"):
        af_index("softmax")
    assert af_index("swish") == ELEMENTWISE_AFS.index("swish")
    with pytest.raises(ValueError, match="rows"):
        af_softmax(torch.zeros(8), depth=7, fmt=FXP8)
    with pytest.raises(ValueError, match="mode"):
        multi_af(x, "mish", depth=7, fmt=FXP8)
    with pytest.raises(ValueError, match="out of range"):
        multi_af(x, len(ELEMENTWISE_AFS), depth=7, fmt=FXP8)


@pytest.mark.parametrize("name", sorted(FMTS))
@pytest.mark.parametrize("af", ["swish", "gelu", "identity"])
def test_engine_activate_kernel_mode_matches_reference(name, af):
    fmt, jfmt = FMTS[name]
    x = _inputs((2, 4, 3, 96), seed=11)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(jfmt), compute_dtype=jnp.float32)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(fmt),
                        compute_dtype=torch.float32)
    want = np.asarray(jctx.activate(jnp.asarray(x), af))
    xt = torch.from_numpy(x)
    got = ctx.activate(xt, af)
    np.testing.assert_array_equal(got.numpy(), want)
    if af == "identity":
        assert got is xt


@pytest.mark.parametrize("mode", ["exact", "carmen", "int8"])
def test_engine_activate_other_modes_not_yet_ported(mode):
    """The other modes are ported: ``exact`` runs the float reference,
    ``carmen`` and ``int8`` the multi-AF block's float wrapper, as in the
    reference (its FxP8 fixed point bitwise, its float reference to f32
    ulps)."""
    x = _inputs((2, 4, 3, 96), seed=12)
    jctx = JCtx(mode=mode, policy=JPolicy.accurate(J8), compute_dtype=jnp.float32)
    ctx = EngineContext(mode=mode, policy=PrecisionPolicy.accurate(FXP8),
                        compute_dtype=torch.float32)
    want = np.asarray(jctx.activate(jnp.asarray(x), "swish"))
    got = ctx.activate(torch.from_numpy(x), "swish").numpy()
    if mode == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# softmax, the seventh AF
# ---------------------------------------------------------------------------

RAW_FMTS = {"fxp8": (FXP8, J8), "fxp16": (FXP16, J16),
            "q7.16": (FxPFormat(24, 16), JFormat(24, 16))}  # FxP16's internal format


def _softmax_raw_cases():
    for name, (fmt, _) in sorted(RAW_FMTS.items()):
        for depth in range(2, cordic.full_depth(fmt) + 1, 1 if name == "fxp8" else 3):
            yield name, depth


@pytest.mark.parametrize("name,depth", list(_softmax_raw_cases()))
def test_cordic_softmax_raw_bitwise(name, depth):
    fmt, jfmt = RAW_FMTS[name]
    rng = np.random.default_rng(depth)
    x = rng.integers(fmt.qmin, fmt.qmax, (6, 40), endpoint=True).astype(np.int32)
    x[0] = fmt.qmax  # a flat row
    x[1, :3] = [fmt.qmin, fmt.qmax, 0]
    want = np.asarray(jafs.cordic_softmax(jnp.asarray(x), depth, jfmt))
    got = afs.cordic_softmax(torch.from_numpy(x), depth, fmt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    routed = afs.multi_af(torch.from_numpy(x), "softmax", depth, fmt)
    np.testing.assert_array_equal(routed.numpy(), want)


def test_cordic_softmax_pre_shift_on_a_wide_row():
    """A 20000-lane row at FxP16's internal Q7.16 format needs the pre-shift
    (ceil(log2 20000) + 16 + 1 - 31 = 1); the lm_head row at FxP16 needs 2."""
    fmt, jfmt = RAW_FMTS["q7.16"]
    assert afs.softmax_shift(20000, fmt.frac) == 1
    assert afs.softmax_shift(50304, fmt.frac) == 2
    assert afs.softmax_shift(50304, afs.internal_fmt(FXP8).frac) == 0
    rng = np.random.default_rng(20000)
    x = (rng.standard_normal((2, 20000)) * 0.3 * fmt.one).astype(np.int32)
    for depth in (9, 17):
        want = np.asarray(jafs.cordic_softmax(jnp.asarray(x), depth, jfmt))
        got = afs.cordic_softmax(torch.from_numpy(x), depth, fmt)
        np.testing.assert_array_equal(got.numpy(), want)
        assert bool((got >= 0).all()) and bool((got > 0).any())


@pytest.mark.parametrize("shape", [(16, 128), (5, 300), (2, 3, 40), (1, 20000)],
                         ids=["row_block_8", "no_row_block", "3d", "pre_shift"])
@pytest.mark.parametrize("name", sorted(FMTS))
def test_multi_af_softmax_bitwise_equal_to_pallas(shape, name):
    fmt, jfmt = FMTS[name]
    x = _inputs(shape, seed=shape[-1], spread=6.0)
    depth = cordic.full_depth(fmt)
    want = np.asarray(multi_af_pallas(x, "softmax", depth=depth, fmt=jfmt))
    got = multi_af(torch.from_numpy(x), "softmax", depth=depth, fmt=fmt)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    rows = torch.from_numpy(x).reshape(-1, shape[-1])
    assert torch.equal(af_softmax(rows, depth=depth, fmt=fmt), got.reshape(rows.shape))
    assert torch.equal(af_softmax_ref(rows, depth=depth, fmt=fmt), got.reshape(rows.shape))


@pytest.mark.parametrize("name", sorted(FMTS))
def test_engine_activate_softmax_matches_reference(name):
    fmt, jfmt = FMTS[name]
    x = _inputs((2, 3, 64), seed=13, spread=4.0)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(jfmt), compute_dtype=jnp.float32)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(fmt),
                        compute_dtype=torch.float32)
    want = np.asarray(jctx.activate(jnp.asarray(x), "softmax"))
    got = ctx.activate(torch.from_numpy(x), "softmax")
    np.testing.assert_array_equal(got.numpy(), want)
