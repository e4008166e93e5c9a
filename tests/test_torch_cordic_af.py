"""PyTorch port: the standalone multi-AF block (``kernels/cordic_af``) against
the reference's ``multi_af_pallas`` (Pallas in interpret mode on the CPU).

Fixed-point paths agree bitwise: every elementwise AF, FxP8 and FxP16, at
depths 2, 4 and full, over 1-D, 3-D and ragged shapes, with out-of-range and
non-finite inputs. The Hopper kernel is held against the plain version on
the card in ``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EngineContext as JCtx  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.fxp import FXP8 as J8, FXP16 as J16  # noqa: E402
from repro.kernels.cordic_af.ops import multi_af_pallas  # noqa: E402
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy, cordic  # noqa: E402
from repro_torch.kernels.cordic_af import ELEMENTWISE_AFS, multi_af, multi_af_ref  # noqa: E402

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
    x = torch.zeros((2, 8))
    with pytest.raises(NotImplementedError, match="af_softmax"):
        multi_af(x, "softmax", depth=7, fmt=FXP8)
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


def test_engine_activate_other_modes_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        EngineContext(mode="carmen").activate(torch.zeros(4), "swish")
