"""PyTorch port: the AAD pooling unit (``core/pooling.py``) against the
reference's ``repro.core.pooling``, bitwise.

The selection ``dev <= aad + 1e-12`` sits on an f32 boundary: at a window of
2 the two deviations are equal in exact arithmetic, and one ulp between them
keeps one element and drops the other. So the port must round exactly as
XLA does, on random frames (several magnitudes) and on frames with equal
neighbours (windows whose elements tie, or tie in part).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pooling import aad_pool as ref_aad_pool  # noqa: E402
from repro.core.pooling import aad_pool_1d as ref_aad_pool_1d  # noqa: E402
from repro_torch.core.pooling import aad_pool, aad_pool_1d  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402, F401


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _frames(shape, scale, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-3, 37.0])
@pytest.mark.parametrize("window,stride", [(2, None), (3, None), (4, 2), (5, 3)])
def test_aad_pool_1d_bitwise(window, stride, scale):
    """(B, T, C) frames, T odd (a ragged tail is dropped), and a leading
    batch of two axes."""
    for shape in ((3, 51, 16), (2, 2, 20, 8)):
        x = _frames(shape, scale, seed=window * 10 + (stride or 0))
        got = aad_pool_1d(torch.from_numpy(x), window, stride)
        _bitwise(got, ref_aad_pool_1d(jnp.asarray(x), window, stride))


@pytest.mark.parametrize("window", [2, 3, 4])
def test_aad_pool_1d_ties_bitwise(window):
    """Windows of equal elements (deviation 0 = aad: all kept), equal
    neighbours straddling windows, and two of three elements equal."""
    x = _frames((2, 48, 12), 3.0, seed=window)
    x[:, 0:window] = x[:, 0:1]            # one whole window tied
    x[:, 7:9] = x[:, 7:8]                  # neighbours across a window edge at window 2/4
    x[:, 12:14] = x[:, 12:13]
    x[:, 20:24] = np.float32(0.1)          # a constant run
    x[0, 30:33] = x[0, 30:31]
    x[1, :, 5] = np.float32(2.5)           # a constant channel
    got = aad_pool_1d(torch.from_numpy(x), window)
    _bitwise(got, ref_aad_pool_1d(jnp.asarray(x), window))


@pytest.mark.parametrize("window,stride", [(2, None), (3, None), (3, 2), (2, 1)])
def test_aad_pool_2d_bitwise(window, stride):
    """NHWC maps, ragged H and W, with a tied 2 x 2 block and a constant row."""
    x = _frames((2, 9, 11, 5), 2.0, seed=window + (stride or 0))
    x[:, 2:4, 2:4] = x[:, 2:3, 2:3]
    x[1, 5, :, :] = np.float32(-0.75)
    got = aad_pool(torch.from_numpy(x), window, stride)
    _bitwise(got, ref_aad_pool(jnp.asarray(x), window, stride))


def test_aad_pool_1d_excludes_the_outlier():
    """The unit's point: an outlier in a window is dropped from its mean."""
    x = torch.tensor([[[1.0], [1.2], [0.8], [100.0]]])
    out = aad_pool_1d(x, 4)
    assert torch.allclose(out, torch.tensor([[[1.0]]]))
