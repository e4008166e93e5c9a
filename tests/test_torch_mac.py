"""PyTorch port: ``core/mac.py`` (the bit-faithful CORDIC dot and matmul, the
fast error model, the cycle model) against ``repro.core.mac``.

The bit-faithful forms are integer shift-add recurrences and agree bitwise.
The fast model is one f32 matmul: at FxP8 every product and partial sum is
exact in f32, so it agrees bitwise; at FxP16 the two libraries round their
f32 sums in different orders, so it agrees to f32 accumulation over K (the
reference's own kernel-vs-model tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fxp as jfxp  # noqa: E402
from repro.core import mac as jmac  # noqa: E402
from repro_torch.core import cordic, fxp, mac  # noqa: E402
from repro_torch.kernels.cordic_mac import cordic_mac  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

FMTS = {
    "fxp8": (fxp.FXP8, fxp.FXP8_UNIT, jfxp.FXP8, jfxp.FXP8_UNIT),
    "fxp16": (fxp.FXP16, fxp.FXP16_UNIT, jfxp.FXP16, jfxp.FXP16_UNIT),
}


def _raw(shape, fmt, jf, seed, spread=0.95):
    x = np.random.default_rng(seed).uniform(-spread, spread, shape).astype(np.float32)
    return np.array(jfxp.quantize(jnp.asarray(x), jf)), x


@pytest.mark.parametrize("depth", [2, 5, 7])
@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_dot_bitwise(name, depth):
    fmt, unit, jf, ju = FMTS[name]
    xq, _ = _raw((16, 64), fmt, jf, seed=depth)
    wq, _ = _raw((16, 64), unit, ju, seed=depth + 1)
    want = np.asarray(jmac.cordic_dot(jnp.asarray(xq), jnp.asarray(wq), depth, ju))
    got = mac.cordic_dot(torch.from_numpy(xq), torch.from_numpy(wq), depth, unit)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_matmul_bitwise(name):
    fmt, unit, jf, ju = FMTS[name]
    xq, _ = _raw((4, 32), fmt, jf, seed=1)
    wq, _ = _raw((32, 8), unit, ju, seed=2)
    want = np.asarray(jmac.cordic_matmul(jnp.asarray(xq), jnp.asarray(wq), 5, ju))
    got = mac.cordic_matmul(torch.from_numpy(xq), torch.from_numpy(wq), 5, unit)
    np.testing.assert_array_equal(got.numpy(), want)
    # the matmul is the per-column dot, accumulator chained
    for j in range(8):
        col = torch.from_numpy(wq[:, j]).expand(4, 32)
        assert torch.equal(got[:, j], mac.cordic_dot(torch.from_numpy(xq), col, 5, unit))


@pytest.mark.parametrize("depth", [4, 7])
@pytest.mark.parametrize("name", sorted(FMTS))
def test_carmen_matmul_fast_matches_reference(name, depth):
    fmt, unit, jf, ju = FMTS[name]
    rng = np.random.default_rng(depth)
    x = rng.uniform(-1, 1, (8, 64)).astype(np.float32)
    w = rng.uniform(-1, 1, (64, 16)).astype(np.float32)
    want = np.asarray(jmac.carmen_matmul_fast(jnp.asarray(x), jnp.asarray(w), depth, jf, ju))
    got = mac.carmen_matmul_fast(torch.from_numpy(x), torch.from_numpy(w), depth, fmt,
                                 unit).numpy()
    if name == "fxp8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=64 * 2.0**-22)
    # the MAC-array kernel's plain version is the same arithmetic, exact
    kern = cordic_mac(torch.from_numpy(x), torch.from_numpy(w), depth=depth, x_fmt=fmt,
                      w_fmt=unit).numpy()
    if name == "fxp8":
        np.testing.assert_array_equal(kern, got)
    else:
        np.testing.assert_allclose(kern, got, rtol=0, atol=64 * 2.0**-22)


def test_fast_model_within_shift_truncation_of_bit_faithful():
    """The error model deviates from the bit-faithful simulation only by
    shift truncation: |dev| <= K * depth * LSB(x), as in the reference."""
    fmt, unit = fxp.FXP8, fxp.FXP8_UNIT
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (64, 16)).astype(np.float32))
    bit = fxp.dequantize(mac.cordic_matmul(fxp.quantize(x, fmt), fxp.quantize(w, unit), 7,
                                           unit), fmt)
    fast = mac.carmen_matmul_fast(x, w, 7, fmt, unit)
    assert (bit - fast).abs().max().item() <= 64 * 7 * fmt.scale


def test_mac_cycles_equal_reference():
    for k, depth in [(64, 7), (64, 10), (64, 15), (2048, 13)]:
        assert mac.mac_cycles(k, depth) == jmac.mac_cycles(k, depth)
    assert 1 - mac.mac_cycles(64, 10) / mac.mac_cycles(64, 15) == pytest.approx(0.3125)
    assert cordic.full_depth(fxp.FXP8_UNIT) == 7
