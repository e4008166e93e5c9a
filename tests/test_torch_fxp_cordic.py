"""PyTorch port: fixed-point formats and CORDIC, bitwise against the reference.

Inputs are drawn with numpy from a seed and go through both packages; raw
int32 outputs must be equal bit for bit over FXP8/FXP16 and every depth from
2 to full.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cordic as jc  # noqa: E402
from repro.core import fxp as jf  # noqa: E402
from repro_torch.core import cordic as tc  # noqa: E402
from repro_torch.core import fxp as tf  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

FMTS = {"fxp8": (jf.FXP8, tf.FXP8), "fxp16": (jf.FXP16, tf.FXP16)}
UNITS = {"fxp8": (jf.FXP8_UNIT, tf.FXP8_UNIT), "fxp16": (jf.FXP16_UNIT, tf.FXP16_UNIT)}


def _same(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


def _depths(fmt):
    return range(2, fmt.frac + 2)


def test_cast_helper_matches_jax_saturating_cast():
    v = np.array([3e9, -3e9, np.inf, -np.inf, np.nan, 1.5, -1.5, 2.5, -2.7, 2147483520.0,
                  -2147483648.0, 0.0], np.float32)
    _same(tf.to_int32(torch.from_numpy(v)), jnp.asarray(v).astype(jnp.int32))
    # the plain torch cast gets these wrong, which is why the helper exists
    assert int(torch.tensor([3e9]).to(torch.int32)) != 2147483647


@pytest.mark.parametrize("name", sorted(FMTS))
@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_quantize_dequantize(name, rounding):
    jfmt, tfmt = FMTS[name]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, 1e9, -1e9, 0.5 * jfmt.scale]
    q_ref = jf.quantize(x, jfmt, rounding=rounding)
    q = tf.quantize(torch.from_numpy(x), tfmt, rounding=rounding)
    _same(q, q_ref)
    _same(tf.dequantize(q, tfmt), jf.dequantize(q_ref, jfmt))


@pytest.mark.parametrize("src,dst", [("fxp8", "fxp16"), ("fxp16", "fxp8")])
def test_requantize(src, dst):
    rng = np.random.default_rng(1)
    jsrc, tsrc = FMTS[src]
    jdst, tdst = FMTS[dst]
    raw = rng.integers(jsrc.qmin, jsrc.qmax + 1, 4096).astype(np.int32)
    _same(tf.requantize(torch.from_numpy(raw), tsrc, tdst), jf.requantize(raw, jsrc, jdst))
    _same(tf.saturate(torch.from_numpy(raw * 7), tdst), jf.saturate(raw * 7, jdst))


@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_mul(name):
    jfmt, tfmt = FMTS[name]
    rng = np.random.default_rng(2)
    x = rng.integers(jfmt.qmin, jfmt.qmax + 1, 2048).astype(np.int32)
    w = rng.integers(-(2 * jfmt.one - 1), 2 * jfmt.one, 2048).astype(np.int32)
    for d in _depths(jfmt):
        _same(tc.cordic_mul(torch.from_numpy(x), torch.from_numpy(w), d, tfmt),
              jc.cordic_mul(x, w, d, jfmt))


@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_div(name):
    jfmt, tfmt = FMTS[name]
    rng = np.random.default_rng(3)
    den = rng.integers(jfmt.one // 2, 4 * jfmt.one, 2048).astype(np.int32)
    num = (rng.uniform(-1, 1, 2048) * den).astype(np.int32)
    for d in _depths(jfmt):
        _same(tc.cordic_div(torch.from_numpy(num), torch.from_numpy(den), d, tfmt),
              jc.cordic_div(num, den, d, jfmt))


@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_exp_including_negative_arguments(name):
    jfmt, tfmt = FMTS[name]
    rng = np.random.default_rng(4)
    x = rng.integers(-12 * jfmt.one, 2 * jfmt.one, 2048).astype(np.int32)
    x[:4] = [0, -1, -12 * jfmt.one, 2 * jfmt.one - 1]
    assert (x < 0).sum() > 1000
    for d in _depths(jfmt):
        _same(tc.cordic_exp(torch.from_numpy(x), d, tfmt), jc.cordic_exp(x, d, jfmt))


@pytest.mark.parametrize("name", sorted(FMTS))
def test_hyperbolic_rotate(name):
    jfmt, tfmt = FMTS[name]
    rng = np.random.default_rng(5)
    z = rng.integers(-int(1.5 * jfmt.one), int(1.5 * jfmt.one), 2048).astype(np.int32)
    for d in _depths(jfmt):
        c, s = tc.hyperbolic_rotate(torch.from_numpy(z), d, tfmt)
        c_ref, s_ref = jc.hyperbolic_rotate(z, d, jfmt)
        _same(c, c_ref)
        _same(s, s_ref)
        assert tc.hyperbolic_sequence(d) == jc.hyperbolic_sequence(d)


@pytest.mark.parametrize("name", sorted(UNITS))
def test_signed_digit_round_and_integers(name):
    jfmt, tfmt = UNITS[name]
    rng = np.random.default_rng(6)
    w = (rng.standard_normal(4096) * 0.6).astype(np.float32)
    w[:3] = [np.nan, 5.0, -5.0]
    for d in _depths(jfmt):
        grid = np.asarray(jc.signed_digit_round(w, d, jfmt))
        _same(tc.signed_digit_round(torch.from_numpy(w), d, tfmt), grid)
        ints = tc.signed_digit_ints(torch.from_numpy(w), d, tfmt)
        np.testing.assert_array_equal(ints.numpy(), np.round(grid * 2.0**jfmt.frac))


def test_depth_helpers():
    for (jfmt, tfmt) in FMTS.values():
        assert tc.full_depth(tfmt) == jc.full_depth(jfmt)
        assert tc.approx_depth(tfmt) == jc.approx_depth(jfmt)
