"""PyTorch port: the MAC-array matmul (``kernels/cordic_mac``) and the
per-call kernel-backend dot against the reference's ``cordic_mac`` (Pallas in
interpret mode on the CPU).

Everything here is integer arithmetic followed by exact power-of-two scales,
so the two packages agree bitwise at FxP8 and FxP16, int32 overflow
included. The Hopper kernel is held against the plain version on the card
in ``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core import cordic as jcordic  # noqa: E402
from repro.core import fxp as jfxp  # noqa: E402
from repro.kernels.cordic_mac import ops as jmac  # noqa: E402
from repro.kernels.cordic_mac.ref import mac_matmul_ref as jmac_ref  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy, cordic, fxp  # noqa: E402
from repro_torch.core.backends import get_backend  # noqa: E402
from repro_torch.kernels.cordic_mac import (  # noqa: E402
    cordic_mac,
    mac_matmul,
    mac_matmul_ref,
    quantize_activations,
    quantize_weights,
)
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

FMTS = {
    "fxp8": (fxp.FXP8, fxp.FXP8_UNIT, jfxp.FXP8, jfxp.FXP8_UNIT),
    "fxp16": (fxp.FXP16, fxp.FXP16_UNIT, jfxp.FXP16, jfxp.FXP16_UNIT),
}
MAC_SHAPES = [(8, 16, 8), (48, 200, 72), (128, 256, 128), (33, 127, 65), (1, 512, 1)]


def _xw(m, k, n, seed, spread=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-spread, spread, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    return x, w


def _port(x, w, **kw):
    return cordic_mac(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()


@pytest.mark.parametrize("m,k,n", MAC_SHAPES)
@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_mac_bitwise_equal_to_pallas(m, k, n, name):
    x_fmt, w_fmt, jx, jw = FMTS[name]
    depth = cordic.full_depth(w_fmt)
    x, w = _xw(m, k, n, seed=m + k + n)
    want = np.asarray(jmac.cordic_mac(x, w, depth=depth, x_fmt=jx, w_fmt=jw))
    got = _port(x, w, depth=depth, x_fmt=x_fmt, w_fmt=w_fmt)
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth_kind", ["full", "approx", "minimal"])
@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_mac_depth_sweep(name, depth_kind):
    x_fmt, w_fmt, jx, jw = FMTS[name]
    depth = {"full": cordic.full_depth(w_fmt), "approx": cordic.approx_depth(w_fmt),
             "minimal": 2}[depth_kind]
    x, w = _xw(32, 64, 32, seed=depth, spread=3.0)  # saturates part of x
    want = np.asarray(jmac.cordic_mac(x, w, depth=depth, x_fmt=jx, w_fmt=jw))
    np.testing.assert_array_equal(_port(x, w, depth=depth, x_fmt=x_fmt, w_fmt=w_fmt), want)


def test_cordic_mac_fused_relu():
    x, w = _xw(16, 32, 16, seed=5)
    want = np.asarray(jmac.cordic_mac(x, w, depth=7, fuse_relu=True))
    got = _port(x, w, depth=7, fuse_relu=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.maximum(_port(x, w, depth=7), 0.0))
    assert (got == 0).any() and (got > 0).any()


@pytest.mark.parametrize("name", sorted(FMTS))
def test_cordic_mac_w_prequantized(name):
    x_fmt, w_fmt, jx, jw = FMTS[name]
    x, w = _xw(12, 40, 24, seed=9)
    sd = np.array(jcordic.signed_digit_round(jnp.asarray(w), 5, jw))
    want = np.asarray(jmac.cordic_mac(x, sd, depth=5, x_fmt=jx, w_fmt=jw, w_prequantized=True))
    got = _port(x, sd, depth=5, x_fmt=x_fmt, w_fmt=w_fmt, w_prequantized=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port(x, w, depth=5, x_fmt=x_fmt, w_fmt=w_fmt))


@pytest.mark.parametrize("name", sorted(FMTS))
def test_weight_and_activation_banks_match_reference(name):
    x_fmt, w_fmt, jx, jw = FMTS[name]
    rng = np.random.default_rng(3)
    w = rng.uniform(-1.99, 1.99, (64, 48)).astype(np.float32)
    x = rng.uniform(-9, 9, (7, 64)).astype(np.float32)
    depth = cordic.full_depth(w_fmt)
    jw_q, jws = jmac.quantize_weights(jnp.asarray(w), depth, jw)
    w_q, ws = quantize_weights(torch.from_numpy(w).T.contiguous().T, depth, w_fmt)
    assert w_q.dtype == (torch.int8 if name == "fxp8" else torch.int16)
    assert w_q.stride() == (1, 64) and ws == float(jws)  # K-major: columns of K contiguous
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    jx_q, jxs = jmac.quantize_activations(jnp.asarray(x), jx)
    x_q, xs = quantize_activations(torch.from_numpy(x), x_fmt)
    assert x_q.dtype == w_q.dtype and xs == float(jxs)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))


def test_plain_version_wraps_int32_like_the_reference():
    """int16 operands at K = 8192 overflow the int32 accumulator; both wrap."""
    rng = np.random.default_rng(4)
    x_q = rng.integers(20000, 32767, (3, 8192)).astype(np.int16)
    w_q = rng.integers(-32768, 32767, (8192, 5)).astype(np.int16)
    w_q[:, 0] = 32767
    x_scale = np.full((3, 1), 2.0**-12, np.float32)
    w_scale = np.full((1, 5), 2.0**-14, np.float32)
    want = np.asarray(jmac_ref(x_q, w_q, x_scale, w_scale))
    got = mac_matmul_ref(*map(torch.from_numpy, (x_q, w_q, x_scale, w_scale))).numpy()
    np.testing.assert_array_equal(got, want)
    exact = x_q.astype(np.int64) @ w_q.astype(np.int64)
    assert (np.abs(exact) > 2**31).any()  # the case really overflows


def test_mac_matmul_cpu_runs_plain_version_and_checks_shapes():
    x_q = torch.randint(-128, 127, (4, 30), dtype=torch.int8)
    w_q = torch.randint(-128, 127, (30, 9), dtype=torch.int8)
    xs, ws = torch.full((4, 1), 2.0**-6), torch.full((1, 9), 2.0**-6)
    before = mac_matmul.launches
    out = mac_matmul(x_q, w_q, xs, ws, fuse_relu=True)
    assert mac_matmul.launches == before  # a CPU tensor never launches
    assert torch.equal(out, mac_matmul_ref(x_q, w_q, xs, ws, fuse_relu=True))
    with pytest.raises(ValueError, match="shapes"):
        mac_matmul(x_q, w_q[:20], xs, ws)


@pytest.mark.parametrize("name", sorted(FMTS))
def test_per_call_engine_dot_matches_reference(name):
    """``EngineContext.dot`` on a raw weight: the reference's per-call
    ``cordic_mac`` path, leading dims kept."""
    x_fmt, _, jx, _ = FMTS[name]
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 2, (2, 3, 64)).astype(np.float32)
    w = rng.uniform(-1, 1, (64, 40)).astype(np.float32)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(jx), compute_dtype=jnp.float32)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(x_fmt),
                        compute_dtype=torch.float32)
    want = np.asarray(jctx.dot(jnp.asarray(x), jnp.asarray(w), name="layer.mlp.up"))
    got = ctx.dot(torch.from_numpy(x), torch.from_numpy(w), name="layer.mlp.up")
    assert tuple(got.shape) == (2, 3, 40)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(FMTS))
def test_per_call_dot_equals_prepared_dot(name):
    """Per call and prepared are the same arithmetic: bitwise equal at every
    depth, as the reference's ``test_prepared_kernel_dot_bit_identical``."""
    x_fmt, w_fmt, *_ = FMTS[name]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-2, 2, (4, 96)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (96, 33)).astype(np.float32))
    for depth in range(2, cordic.full_depth(w_fmt) + 1):
        pol = PrecisionPolicy.uniform(x_fmt, depth)
        ctx = EngineContext(mode="kernel", policy=pol, compute_dtype=torch.float32)
        prepared = get_backend("kernel").prepare(w, pol.for_layer("n"))
        assert torch.equal(ctx.dot(x, w, name="n"), ctx.dot(x, prepared, name="n")), depth


@pytest.mark.parametrize("name", sorted(FMTS))
@pytest.mark.parametrize("k", [64, 40, 300])
def test_banks_are_k_major_with_16_byte_columns(name, k):
    """The per-call weight bank is K-major (one int8/int16 copy of the
    rounded weight), its column stride padded to whole 16 bytes; the
    activation bank's rows are 16-byte aligned too. Values are unchanged."""
    x_fmt, w_fmt, *_ = FMTS[name]
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.uniform(-1.5, 1.5, (k, 24)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-3, 3, (5, k)).astype(np.float32))
    elem = w_fmt.storage_dtype.itemsize
    k_pad = -(-k * elem // 16) * 16 // elem
    w_q, _ = quantize_weights(w, 5, w_fmt)
    assert w_q.shape == (k, 24) and w_q.stride() == (1, k_pad)
    assert torch.equal(w_q, cordic.signed_digit_ints(w, 5, w_fmt).to(w_fmt.storage_dtype))
    x_q, _ = quantize_activations(x, x_fmt)
    assert x_q.shape == (5, k) and x_q.stride() == (k_pad, 1)
    assert torch.equal(x_q, fxp.quantize(x, x_fmt).to(x_fmt.storage_dtype))
