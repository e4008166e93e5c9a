"""PyTorch port: the multi-AF block, raw int32 bitwise against the reference on
both guard-bit internal formats (Q3.12 for FxP8 I/O, Q7.16 for FxP16 I/O)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import activations as ja  # noqa: E402
from repro.core import fxp as jf  # noqa: E402
from repro_torch.core import activations as ta  # noqa: E402
from repro_torch.core import fxp as tf  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

IO = {"fxp8": (jf.FXP8, tf.FXP8), "fxp16": (jf.FXP16, tf.FXP16)}
AFS = ("relu", "gelu", "tanh", "sigmoid", "swish", "selu")


def _inputs(jfmt, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.linspace(jfmt.min_value, jfmt.max_value, 1024),
                        rng.standard_normal(1024) * 1.5]).astype(np.float32)
    return x


@pytest.mark.parametrize("io", sorted(IO))
@pytest.mark.parametrize("af", AFS)
def test_multi_af_raw_bitwise(io, af):
    jfmt, tfmt = IO[io]
    jifmt, tifmt = ja.internal_fmt(jfmt), ta.internal_fmt(tfmt)
    assert (jifmt.bits, jifmt.frac) == (tifmt.bits, tifmt.frac)
    x = _inputs(jfmt, AFS.index(af))
    raw = np.array(jf.requantize(jf.quantize(x, jfmt), jfmt, jifmt))
    for depth in (jfmt.frac + 1, max(2, (2 * (jfmt.frac + 1)) // 3)):
        d = ta.internal_depth(depth, tfmt)
        want = np.asarray(ja.multi_af(raw, af, d, jifmt))
        got = ta.multi_af(torch.from_numpy(raw), af, d, tifmt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("io", sorted(IO))
def test_multi_af_float_bitwise(io):
    jfmt, tfmt = IO[io]
    x = _inputs(jfmt, 7)
    for af in AFS:
        want = np.asarray(ja.multi_af_float(x, af, jfmt.frac + 1, jfmt))
        got = ta.multi_af_float(torch.from_numpy(x), af, tfmt.frac + 1, tfmt).numpy()
        np.testing.assert_array_equal(got, want)


def test_af_constants_match_reference_quantization():
    for jfmt, tfmt in IO.values():
        ifmt = ta.internal_fmt(tfmt)
        jifmt = ja.internal_fmt(jfmt)
        c = ta.af_constants(ifmt)
        assert c["gelu_cubic"] == int(jf.quantize(np.float32(0.044715), jifmt))
        assert c["selu_alpha"] == int(jf.quantize(np.float32(ja._SELU_ALPHA), jifmt))


def test_float_references_close():
    x = np.linspace(-4, 4, 257).astype(np.float32)
    for af in AFS:
        np.testing.assert_allclose(ta.af_ref(torch.from_numpy(x), af).numpy(),
                                   np.asarray(ja.af_ref(x, af)), rtol=1e-6, atol=1e-6)
