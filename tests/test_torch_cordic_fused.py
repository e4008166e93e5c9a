"""PyTorch port: the fused CORDIC dot+AF, bitwise against the reference.

On the CPU the port's ``fused_dot_af`` runs its plain version, which must be
bitwise equal to JAX's ``fused_dot_af_ref`` over FXP8/FXP16 x the 7 AF modes x
``compute_round`` x {approximate, full} depth, on ragged shapes, past the
reference's ``FUSE_MAX_K``, through an int32 overflow, and against the
interpret-mode Pallas kernel. The Hopper kernel is held against the plain
version on the card in ``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cordic as jc  # noqa: E402
from repro.core import fxp as jf  # noqa: E402
from repro.kernels.cordic_fused import fused_dot_af as jax_fused  # noqa: E402
from repro.kernels.cordic_fused import fused_dot_af_ref as jax_ref  # noqa: E402
from repro.kernels.cordic_fused import make_point as jax_point  # noqa: E402
from repro_torch.core import fxp as tf  # noqa: E402
from repro_torch.core.backends.kernel import make_point  # noqa: E402
from repro_torch.kernels.cordic_fused import FUSED_AFS, fused_dot_af, plan  # noqa: E402
from repro_torch.kernels.int_dot import (  # noqa: E402
    IMAD, NARROW, WGMMA, is_k_major, padded_k, to_k_major)
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

FMTS = {"fxp8": (jf.FXP8, tf.FXP8), "fxp16": (jf.FXP16, tf.FXP16)}
UNITS = {"fxp8": (jf.FXP8_UNIT, tf.FXP8_UNIT), "fxp16": (jf.FXP16_UNIT, tf.FXP16_UNIT)}


def _operands(m, k, n, seed, x_scale=2.0, w_scale=0.4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * x_scale).astype(np.float32)
    w = (rng.standard_normal((k, n)) * w_scale).astype(np.float32)
    return x, w


def _prepared(w, depth, name):
    """(JAX f32 grid, port integers) of one signed-digit weight bank."""
    jw, tw = UNITS[name]
    grid = np.asarray(jc.signed_digit_round(w, depth, jw))
    ints = np.round(grid * 2.0**jw.frac).astype(np.int8 if jw.bits <= 8 else np.int16)
    return grid, torch.from_numpy(ints)


def _both(x, grid, ints, depth, name, af, af_depth, compute_round):
    jfmt, tfmt = FMTS[name]
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(grid),
                              jax_point(depth, jfmt, UNITS[name][0]),
                              af_mode=af, af_depth=af_depth, af_fmt=jfmt,
                              compute_round=compute_round))
    got = fused_dot_af(torch.from_numpy(x), ints, make_point(depth, tfmt, UNITS[name][1]),
                       af_mode=af, af_depth=af_depth, af_fmt=tfmt,
                       compute_round=compute_round).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(FMTS))
@pytest.mark.parametrize("depth_kind", ["approximate", "full"])
@pytest.mark.parametrize("compute_round", [False, True], ids=["f32", "bf16round"])
def test_plain_version_matches_reference_bitwise(name, depth_kind, compute_round):
    jfmt, _ = FMTS[name]
    full = jfmt.frac + 1
    depth = full if depth_kind == "full" else jc.approx_depth(jfmt)
    x, w = _operands(5, 37, 19, seed=2 * sorted(FMTS).index(name) + (depth_kind == "full"))
    grid, ints = _prepared(w, depth, name)
    for af in FUSED_AFS:
        got, want = _both(x, grid, ints, depth, name, af, depth, compute_round)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=af)


@pytest.mark.parametrize("m,k,n", [(1, 7, 3), (9, 130, 257), (3, 4100, 33)],
                         ids=["tiny", "ragged", "k_past_fuse_max"])
def test_ragged_and_long_contractions(m, k, n):
    x, w = _operands(m, k, n, seed=m * k)
    grid, ints = _prepared(w, 7, "fxp8")
    for af in ("identity", "swish", "gelu"):
        got, want = _both(x, grid, ints, 7, "fxp8", af, 7, False)
        np.testing.assert_array_equal(got, want, err_msg=af)


def test_fxp16_int32_overflow_wraps_like_reference():
    m, k, n = 2, 64, 8
    x = np.full((m, k), 7.99, np.float32)
    w = np.full((k, n), 1.9999, np.float32)
    grid, ints = _prepared(w, 15, "fxp16")
    exact = int(np.round(7.99 * 4096)) * int(ints[0, 0]) * k
    assert exact > 2**31  # the int32 accumulator really wraps
    got, want = _both(x, grid, ints, 15, "fxp16", "identity", 13, False)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] < 0


def test_plain_version_matches_interpret_mode_pallas_kernel():
    x, w = _operands(6, 40, 24, seed=11)
    grid, ints = _prepared(w, 7, "fxp8")
    point_j = jax_point(7, jf.FXP8, jf.FXP8_UNIT)
    point_t = make_point(7, tf.FXP8, tf.FXP8_UNIT)
    for af in ("identity", "swish", "selu"):
        want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(grid), point_j, af_mode=af,
                                    af_depth=7, af_fmt=jf.FXP8, interpret=True))
        got = fused_dot_af(torch.from_numpy(x), ints, point_t, af_mode=af, af_depth=7,
                           af_fmt=tf.FXP8).numpy()
        np.testing.assert_array_equal(got, want, err_msg=af)


def test_leading_axes_and_nan_inputs():
    x, w = _operands(6, 16, 5, seed=3)
    x[0, :3] = [np.nan, np.inf, -np.inf]
    grid, ints = _prepared(w, 7, "fxp8")
    got, want = _both(x.reshape(2, 3, 16), grid, ints, 7, "fxp8", "swish", 7, False)
    assert got.shape == (2, 3, 5)
    np.testing.assert_array_equal(got, want)


def test_plan_covers_k_without_empty_splits():
    for m, n, k in [(4, 2048, 2048), (4, 2048, 8192), (4, 50304, 2048), (16, 2048, 2048),
                    (512, 8192, 2048), (3, 33, 4100), (1, 1, 1), (40, 130, 4100),
                    (64, 576, 7168), (1024, 2048, 2048)]:
        for elem in (1, 2):
            p = plan(m, n, k, elem, elem)
            per = p.k_per_split
            assert p.splits >= 1 and per >= 1
            assert (p.splits - 1) * per < k <= p.splits * per


@pytest.mark.parametrize("m,n,k,elems,want", [
    # M <= 16, int8: the narrow loop; m-tiles of 8 rows; K split to fill the card
    (4, 2048, 2048, (1, 1), (NARROW, 1, 8, 256)),
    (4, 8192, 2048, (1, 1), (NARROW, 1, 4, 512)),
    (16, 2048, 8192, (1, 1), (NARROW, 2, 16, 512)),
    (16, 50304, 2048, (1, 1), (NARROW, 2, 1, 2048)),
    (4, 129280, 7168, (1, 1), (NARROW, 1, 4, 1792)),  # at most 2048 of K a block
    (4, 7168, 18432, (1, 1), (NARROW, 1, 9, 2048)),
    # M > 16, int8: the wgmma loop over all of K; 128 x 256 tiles where
    # 128 x 128 ones take one to four waves
    (32, 8192, 2048, (1, 1), (WGMMA, 128, 1, 2048)),
    (1024, 2048, 2048, (1, 1), (WGMMA, 128, 1, 2048)),
    (512, 2048, 2048, (1, 1), (WGMMA, 128, 1, 2048)),
    (64, 2048, 2048, (1, 1), (WGMMA, 128, 1, 2048)),
    (33, 77, 1000, (1, 1), (WGMMA, 128, 1, 1000)),
    (1024, 8192, 2048, (1, 1), (WGMMA, 256, 1, 2048)),
    (300, 8200, 1000, (1, 1), (WGMMA, 256, 1, 1000)),
    (512, 7168, 16384, (1, 1), (WGMMA, 256, 1, 16384)),
    (512, 129280, 7168, (1, 1), (WGMMA, 128, 1, 7168)),
    (1024, 50304, 2048, (1, 1), (WGMMA, 128, 1, 2048)),
    # any int16 operand: the CUDA-core loop at every M
    (4, 2048, 8192, (2, 2), (IMAD, 0, 16, 512)),
    (512, 2048, 2048, (2, 2), (IMAD, 2, 5, 416)),
    (40, 130, 4100, (1, 2), (IMAD, 2, 129, 32)),
])
def test_plan_picks_path_tiles_and_splits(m, n, k, elems, want):
    p = plan(m, n, k, *elems)
    assert (p.path, p.config, p.splits, p.k_per_split) == want
    if p.path == WGMMA:
        assert (p.bm, p.bn) == (128, p.config)


def test_k_major_helpers_pad_and_check():
    w = torch.arange(300 * 5, dtype=torch.int8).reshape(300, 5)
    bank = to_k_major(w)
    assert torch.equal(bank, w) and bank.stride() == (1, 304) and is_k_major(bank)
    assert not is_k_major(w) and not is_k_major(bank[1:])
    assert padded_k(300, 1) == 304 and padded_k(300, 2) == 304 and padded_k(1000, 2) == 1000
