"""PyTorch port: the threefry sampler (``repro_torch.serve.threefry`` and the
engine's ``_sample_slots``) against ``jax.random``, on the CPU.

The JAX side runs under ``jax.threefry_partitionable(True)``, the layout of
``random_bits`` that the port implements (JAX's default since 0.5). Keys,
``fold_in``, the random bits and the uniforms are integers, or floats made
by bit manipulation, and must be bitwise equal. The Gumbel noise is
``-log(-log u)`` in f32: each library's ``log`` rounds its own way (1 ulp
apart, measured on this CPU), and the inner log's rounding reaches the noise
as an absolute error of about one f32 ulp of 1, so the noise is held to 4
ulp of itself plus 2^-22. A sampled token may therefore differ from the
reference's only where the reference's two largest perturbed logits are
within ``NEAR_TIE`` of each other; such cases are counted and printed, and
greedy lanes must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.extend.random as jex_random  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve.engine import _sample_slots as ref_sample_slots  # noqa: E402
from repro.serve.engine import sample as ref_sample  # noqa: E402
from repro.serve.engine import top2_margin as ref_top2_margin  # noqa: E402
from repro_torch.serve import sample, threefry, top2_margin  # noqa: E402
from repro_torch.serve.engine import _sample_slots  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

SEEDS = (0, 1, 40, 12345, 2**31 - 1, -1)
SHAPES = ((5,), (4, 7), (4, 50304))
TINY = float(np.finfo(np.float32).tiny)
NEAR_TIE = 1e-5  # perturbed-logit gap under which a sampled token may differ


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module", autouse=True)
def warm_cpu_log():
    """One ``torch.log`` over all threads before any comparison: on this
    torch CPU build the first call in a process returns part of its output
    up to 4e-5 off (one thread's chunk, in 2 of 16 processes measured)."""
    torch.log(torch.rand(4, 50304))


def _np(x):
    """A JAX result as numpy, once its computation has finished."""
    return np.asarray(jax.block_until_ready(x))


def _key(seed):
    return _np(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32_bitwise_equal_to_jax(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = _np(jex_random.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    k = torch.from_numpy(key.astype(np.int64))
    c = torch.from_numpy(count.astype(np.int64))
    y1, y2 = threefry.threefry2x32(k[0], k[1], c[:32], c[32:])
    np.testing.assert_array_equal(torch.cat([y1, y2]).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise_equal_to_jax(seed):
    np.testing.assert_array_equal(threefry.prng_key(seed).numpy(), _key(seed))
    data = np.array([0, 1, 7, 31, 1000, 2**31 - 1], np.int32)
    want = np.stack([_np(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), d))) for d in data]).astype(np.int64)
    keys = threefry.prng_key(seed).expand(len(data), 2)
    got = threefry.fold_in(keys, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_bitwise_equal_to_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    np.testing.assert_array_equal(threefry.random_bits(tkey, shape).numpy(),
                                  _np(jax.random.bits(key, shape)).astype(np.int64))
    for lo in (0.0, TINY):
        want = _np(jax.random.uniform(key, shape, minval=lo))
        got = threefry.uniform(tkey, shape, minval=lo).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gumbel_within_stated_tolerance_of_jax(seed):
    shape = (4, 50304)
    key = jax.random.PRNGKey(seed)
    want = _np(jax.random.gumbel(key, shape))
    got = threefry.gumbel(threefry.prng_key(seed), shape).numpy()
    bound = 4 * np.spacing(np.abs(want)) + 2.0**-22
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    assert (got != want).any()  # the two libraries' logs do differ


def _perturbed_gap(last, keys, counts, temps):
    """The reference's two largest perturbed logits' gap, per row."""
    k = jax.vmap(jax.random.fold_in)(jnp.asarray(keys.astype(np.uint32)), jnp.asarray(counts))
    scaled = jnp.asarray(last) / jnp.maximum(jnp.asarray(temps), 1e-6)[:, None]
    g = jax.vmap(lambda kk: jax.random.gumbel(kk, (last.shape[-1],)))(
        jax.random.wrap_key_data(k))
    top2 = _np(jax.lax.top_k(scaled + g, 2)[0])
    return top2[:, 0] - top2[:, 1]


@pytest.mark.parametrize("vocab", [64, 50304])
def test_sample_slots_matches_jax_except_near_ties(vocab):
    rng = np.random.default_rng(vocab)
    temps = np.array([0.0, 0.7, 1.3, 2.0], np.float32)
    near_ties, lanes = 0, 0
    for trial in range(8 if vocab < 1000 else 4):
        last = (rng.standard_normal((4, vocab)) * 3).astype(np.float32)
        keys = np.stack([_key(s) for s in rng.integers(0, 2**31, 4)])
        counts = rng.integers(0, 64, 4).astype(np.int32)
        want = _np(ref_sample_slots(jnp.asarray(last), jnp.asarray(keys.astype(np.uint32)),
                                           jnp.asarray(counts), jnp.asarray(temps)))
        got = _sample_slots(torch.from_numpy(last), torch.from_numpy(keys),
                            torch.from_numpy(counts), torch.from_numpy(temps)).numpy()
        assert got.dtype == np.int32 and got.shape == (4, 1)
        np.testing.assert_array_equal(got[temps <= 0], want[temps <= 0])  # greedy: identical
        gaps = _perturbed_gap(last, keys, counts, temps)
        for row in np.nonzero(got[:, 0] != want[:, 0])[0]:
            assert gaps[row] < NEAR_TIE, (trial, row, gaps[row])
            near_ties += 1
        lanes += 4
    print(f"V={vocab}: {near_ties} of {lanes} lanes differ, each at a near-tie")
    assert near_ties <= 1


def test_sample_and_top2_margin_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 1, 300)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for temp in (0.0, 0.8):
        want = _np(ref_sample(jnp.asarray(logits), key, temperature=temp))
        got = sample(torch.from_numpy(logits), threefry.prng_key(9), temperature=temp).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(top2_margin(torch.from_numpy(logits)).numpy(),
                                  _np(ref_top2_margin(jnp.asarray(logits))))
