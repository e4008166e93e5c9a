"""PyTorch port: absorbed-MLA cache decode against the reference.

* The plain ``mla_decode_attention`` against the reference's Pallas
  ``mla_decode`` (interpret mode): the two frameworks do not pin the f32
  reduction order of the score einsums and the softmax sum, so outputs agree
  within 2e-5 on unit-scale inputs (the tolerance the Hopper kernel is held
  to against the plain version).
* ``mla_attention``'s cache path, one layer of reduced deepseek-v3, against
  ``repro.models.mla.mla_attention`` on the same prepared kernel-mode
  weights: outputs within f32 reduction-order tolerance, cache rows within
  f32 ulps, the write index equal.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.kernels.decode_attention import mla_decode_attention as jax_kernel  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TOLERANCE,
    mla_decode_attention,
    mla_decode_attention_ref,
)
from repro_torch.kernels.decode_attention.ops import mla_splits  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

OUT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-6, atol=1e-6)


def _case(b, s, h, r, rd, t, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, r), (b, s, h, rd), (b, t, r), (b, t, rd))]
    start = rng.integers(0, t - s + 1, (b, 1))
    pos = (start + np.arange(s)[None]).astype(np.int32)
    return arrays, pos


@pytest.mark.parametrize("b,s,h,r,rd,t", [(1, 1, 4, 16, 8, 24), (3, 1, 4, 16, 8, 24),
                                          (2, 5, 4, 16, 8, 24), (2, 3, 8, 64, 16, 40)],
                         ids=["b1s1", "b3s1", "b2s5", "b2s3_wide"])
def test_plain_version_within_tolerance_of_pallas(b, s, h, r, rd, t):
    (ql, qr, ck, kr), pos = _case(b, s, h, r, rd, t, seed=b * 100 + s)
    scale = 1.0 / math.sqrt(r + rd)
    want = np.asarray(jax_kernel(*(jnp.asarray(a) for a in (ql, qr, ck, kr, pos)), scale=scale))
    got = mla_decode_attention(*(torch.from_numpy(a) for a in (ql, qr, ck, kr, pos)),
                               scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, r)
    assert np.abs(got.numpy() - want).max() <= TOLERANCE
    ref = mla_decode_attention_ref(*(torch.from_numpy(a) for a in (ql, qr, ck, kr, pos)),
                                   scale=scale)
    assert torch.equal(got, ref)  # a CPU tensor runs the plain version


def test_masked_rows_and_drained_slots():
    """A query whose index ran past the cache sees every key; pos < 0 gives
    the uniform softmax over all keys, as in the reference."""
    (ql, qr, ck, kr), pos = _case(2, 2, 4, 16, 8, 12, seed=5)
    pos = np.array([[40, 41], [-1, 3]], np.int32)
    want = np.asarray(jax_kernel(*(jnp.asarray(a) for a in (ql, qr, ck, kr, pos)), scale=0.2))
    got = mla_decode_attention(*(torch.from_numpy(a) for a in (ql, qr, ck, kr, pos)), scale=0.2)
    assert np.abs(got.numpy() - want).max() <= TOLERANCE


@pytest.fixture(scope="module")
def layer():
    """One reduced deepseek-v3 MLA layer, N(0, 0.1^2) weights, prepared in
    kernel mode by both packages."""
    jcfg = ref_reduced(ref_get_config("deepseek-v3-671b"), layers=4)
    cfg = reduced(get_config("deepseek-v3-671b"), layers=4)
    rng = np.random.default_rng(0)
    specs = mla.mla_specs(cfg)
    np_params = {k: (rng.standard_normal(s.shape) * (1.0 if s.init == "ones" else 0.1)
                     ).astype(np.float32) for k, s in specs.items()}
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    jparams = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, "kernel",
                          specs=jax_mla.mla_specs(jcfg))
    tparams = prepare_params(load_numpy_params(np_params, "cpu", specs=specs),
                             PrecisionPolicy.accurate(), "kernel", specs=specs)
    return jcfg, cfg, jctx, jparams, tparams


@pytest.mark.parametrize("attn_impl", ["decode_kernel", "xla"])
@pytest.mark.parametrize("s", [1, 6], ids=["decode", "block"])
def test_mla_attention_cache_path_matches_reference(layer, s, attn_impl):
    jcfg, cfg, jctx, jparams, tparams = layer
    b, t = 2, 16
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    index = np.array([0, 5], np.int32)
    positions = index[:, None] + np.arange(s, dtype=np.int32)[None]

    jcache = jax_mla.init_mla_cache(jcfg, b, t, jnp.float32)
    jcache["index"] = jnp.asarray(index)
    want, jnew = jax_mla.mla_attention(jparams, jnp.asarray(x), jcfg, jctx,
                                       positions=jnp.asarray(positions), name="layer.attn",
                                       cache=jcache)

    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl=attn_impl)
    cache = mla.init_mla_cache(cfg, b, t)
    cache["index"].copy_(torch.from_numpy(index))
    with torch.no_grad():
        got, new = mla.mla_attention(tparams, torch.from_numpy(x), cfg, ctx,
                                     positions=torch.from_numpy(positions),
                                     name="layer.attn", cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jnew[key]), **CACHE_TOL)
        assert new[key] is cache[key]  # written in place
    np.testing.assert_array_equal(new["index"].numpy(), np.asarray(jnew["index"]))


def test_cache_free_path_matches_reference(layer):
    """The cache-free path (``forward``'s) runs: without a cache, under
    ``"xla"`` and ``"flash"``, the output matches the reference's cache-free
    path on the same layer and no cache comes back."""
    jcfg, cfg, _, jparams, tparams = layer
    s = 6
    x = np.random.default_rng(7).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    for attn_impl in ("xla", "flash"):
        jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                    attn_impl=attn_impl)
        want, jnew = jax_mla.mla_attention(jparams, jnp.asarray(x), jcfg, jctx,
                                           positions=jnp.arange(s), name="layer.attn")
        ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                            compute_dtype=torch.float32, attn_impl=attn_impl)
        with torch.no_grad():
            got, new = mla.mla_attention(tparams, torch.from_numpy(x), cfg, ctx,
                                         positions=torch.arange(s, dtype=torch.int32),
                                         name="layer.attn")
        assert new is None and jnew is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_key_splits_fill_the_card_only_when_blocks_are_few():
    """One block an SM (224 KB of shared memory at full width): the splits aim
    at the H100's 132 SMs."""
    assert mla_splits(4, 1, 128, 512) == 8  # decode: 16 (query, 32-head) blocks, 2 tiles each
    assert mla_splits(1, 1, 128, 40) == 2  # never more splits than key tiles
    assert mla_splits(1, 512, 128, 512) == 1  # a prefill bucket fills the card
    assert mla_splits(1, 16, 128, 512) == 3  # bucket 16: 64 blocks
    assert mla_splits(1, 64, 128, 512) == 1  # bucket 64: 256 blocks
    assert mla_splits(2, 3, 4, 33) == 2
