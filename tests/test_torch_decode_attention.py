"""PyTorch port: GQA cache-decode attention against the reference.

The port's plain version mirrors the reference's XLA cache chain op for op,
but the two frameworks do not pin the f32 reduction order of the einsums and
the softmax sum, so outputs agree to a couple of ulps (rtol = atol = 2e-6 on
unit-scale inputs, the bar the reference holds its own Pallas-vs-XLA pair
to). The Hopper kernel is held against the plain version on the card in
``test_torch_kernels_gpu.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import gqa_decode_attention as jax_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    gqa_decode_attention,
    gqa_decode_attention_ref,
)
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

ULPS = dict(rtol=2e-6, atol=2e-6)


def _xla_chain(q, ck, cv, pos, scale):
    """The reference's models/blocks.attention cache branch."""
    g = q.shape[2] // ck.shape[2]
    valid = jnp.arange(ck.shape[1])[None, None, :] <= pos[:, :, None]
    ckr = jnp.repeat(ck, g, axis=2) if g > 1 else ck
    cvr = jnp.repeat(cv, g, axis=2) if g > 1 else cv
    scores = jnp.einsum("bqhd,bshd->bhqs", q, ckr)
    scores = jnp.where(valid[:, None], scores * scale, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqs,bshd->bqhd", probs.astype(cvr.dtype), cvr)


def _case(b, s, h, kv, hd, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    ck = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    start = rng.integers(0, t - s + 1, (b, 1))
    pos = (start + np.arange(s)[None]).astype(np.int32)
    return q, ck, cv, pos


@pytest.mark.parametrize("s", [1, 4], ids=["s1", "s4"])
@pytest.mark.parametrize("groups", [1, 2], ids=["g1", "g2"])
def test_plain_version_matches_reference(s, groups):
    b, kv, hd, t = 2, 2, 16, 24
    h = kv * groups
    q, ck, cv, pos = _case(b, s, h, kv, hd, t, seed=10 * s + groups)
    scale = 1.0 / math.sqrt(hd)
    got = gqa_decode_attention(*(torch.from_numpy(a) for a in (q, ck, cv, pos)),
                               scale=scale).numpy()
    assert got.shape == (b, s, h, hd) and got.dtype == np.float32
    jargs = [jnp.asarray(a) for a in (q, ck, cv, pos)]
    np.testing.assert_allclose(got, np.asarray(_xla_chain(*jargs, scale)), **ULPS)
    np.testing.assert_allclose(got, np.asarray(jax_kernel(*jargs, scale=scale,
                                                          interpret=True)), **ULPS)


def test_positions_past_cache_and_fully_masked_rows():
    """A drained slot's position runs past the cache (every key visible); a
    negative position masks every key (uniform softmax) — both as the chain."""
    q, ck, cv, pos = _case(2, 2, 4, 2, 16, 12, seed=5)
    pos = np.array([[40, 41], [-3, 0]], np.int32)
    got = gqa_decode_attention_ref(*(torch.from_numpy(a) for a in (q, ck, cv, pos)),
                                   scale=0.25).numpy()
    want = _xla_chain(*(jnp.asarray(a) for a in (q, ck, cv, pos)), 0.25)
    np.testing.assert_allclose(got, np.asarray(want), **ULPS)
