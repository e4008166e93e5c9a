"""PyTorch port: the encoder-decoder family (``models/encdec.py``,
seamless-m4t-large-v2 reduced: 2 encoder and 2 decoder layers, H4/KV4,
layernorm, a ReLU MLP without GLU) against the reference, kernel mode,
prepared FxP8 weights, on the CPU.

The encoder pools its stub frames with AAD pooling (bitwise, see
``test_torch_pooling.py``) and runs non-causal self-attention (the flash
kernel's plain version without a mask under ``"flash"``); the decoder's
cross-attention is the plain non-causal chain. Forward and decode logits
agree within ``LOGIT_TOL`` (under ``"flash"`` up to FxP8 flips: the
reference's flash twin sums in another order than the kernel's plain
version); greedy streams are identical to the reference's
``BatchedServer``, whose decoder, like the port's, cross-attends to the zero
cross K/V of a fresh ``make_cache`` (its server never calls
``prefill_cross_kv``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import iter_dot_weights as jax_iter_dot_weights  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
import repro.runtime.calibrate as jax_calibrate  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import iter_dot_weights  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
import repro_torch.runtime.calibrate as calibrate  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from test_torch_mamba2 import (  # noqa: E402, F401
    LOGIT_TOL, assert_close_up_to_flips, build, one_torch_thread)

PROMPTS = (3, 6, 5, 2)
MAX_NEW, MAX_LEN = 8, 32
SEED_BASE = 40
FLIP_ATOL, MAX_FLIP_SHARE = 0.05, 0.1


@pytest.fixture(scope="module")
def arch():
    return build("seamless-m4t-large-v2")


def _ctxs(impl):
    return (JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                 attn_impl=impl),
            EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                          compute_dtype=torch.float32, attn_impl=impl))


def _batch(cfg, frames=32, seq=16, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32),
            "frontend_embeds": (rng.standard_normal((2, frames, cfg.d_model))
                                * 0.02).astype(np.float32)}


def test_encoder_matches_reference(arch):
    """The pooled (T / 2) encoder states, after the final layernorm, under
    ``"xla"`` (its non-causal self-attention the chunked chain; the forward
    test below runs it under ``"flash"``)."""
    jctx, ctx = _ctxs("xla")
    frames = _batch(arch["model"].cfg)["frontend_embeds"]
    want = ref_encdec.encode(arch["jprepared"], jnp.asarray(frames), arch["ref_model"].cfg, jctx)
    with torch.no_grad():
        got = encdec.encode(arch["prepared"], torch.from_numpy(frames), arch["model"].cfg, ctx)
    assert tuple(got.shape) == (2, 16, arch["model"].cfg.d_model)
    assert_close_up_to_flips(got.numpy(), want, flip_atol=FLIP_ATOL, max_flip_share=MAX_FLIP_SHARE)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_reference(arch, impl):
    """Frames and decoder tokens -> logits (B, S, V)."""
    jctx, ctx = _ctxs(impl)
    batch = _batch(arch["model"].cfg)
    want, want_aux = arch["ref_model"].forward(arch["jprepared"],
                                                jax.tree.map(jnp.asarray, batch), jctx)
    with torch.no_grad():
        got, aux = arch["model"].forward(arch["prepared"],
                                         {k: torch.from_numpy(v) for k, v in batch.items()}, ctx)
    assert tuple(got.shape) == (2, 16, arch["model"].cfg.vocab_size) and aux == want_aux == {}
    assert_close_up_to_flips(got.numpy(), want, flip_atol=FLIP_ATOL,
                             max_flip_share=MAX_FLIP_SHARE, argmax=True)


def test_forward_needs_frontend_embeds(arch):
    _, ctx = _ctxs("xla")
    with pytest.raises(KeyError, match="frontend_embeds"):
        arch["model"].forward(arch["prepared"], {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                              ctx)


def test_decode_step_matches_reference(arch):
    """Decode steps on a cache whose cross K/V holds projected encoder states
    (``prefill_cross_kv``, against the reference's) and whose rows sit at
    indices 0 and 3: logits and every cache leaf after two steps."""
    ref_model, model = arch["ref_model"], arch["model"]
    jctx, ctx = _ctxs("decode_kernel")
    frames = _batch(model.cfg)["frontend_embeds"]
    jenc = ref_encdec.encode(arch["jprepared"], jnp.asarray(frames), ref_model.cfg, jctx)
    with torch.no_grad():
        enc = encdec.encode(arch["prepared"], torch.from_numpy(frames), model.cfg, ctx)
        cross = encdec.prefill_cross_kv(arch["prepared"], enc, model.cfg, ctx)
    jcross = ref_encdec.prefill_cross_kv(arch["jprepared"], jenc, ref_model.cfg, jctx)
    for key in ("k", "v"):
        np.testing.assert_allclose(cross[key].numpy(), np.asarray(jcross[key]), **LOGIT_TOL)
    index = np.array([0, 3], np.int32)
    # 32 rows: the cross cache holds max_len / 2 = 16, the pooled 32 frames
    jcache = ref_model.make_cache(2, 32, dtype=jnp.float32)
    jcache["self"]["index"] = jnp.broadcast_to(jnp.asarray(index), jcache["self"]["index"].shape)
    jcache["cross"] = dict(jcross)
    cache = model.make_cache(2, 32, device="cpu")
    cache["self"]["index"].copy_(torch.from_numpy(index).expand_as(cache["self"]["index"]))
    cache["cross"]["k"].copy_(torch.from_numpy(np.array(jcross["k"])))
    cache["cross"]["v"].copy_(torch.from_numpy(np.array(jcross["v"])))
    rng = np.random.default_rng(1)
    for _ in range(2):
        tokens = rng.integers(0, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        want, jcache = ref_model.decode_step(arch["jprepared"], jnp.asarray(tokens), jcache, jctx)
        with torch.no_grad():
            got, cache = model.decode_step(arch["prepared"], torch.from_numpy(tokens), cache, ctx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    flat = dict(jax.tree_util.tree_flatten_with_path(cache)[0])
    jflat = dict(jax.tree_util.tree_flatten_with_path(jcache)[0])
    assert [jax.tree_util.keystr(k) for k in flat] == [jax.tree_util.keystr(k) for k in jflat]
    for (path, leaf), jleaf in zip(flat.items(), jflat.values()):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), **LOGIT_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _requests(cls, arch, temperature):
    rng = np.random.default_rng(1)
    return [cls(i, rng.integers(0, arch["model"].cfg.vocab_size, n).astype(np.int32), MAX_NEW,
                temperature=temperature, seed=SEED_BASE + i) for i, n in enumerate(PROMPTS)]


def _ref_streams(arch, temperature=0.0):
    if "jserver" not in arch:
        arch["jserver"] = JServer(arch["ref_model"], arch["jctx"], arch["jprepared"], slots=2,
                                  max_len=MAX_LEN, burst=4)
    return arch["jserver"].run(_requests(JRequest, arch, temperature))


@pytest.mark.parametrize("burst", [4, 1])
def test_greedy_streams_identical_to_reference(arch, burst):
    server = BatchedServer(arch["model"], arch["ctx"], arch["raw"], slots=2, max_len=MAX_LEN,
                           burst=burst, device="cpu")
    assert not server.batched_prefill  # the audio family prefills through the scan
    got = server.run(_requests(Request, arch, 0.0))
    assert got == _ref_streams(arch)
    assert any(len(set(v)) > 2 for v in got.values())
    assert server.prefill_steps == sum(PROMPTS)
    assert server.host_transfers == len(PROMPTS) + server.decode_steps // burst
    assert not server._row["cross"]["k"].any() and not server.cache["cross"]["k"].any()


def test_cache_and_dot_weights_match_reference(arch):
    """``make_cache``'s tree and shapes (cross K/V over max_len / 2 encoder
    rows), and ``iter_dot_weights``' leaves, names (``enc.attn.q``,
    ``dec.self.q``, ``dec.cross.k``, ...) and stacked axes."""
    cache = arch["model"].make_cache(3, 10, device="cpu")
    jcache = arch["ref_model"].make_cache(3, 10, dtype=jnp.float32)
    shapes = {jax.tree_util.keystr(k): tuple(v.shape)
              for k, v in jax.tree_util.tree_flatten_with_path(cache)[0]}
    assert shapes == {jax.tree_util.keystr(k): v.shape
                      for k, v in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert cache["cross"]["k"].shape[2] == 5
    specs, ref_specs = arch["model"].specs(), arch["ref_model"].specs()

    def entries(it):
        return sorted((tuple(keys), name, stacked, in_axes)
                      for keys, name, _, stacked, in_axes in it)

    for jtree, tree in ((arch["jraw"], arch["raw"]), (arch["jprepared"], arch["prepared"])):
        want = entries(jax_iter_dot_weights(jtree, specs=ref_specs))
        assert entries(iter_dot_weights(tree, specs=specs)) == want
    names = {name: stacked for _, name, stacked, _ in want}
    assert names["enc.attn.q"] == names["dec.cross.k"] == names["dec.mlp.up"] == 1
    assert names["lm_head"] == 0


def test_calibration_scan_raises_as_the_reference_does(arch):
    """The scan's forwards carry tokens only, and the audio forward needs
    ``frontend_embeds``: ``KeyError`` in both packages (as internvl2's)."""
    tokens = np.zeros((2, 8), np.int32)
    with pytest.raises(KeyError):
        jax_calibrate.calibration_scan(arch["ref_model"], arch["jraw"], tokens, mode="kernel")
    with pytest.raises(KeyError):
        calibrate.calibration_scan(arch["model"], arch["raw"], tokens, mode="kernel")
