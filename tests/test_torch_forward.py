"""PyTorch port: the cache-free ``forward`` against the reference, kernel mode,
on the CPU.

Reduced olmo-1b (2 layers, d_model 128) and reduced deepseek-v3 (2 layers:
one dense-prefix layer and one MoE layer, MLA attention), over raw
weights (every dot re-rounds its weight: the per-call path the calibration
scan runs) and prepared weights, under ``attn_impl="xla"`` (the reference's
query-chunked chains) and ``"flash"`` (the reference's flash lowering, the
port's flash kernels, whose plain versions run on CPU tensors). Both
packages get the same numpy weights, layer matrices N(0, 0.1^2) as in
``test_torch_serving.py``. Logits agree to f32 reduction-order tolerance
(``LOGIT_TOL``) with the argmax identical at every position; the MoE
load-balancing loss within 1e-6.

Past ``Q_CHUNK`` the chains run their query blocks; that is held at the
attention functions, not the whole model, to keep the test fast.
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
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.models import mla as jax_mla, params as jax_params  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mla_flash import mla_flash_attention  # noqa: E402
from repro_torch.models import blocks, get_model, mla  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LB_TOL = 1e-6
ARCHS = {"olmo-1b": 2, "deepseek-v3-671b": 2}  # arch -> reduced layers
TOKENS = (2, 16)


def numpy_params(tree, seed=0):
    """Layer matrices N(0, 0.1^2), the embedding N(0, 0.02^2), from numpy."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        scale = 0.02 if path[0].key == "embed" else 0.1
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, tree)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    name = request.param
    ref_model = ref_get_model(ref_reduced(ref_get_config(name), layers=ARCHS[name]))
    np_params = numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config(name), layers=ARCHS[name]))
    tokens = np.random.default_rng(3).integers(0, 256, TOKENS).astype(np.int32)
    return dict(name=name, ref_model=ref_model, np_params=np_params, model=model,
                tokens=tokens, ref={})


def _reference(arch, weights, impl):
    """The reference's forward, computed once per (weights, attn_impl)."""
    key = (weights, impl)
    if key not in arch["ref"]:
        ref_model = arch["ref_model"]
        jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                    attn_impl=impl)
        params = jax.tree.map(jnp.asarray, arch["np_params"])
        if weights == "prepared":
            params = jax_prepare(params, jctx.policy, "kernel", specs=ref_model.specs())
        logits, aux = ref_model.forward(params, {"tokens": jnp.asarray(arch["tokens"])}, jctx)
        arch["ref"][key] = (np.asarray(logits), float(aux["lb_loss"]))
    return arch["ref"][key]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("weights", ["raw", "prepared"])
def test_forward_matches_reference(arch, weights, impl):
    want, want_lb = _reference(arch, weights, impl)
    model = arch["model"]
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl=impl)
    params = model.load_numpy(arch["np_params"], "cpu")
    if weights == "prepared":
        params = prepare_params(params, ctx.policy, "kernel", specs=model.specs())
    with torch.no_grad():
        got, aux = model.forward(params, {"tokens": torch.from_numpy(arch["tokens"])}, ctx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert abs(float(aux["lb_loss"]) - want_lb) <= LB_TOL
    if model.cfg.moe is not None:
        assert float(aux["lb_loss"]) > 0.5  # one MoE layer: near 1
    else:
        assert float(aux["lb_loss"]) == 0.0


def test_vision_forward_takes_frontend_embeds():
    """internvl2's stub frontend: ``frontend_embeds`` (B, P, D) are prepended,
    the logits cover P + S rows; without them the forward raises KeyError,
    as the reference's does (its parity is in test_torch_archs.py)."""
    model = get_model(reduced(get_config("internvl2-2b")))
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 5), dtype=torch.int64)
    embeds = torch.randn((2, cfg.frontend_tokens, cfg.d_model), generator=torch.Generator()
                         .manual_seed(1)) * 0.02
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32)
    with torch.no_grad():
        logits, aux = model.forward(params, {"tokens": tokens, "frontend_embeds": embeds}, ctx)
        assert tuple(logits.shape) == (2, cfg.frontend_tokens + 5, cfg.vocab_size)
        assert torch.isfinite(logits).all() and float(aux["lb_loss"]) == 0.0
        with pytest.raises(KeyError, match="frontend_embeds"):
            model.forward(params, {"tokens": tokens}, ctx)


def test_gqa_chains_past_q_chunk():
    """S = 2 * Q_CHUNK: the chunked chain runs two query blocks; it, the flash
    kernel's plain version (K/V unrepeated) and the reference's chain and
    flash twin agree."""
    assert blocks.Q_CHUNK == jax_blocks.Q_CHUNK
    rng = np.random.default_rng(11)
    b, s, h, kv, hd = 1, 2 * blocks.Q_CHUNK, 2, 1, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    kr, vr = np.repeat(k, h // kv, 2), np.repeat(v, h // kv, 2)
    pos = np.arange(s, dtype=np.int32)
    want = np.asarray(jax_blocks._sdpa_chunked(*(jnp.asarray(a) for a in (q, kr, vr, pos, pos)),
                                               causal=True))
    got = blocks._sdpa_chunked(*(torch.from_numpy(a) for a in (q, kr, vr, pos, pos)),
                               causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    flash = flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(flash, want, atol=3e-5, rtol=1e-4)
    twin = np.asarray(jax_blocks._sdpa_flash_xla(*(jnp.asarray(a) for a in (q, kr, vr, pos, pos)),
                                                 causal=True))
    np.testing.assert_allclose(flash, twin, atol=3e-5, rtol=1e-4)


def test_mla_chunk_scan_past_q_chunk():
    """S = 2 * Q_CHUNK through ``mla_attention`` without a cache: the query
    chunk scan (``"xla"``) and the flash kernel's plain version against the
    reference's chunk scan, on one reduced deepseek-v3 MLA layer with the
    same prepared kernel-mode weights."""
    name = "deepseek-v3-671b"
    jcfg = ref_reduced(ref_get_config(name))
    cfg = reduced(get_config(name))
    specs = jax_mla.mla_specs(jcfg)
    np_p = numpy_params(jax.tree.map(np.asarray, jax_params.init(specs, jax.random.PRNGKey(1))))
    s = 2 * blocks.Q_CHUNK
    x = (np.random.default_rng(12).standard_normal((1, s, cfg.d_model)) * 0.5).astype(np.float32)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32)
    jp = jax_prepare(jax.tree.map(jnp.asarray, np_p), jctx.policy, "kernel", specs=specs)
    want, _ = jax_mla.mla_attention(jp, jnp.asarray(x), jcfg, jctx, positions=jnp.arange(s),
                                    name="layer.attn")
    tp = prepare_params(load_numpy_params(np_p, "cpu", specs=mla.mla_specs(cfg)),
                        PrecisionPolicy.accurate(), "kernel", specs=mla.mla_specs(cfg))
    for impl in ("xla", "flash"):
        ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                            compute_dtype=torch.float32, attn_impl=impl)
        with torch.no_grad():
            got, new_cache = mla.mla_attention(tp, torch.from_numpy(x), cfg, ctx,
                                               positions=torch.arange(s, dtype=torch.int32),
                                               name="layer.attn")
        assert new_cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_mla_flash_plain_version_is_the_chunked_chain():
    """The two cache-free MLA lowerings of the port on the same inputs:
    the flash plain version and one unchunked block."""
    rng = np.random.default_rng(13)
    b, s, h, r, rd = 2, 37, 3, 16, 8
    ql, qr = (torch.from_numpy(rng.standard_normal((b, s, h, n)).astype(np.float32))
              for n in (r, rd))
    ck, kr = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
              for n in (r, rd))
    scale = 1.0 / math.sqrt(r + rd)
    got = mla_flash_attention(ql, qr, ck, kr, scale=scale)
    want = mla._chunked_block(ql, qr, ck, kr, torch.arange(s, dtype=torch.int32), scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-4)
