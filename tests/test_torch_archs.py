"""PyTorch port: the transformer archs registered beside olmo-1b and
deepseek-v3 against the reference, kernel mode, prepared weights,
``attn_impl="decode_kernel"``, on the CPU: qwen2.5-14b (QKV bias), qwen3-8b
(qk-norm), yi-9b, internvl2-2b (the vision-stub VLM) and llama4-maverick
(interleaved dense/MoE pairs).

The reference's ``reduced()`` maps every arch to 4 heads and 4 kv heads, one
head group; the variants here keep each arch's own group count at head_dim
32 (qwen2.5 and llama4 H10/KV2, qwen3 H8/KV2, yi H8/KV1, internvl2 H4/KV2),
the same ``dataclasses.replace`` on both sides. internvl2 runs at an odd
vocabulary of 253, so the sampler's threefry bits and the argmax see a row
that is no multiple of anything. llama4 (one pair) runs the same tests in
``test_torch_llama4.py``.

Both packages get the same numpy weights (``numpy_params``). Decode-step
and forward logits agree to f32 reduction-order tolerance (``LOGIT_TOL``)
with the argmax identical; greedy and sampled streams are identical to the
reference's ``BatchedServer`` at burst 8.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LB_TOL = 1e-6
# arch -> (heads, kv heads) of its reduced variant, and the stock head groups
ARCHS = {
    "qwen2.5-14b": ((10, 2), 5),
    "qwen3-8b": ((8, 2), 4),
    "yi-9b": ((8, 1), 8),
    "internvl2-2b": ((4, 2), 2),
    "llama4-maverick-400b-a17b": ((10, 2), 5),
}
HEAD_DIM = 32
ODD_VOCAB = 253
PROMPTS = (3, 4, 4, 3)  # one prefill bucket (4)
MAX_NEW = 8
MAX_LEN = 32
TEMPERATURE, SEED_BASE = 1.3, 40


def variant(cfg, reduce):
    """``reduce(cfg)`` with the arch's own head groups (internvl2: vocab 253)."""
    (heads, kv), _ = ARCHS[cfg.name]
    updates = dict(num_heads=heads, num_kv_heads=kv, head_dim=HEAD_DIM)
    if cfg.frontend == "vision":
        updates["vocab_size"] = ODD_VOCAB
    return dataclasses.replace(reduce(cfg), **updates)


def numpy_params(tree, seed=0):
    """Layer matrices and biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)
    (the reference's unit init, perturbed: at N(0, 0.1^2) the norms would
    silence the layers), the embedding N(0, 0.02^2), from numpy."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        noise = rng.standard_normal(leaf.shape)
        if path[0].key == "embed":
            return (noise * 0.02).astype(np.float32)
        if path[-1].key in ("scale", "q_norm", "k_norm"):
            return (1.0 + noise * 0.1).astype(np.float32)
        return (noise * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, tree)


def prompts(vocab, lens=PROMPTS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def build(name):
    """Both models, the numpy weights and each package's raw and prepared
    trees. The reference's ``prepare_params`` runs once, under ``jax.jit``:
    the same banks, bit for bit, in a fraction of the eager pass's seconds."""
    ref_model = ref_get_model(variant(ref_get_config(name), ref_reduced))
    np_params = numpy_params(jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    model = get_model(variant(get_config(name), reduced))
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    jraw = jax.tree.map(jnp.asarray, np_params)
    raw = model.load_numpy(np_params, "cpu")
    return dict(name=name, ref_model=ref_model, model=model, jctx=jctx, ctx=ctx, jraw=jraw,
                raw=raw,
                jprepared=jax.jit(lambda p: jax_prepare(p, jctx.policy, "kernel",
                                                        specs=ref_model.specs()))(jraw),
                prepared=prepare_params(raw, ctx.policy, "kernel", specs=model.specs()))


# llama4-maverick runs these tests in test_torch_llama4.py, beside its own
@pytest.fixture(scope="module", params=sorted(set(ARCHS) - {"llama4-maverick-400b-a17b"}))
def arch(request):
    return build(request.param)


def test_variant_keeps_the_arch_head_groups(arch):
    cfg, ref_cfg = arch["model"].cfg, arch["ref_model"].cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.kv_groups == ARCHS[arch["name"]][1] == get_config(arch["name"]).kv_groups
    assert get_config(arch["name"]).head_dim == 128  # stock: both attention kernels take it


@pytest.mark.parametrize("s", [1, 6], ids=["decode", "block"])
def test_decode_step_logits_match_reference(arch, s):
    ref_model, model = arch["ref_model"], arch["model"]
    vocab = model.cfg.vocab_size
    tokens = np.random.default_rng(s).integers(0, vocab, (2, s)).astype(np.int32)
    index = np.array([0, 5], np.int32)

    jcache = jax.tree.map(
        lambda a: jnp.broadcast_to(index, a.shape).astype(a.dtype) if a.dtype == jnp.int32
        else a, ref_model.make_cache(2, 16, dtype=jnp.float32))
    want, jcache = ref_model.decode_step(arch["jprepared"], jnp.asarray(tokens), jcache,
                                         arch["jctx"])

    cache = model.make_cache(2, 16, device="cpu")
    jax.tree.map(lambda a: a.copy_(torch.from_numpy(index).expand_as(a))
                 if a.dtype == torch.int32 else a, cache)
    with torch.no_grad():
        got, cache = model.decode_step(arch["prepared"], torch.from_numpy(tokens), cache,
                                       arch["ctx"])
    assert tuple(got.shape) == (2, s, vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    # the same cache tree (a pair segment nests one cache per sublayer), rows
    # and indices
    flat, jflat = (dict(jax.tree_util.tree_flatten_with_path(c)[0]) for c in (cache, jcache))
    assert [jax.tree_util.keystr(k) for k in flat] == [jax.tree_util.keystr(k) for k in jflat]
    for (path, leaf), jleaf in zip(flat.items(), jflat.values()):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), **LOGIT_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _ref_streams(arch, temperature=0.0):
    """The reference's streams, from one server per arch (greedy and sampled
    runs share its compiled programs)."""
    if "jserver" not in arch:
        arch["jserver"] = JServer(arch["ref_model"], arch["jctx"], arch["jprepared"], slots=2,
                                  max_len=MAX_LEN, burst=8)
    return arch["jserver"].run(_requests(JRequest, arch, temperature))


def _requests(cls, arch, temperature):
    return [cls(i, p, MAX_NEW, temperature=temperature, seed=SEED_BASE + i)
            for i, p in enumerate(prompts(arch["model"].cfg.vocab_size))]


def test_greedy_streams_identical_to_reference(arch):
    server = BatchedServer(arch["model"], arch["ctx"], arch["raw"], slots=2, max_len=MAX_LEN,
                           burst=8, device="cpu")
    got = server.run(_requests(Request, arch, 0.0))
    assert got == _ref_streams(arch)
    assert any(len(set(v)) > 2 for v in got.values())  # not a repeated-token stream
    assert server.host_transfers == len(PROMPTS) + server.decode_steps // 8


@pytest.mark.parametrize("arch", ["internvl2-2b"], indirect=True)
def test_internvl2_sampled_streams_identical_to_reference(arch):
    """Sampled at temperature 1.3 over the odd vocabulary: the threefry bits
    of a (slots, 253) row, the Gumbel noise and the argmax."""
    server = BatchedServer(arch["model"], arch["ctx"], arch["raw"], slots=2, max_len=MAX_LEN,
                           burst=8, device="cpu")
    got = server.run(_requests(Request, arch, TEMPERATURE))
    assert got == _ref_streams(arch, TEMPERATURE)
    assert got != server.run(_requests(Request, arch, 0.0))


def forward_batch(cfg, seed=3):
    """Seeded tokens (2, 16) and, for a vision model, its stub's frontend
    embeddings (2, frontend_tokens, d_model), 0.02 x N(0, 1) as the
    reference's data pipeline makes them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = (rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model))
                                    * 0.02).astype(np.float32)
    return batch


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_reference(arch, impl):
    """The cache-free forward on the prepared weights, under the reference's
    chunked chains and the flash kernel's plain version: logits (for
    internvl2 over the frontend rows too) and the MoE load-balancing loss."""
    ref_model, model = arch["ref_model"], arch["model"]
    batch = forward_batch(model.cfg)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl=impl)
    want, want_aux = ref_model.forward(arch["jprepared"], jax.tree.map(jnp.asarray, batch), jctx)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl=impl)
    with torch.no_grad():
        got, aux = model.forward(arch["prepared"],
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, ctx)
    rows = 16 + (model.cfg.frontend_tokens if model.cfg.frontend == "vision" else 0)
    assert tuple(got.shape) == (2, rows, model.cfg.vocab_size) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    assert abs(float(aux["lb_loss"]) - float(want_aux["lb_loss"])) <= LB_TOL
    assert (float(aux["lb_loss"]) > 0.5) == (model.cfg.moe is not None)
