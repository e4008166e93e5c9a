"""PyTorch port: reduced olmo-1b (2 layers, d_model 128) and reduced
deepseek-v3 (4 layers: one dense-prefix layer and three MoE layers, MLA
attention) against the reference, kernel mode, ``attn_impl="decode_kernel"``,
on the CPU: prepared weights, and for olmo-1b also the per-call path
(``prepare_weights=False``: every dot re-rounds its raw weight and runs the
MAC-array matmul, the gate its activation as a separate multi-AF pass).

Both packages get the same weights, drawn with numpy: layer matrices
N(0, 0.1^2) so that the layers, not the tied embedding, pick the tokens
(at the init scale of 0.02 every stream just repeats its last prompt token).
Logits agree to f32 reduction-order tolerance (norms, RoPE and the attention
softmax sum in another order); greedy streams must be identical. Per-call
and prepared logits are the same arithmetic and agree bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.blocks import cache_row_write  # noqa: E402
from repro_torch.serve import BatchedServer, Request, cache_positions  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = (3, 7, 12, 5)
MAX_NEW = 8


def _numpy_params(tree, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        scale = 0.02 if path[0].key == "embed" else 0.1
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, tree)


@pytest.fixture(scope="module")
def setup():
    ref_model = ref_get_model(ref_reduced(ref_get_config("olmo-1b")))
    np_params = _numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config("olmo-1b")))
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    return ref_model, np_params, model, jctx, ctx


def _prompts(lens=PROMPTS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def ref_streams(setup):
    ref_model, np_params, _, jctx, _ = setup
    params = jax.tree.map(jnp.asarray, np_params)
    server = JServer(ref_model, jctx, params, slots=2, max_len=32, burst=8)
    return server.run([JRequest(i, p, MAX_NEW) for i, p in enumerate(_prompts())])


@pytest.mark.parametrize("s", [1, 6], ids=["decode", "block"])
def test_decode_step_logits_match_reference(setup, s):
    ref_model, np_params, model, jctx, ctx = setup
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, 256, (2, s)).astype(np.int32)
    index = np.array([0, 5], np.int32)

    jparams = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, "kernel",
                          specs=ref_model.specs())
    jcache = ref_model.make_cache(2, 16, dtype=jnp.float32)
    jcache = jax.tree.map(
        lambda a: jnp.broadcast_to(index, a.shape).astype(a.dtype) if a.dtype == jnp.int32
        else a, jcache)
    want, jcache = ref_model.decode_step(jparams, jnp.asarray(tokens), jcache, jctx)

    tparams = prepare_params(model.load_numpy(np_params, "cpu"), ctx.policy, "kernel",
                             specs=model.specs())
    cache = model.make_cache(2, 16, device="cpu")
    cache["seg0_dense"]["index"].copy_(torch.from_numpy(index).expand(2, 2))
    with torch.no_grad():
        got, cache = model.decode_step(tparams, torch.from_numpy(tokens), cache, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    np.testing.assert_allclose(cache["seg0_dense"]["k"].numpy(),
                               np.asarray(jcache["seg0_dense"]["k"]), **LOGIT_TOL)
    np.testing.assert_array_equal(cache["seg0_dense"]["index"].numpy(),
                                  np.asarray(jcache["seg0_dense"]["index"]))


@pytest.mark.parametrize("burst", [1, 8])
def test_greedy_streams_identical_to_reference(setup, ref_streams, burst):
    _, np_params, model, _, ctx = setup
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2, max_len=32,
                           burst=burst, device="cpu")
    got = server.run([Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())])
    assert got == ref_streams
    assert len({tuple(v) for v in got.values()}) == len(PROMPTS)
    assert any(len(set(v)) > 2 for v in got.values())  # not a repeated-token stream
    assert server.host_transfers == len(PROMPTS) + server.decode_steps // burst


def test_free_slot_index_runs_past_max_len(setup):
    """Free slots keep decoding every burst; their index passes max_len and
    the KV write clamps as ``dynamic_update_slice`` does, in both packages."""
    ref_model, np_params, model, jctx, ctx = setup
    reqs = [(2, 14), (2, 14), (3, 13)]
    prompts = _prompts([p for p, _ in reqs], seed=4)
    want = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2, max_len=16,
                   burst=8).run([JRequest(i, p, n) for i, (p, (_, n)) in
                                 enumerate(zip(prompts, reqs))])
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2,
                           max_len=16, burst=8, device="cpu")
    got = server.run([Request(i, p, n) for i, (p, (_, n)) in enumerate(zip(prompts, reqs))])
    assert got == want
    assert int(cache_positions(server.cache).max()) > server.max_len


def test_cache_row_write_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(9)
    c = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    x = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    i = np.array([2, 6, 40], np.int32)
    want = jax_blocks.cache_row_write(jnp.asarray(c), jnp.asarray(x), jnp.asarray(i))
    got = cache_row_write(torch.from_numpy(c.copy()), torch.from_numpy(x), torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_request_validation(setup):
    _, np_params, model, _, ctx = setup
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=1,
                           max_len=16, burst=4, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        server.run([Request(0, np.zeros((0,), np.int32), 4)])
    with pytest.raises(ValueError, match="exceeds max_len"):
        server.run([Request(0, np.ones((10,), np.int32), 8)])
    # sampled decoding is served, not rejected
    assert len(server.run([Request(0, np.ones((3,), np.int32), 4, temperature=0.7)])[0]) == 4
    with pytest.raises(ValueError, match="burst"):
        BatchedServer(model, ctx, {}, burst=0, device="cpu")


def test_serving_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--reduced", "--mode", "kernel", "--requests", "3", "--slots", "2", "--max-new",
                "4", "--burst", "2", "--device", "cpu"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert "host round-trips" in capsys.readouterr().out


def test_serving_cli_per_call_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    args = ["--reduced", "--mode", "kernel", "--requests", "3", "--slots", "2", "--max-new", "4",
            "--burst", "2", "--device", "cpu"]
    prepared = main(args)
    assert "prepared kernel weights" in capsys.readouterr().out
    out = main(args + ["--per-call"])
    assert "per-call kernel weights" in capsys.readouterr().out
    assert out == prepared


# ---------------------------------------------------------------------------
# per-call kernel mode (prepare_weights=False)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_per_call_streams(setup):
    ref_model, np_params, _, jctx, _ = setup
    server = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2, max_len=32,
                     burst=8, prepare_weights=False)
    return server.run([JRequest(i, p, MAX_NEW) for i, p in enumerate(_prompts())])


@pytest.mark.parametrize("burst", [1, 8])
def test_per_call_streams_identical_to_reference_and_prepared(setup, ref_streams,
                                                              ref_per_call_streams, burst):
    _, np_params, model, _, ctx = setup
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2, max_len=32,
                           burst=burst, device="cpu", prepare_weights=False)
    assert isinstance(server.params["seg0_dense"]["mlp"]["up"], torch.Tensor)  # raw, unprepared
    got = server.run([Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())])
    assert got == ref_per_call_streams
    assert got == ref_streams  # the prepared streams, which the port's prepared path equals


@pytest.mark.parametrize("name", ["fxp8", "fxp16"])
def test_per_call_decode_step_logits_bitwise_equal_to_prepared(setup, name):
    _, np_params, model, _, _ = setup
    policy = PrecisionPolicy.accurate(FXP8 if name == "fxp8" else FXP16)
    ctx = EngineContext(mode="kernel", policy=policy, compute_dtype=torch.float32,
                        attn_impl="decode_kernel")
    raw = model.load_numpy(np_params, "cpu")
    trees = {"per_call": raw,
             "prepared": prepare_params(raw, policy, "kernel", specs=model.specs())}
    rng = np.random.default_rng(3)
    steps = [torch.from_numpy(rng.integers(0, 256, (2, s)).astype(np.int32)) for s in (5, 1, 1)]
    logits = {}
    for label, params in trees.items():
        cache = model.make_cache(2, 16, device="cpu")
        with torch.no_grad():
            logits[label] = [model.decode_step(params, t, cache, ctx)[0] for t in steps]
    for got, want in zip(logits["per_call"], logits["prepared"]):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# reduced deepseek-v3: MLA + MoE
# ---------------------------------------------------------------------------

DS_PROMPTS = (3, 7, 70, 5)  # 70 pads to a bucket of 96 > 64: capacity may drop
DS_MAX_LEN = 96


@pytest.fixture(scope="module")
def ds_setup():
    ref_model = ref_get_model(ref_reduced(ref_get_config("deepseek-v3-671b"), layers=4))
    np_params = _numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config("deepseek-v3-671b"), layers=4))
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    return ref_model, np_params, model, jctx, ctx


@pytest.fixture(scope="module")
def ds_ref_streams(ds_setup):
    ref_model, np_params, _, jctx, _ = ds_setup
    server = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2,
                     max_len=DS_MAX_LEN, burst=8)
    return server.run([JRequest(i, p, MAX_NEW) for i, p in enumerate(_prompts(DS_PROMPTS))])


@pytest.mark.parametrize("s", [1, 6], ids=["decode", "block"])
def test_deepseek_decode_step_logits_match_reference(ds_setup, s):
    ref_model, np_params, model, jctx, ctx = ds_setup
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, 256, (2, s)).astype(np.int32)
    index = np.array([0, 5], np.int32)

    jparams = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, "kernel",
                          specs=ref_model.specs())
    jcache = ref_model.make_cache(2, 16, dtype=jnp.float32)
    jcache = jax.tree.map(
        lambda a: jnp.broadcast_to(index, a.shape).astype(a.dtype) if a.dtype == jnp.int32
        else a, jcache)
    want, jcache = ref_model.decode_step(jparams, jnp.asarray(tokens), jcache, jctx)

    tparams = prepare_params(model.load_numpy(np_params, "cpu"), ctx.policy, "kernel",
                             specs=model.specs())
    cache = model.make_cache(2, 16, device="cpu")
    for seg in cache.values():
        seg["index"].copy_(torch.from_numpy(index).expand_as(seg["index"]))
    with torch.no_grad():
        got, cache = model.decode_step(tparams, torch.from_numpy(tokens), cache, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    assert sorted(cache) == sorted(jcache) == ["seg0_dense_prefix", "seg1_moe"]
    for key, seg in cache.items():
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(seg[name].numpy(), np.asarray(jcache[key][name]),
                                       **LOGIT_TOL)
        np.testing.assert_array_equal(seg["index"].numpy(), np.asarray(jcache[key]["index"]))


@pytest.mark.parametrize("burst", [1, 8])
def test_deepseek_greedy_streams_identical_to_reference(ds_setup, ds_ref_streams, burst):
    _, np_params, model, _, ctx = ds_setup
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2,
                           max_len=DS_MAX_LEN, burst=burst, device="cpu")
    got = server.run([Request(i, p, MAX_NEW) for i, p in enumerate(_prompts(DS_PROMPTS))])
    assert got == ds_ref_streams
    assert any(len(set(v)) > 2 for v in got.values())  # not a repeated-token stream
    assert server.host_transfers == len(DS_PROMPTS) + server.decode_steps // burst


def test_serving_cli_serves_interleaved_moe_on_cpu(capsys):
    """llama4-maverick reduced (one interleaved dense/MoE pair) through the
    CLI; its parity with the reference is in test_torch_llama4.py."""
    from repro_torch.launch.serve import main

    out = main(["--arch", "llama4-maverick-400b-a17b", "--reduced", "--mode", "kernel",
                "--requests", "3",
                "--slots", "2", "--max-new", "4", "--burst", "2", "--device", "cpu"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert "host round-trips" in capsys.readouterr().out


def test_serving_cli_serves_deepseek_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "deepseek-v3-671b", "--reduced", "--mode", "kernel", "--requests", "3",
                "--slots", "2",
                "--max-new", "4", "--burst", "2", "--device", "cpu"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert "host round-trips" in capsys.readouterr().out
