"""PyTorch port: sampled serving and the two device programs against the
reference, on the CPU, kernel mode, prepared weights: reduced olmo-1b (2
layers, d_model 128) and one reduced deepseek-v3 case (MLA + MoE).

Weights come from numpy as in ``test_torch_serving.py`` (layer matrices
N(0, 0.1^2)). The JAX side runs under ``jax.threefry_partitionable(True)``,
the layout the port implements. Sampled streams (temperature 1.3, request
``i`` seeded ``40 + i``) must equal the reference's; the only allowed
parting is at a near-tie (``NEAR_TIE``, as ``test_torch_sampling``): where a
stream parts, the test recomputes the reference's perturbed logits at that
token and requires their top-2 gap to be under it. The port's
``make_bucketed_prefill`` and ``make_decode_burst``, run eagerly, give the
reference functions' slot state exactly, and their cache rows and margins
within the f32 reduction-order tolerance that the logits carry.
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
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import BatchedServer, Request, bucket_length, engine, threefry  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEAR_TIE = 1e-5
TEMP, SEED_BASE = 1.3, 40
PROMPTS = (3, 7, 12, 5)
MAX_NEW, MAX_LEN = 8, 32


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


def _numpy_params(tree, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        scale = 0.02 if path[0].key == "embed" else 0.1
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, tree)


def _setup(arch, layers=None):
    ref_model = ref_get_model(ref_reduced(ref_get_config(arch), **({"layers": layers} if layers
                                                                  else {})))
    np_params = _numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config(arch), **({"layers": layers} if layers else {})))
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    return ref_model, np_params, model, jctx, ctx


@pytest.fixture(scope="module")
def olmo():
    return _setup("olmo-1b")


def _prompts(lens=PROMPTS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _requests(cls, lens=PROMPTS, temperature=TEMP, n=None):
    prompts = _prompts(lens)[:n]
    return [cls(i, p, MAX_NEW, temperature=temperature, seed=SEED_BASE + i)
            for i, p in enumerate(prompts)]


def _ref_serve(setup, max_len=MAX_LEN, lens=PROMPTS, temperature=TEMP):
    ref_model, np_params, _, jctx, _ = setup
    server = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2,
                     max_len=max_len, burst=8)
    return server.run(_requests(JRequest, lens, temperature))


def _serve(setup, burst, max_len=MAX_LEN, lens=PROMPTS, temperature=TEMP, slots=2, n=None):
    _, np_params, model, _, ctx = setup
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=slots,
                           max_len=max_len, burst=burst, device="cpu")
    return server.run(_requests(Request, lens, temperature, n))


def _near_tie_gap(setup, prompt, prefix, rid, max_len):
    """The reference's top-2 gap of perturbed logits for the token after
    ``prompt + prefix`` of request ``rid`` (one block forward of the
    reference model)."""
    ref_model, np_params, _, jctx, _ = setup
    tree = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, "kernel",
                       specs=ref_model.specs())
    tokens = jnp.asarray(np.concatenate([prompt, np.asarray(prefix, np.int32)])[None])
    cache = ref_model.make_cache(1, max_len, dtype=jnp.float32)
    logits, _ = ref_model.decode_step(tree, tokens, cache, jctx)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED_BASE + rid), len(prefix))
    scaled = logits[0, -1].astype(jnp.float32) / TEMP
    top2 = np.asarray(jax.lax.top_k(scaled + jax.random.gumbel(key, scaled.shape), 2)[0])
    return float(top2[0] - top2[1])


def _assert_same_or_near_tie(setup, got, want, lens=PROMPTS, max_len=MAX_LEN):
    prompts = _prompts(lens)
    parted = 0
    for rid, stream in want.items():
        if got[rid] == stream:
            continue
        at = next(i for i, (a, b) in enumerate(zip(got[rid], stream)) if a != b)
        gap = _near_tie_gap(setup, prompts[rid], stream[:at], rid, max_len)
        print(f"request {rid} parts from the reference at token {at}: gap {gap:.3g}")
        assert gap < NEAR_TIE, (rid, at, gap)
        parted += 1
    assert parted <= 1, f"{parted} streams part from the reference"


@pytest.fixture(scope="module")
def olmo_ref_sampled(olmo):
    return _ref_serve(olmo)


@pytest.mark.parametrize("burst", [1, 8])
def test_sampled_streams_match_reference(olmo, olmo_ref_sampled, burst):
    got = _serve(olmo, burst)
    _assert_same_or_near_tie(olmo, got, olmo_ref_sampled)
    assert any(len(set(v)) > 4 for v in got.values())


def test_sampled_streams_identical_alone_and_batched(olmo):
    together = _serve(olmo, 8)
    alone = _serve(olmo, 4, slots=1, n=1)
    assert alone[0] == together[0]


def test_sampled_streams_differ_from_greedy(olmo):
    assert _serve(olmo, 8) != _serve(olmo, 8, temperature=0.0)


def _slot_state(jstate, state):
    for name in ("tok", "count", "rem", "temp", "fault"):
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(jstate[name]), err_msg=name)
    np.testing.assert_array_equal(state["key"].numpy(),
                                  np.asarray(jstate["key"]).astype(np.int64))


def _programs_match_reference(setup, lens, max_len):
    """Prefill ``lens`` into slots 0 and 1 with both packages' bucketed
    prefill (one greedy request, one sampled), then one greedy and one
    sampled burst of 4; compare outputs, slot state and cache after each."""
    ref_model, np_params, model, jctx, ctx = setup
    jtree = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, "kernel",
                        specs=ref_model.specs())
    tree = prepare_params(model.load_numpy(np_params, "cpu"), ctx.policy, "kernel",
                          specs=model.specs())
    jcache = ref_model.make_cache(2, max_len, dtype=jnp.float32)
    cache = model.make_cache(2, max_len, device="cpu")
    jstate = ref_engine._init_slot_state(2)
    state = engine._init_slot_state(2)
    _slot_state(jstate, state)
    jprefill = ref_engine.make_bucketed_prefill(ref_model, jctx, max_len)
    prefill = engine.make_bucketed_prefill(model, ctx, max_len)
    for slot, (prompt, temp) in enumerate(zip(_prompts(lens), (0.0, TEMP))):
        padded = np.zeros((1, bucket_length(len(prompt), max_len)), np.int32)
        padded[0, :len(prompt)] = prompt
        jtok, jmargin, jcache, jstate = jprefill(
            jtree, jcache, jstate, jnp.asarray(padded), jnp.int32(len(prompt)),
            jnp.int32(slot), jax.random.PRNGKey(SEED_BASE + slot), jnp.float32(temp),
            jnp.int32(MAX_NEW))
        with torch.no_grad():
            tok, margin = prefill(
                tree, cache, state, torch.from_numpy(padded), torch.tensor(len(prompt)),
                torch.tensor(slot), threefry.prng_key(SEED_BASE + slot), torch.tensor(temp),
                torch.tensor(MAX_NEW))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(margin.numpy(), np.asarray(jmargin), **LOGIT_TOL)
        _slot_state(jstate, state)
    for sampled in (False, True):
        jcache, jstate, jtoks, jmargins, jfaults = ref_engine.make_decode_burst(
            ref_model, jctx, 4, sampled=sampled)(jtree, jcache, jstate)
        with torch.no_grad():
            toks, margins, faults = engine.make_decode_burst(model, ctx, 4, sampled=sampled)(
                tree, cache, state)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(faults.numpy(), np.asarray(jfaults))
        np.testing.assert_allclose(margins.numpy(), np.asarray(jmargins), **LOGIT_TOL)
        _slot_state(jstate, state)
    for key, seg in cache.items():
        for name, leaf in seg.items():
            want = np.asarray(jcache[key][name])
            if name == "index":
                np.testing.assert_array_equal(leaf.numpy(), want)
            else:
                np.testing.assert_allclose(leaf.numpy(), want, **LOGIT_TOL)


def test_programs_match_reference_functions(olmo):
    _programs_match_reference(olmo, (5, 12), MAX_LEN)


# ---------------------------------------------------------------------------
# reduced deepseek-v3: MLA + MoE
# ---------------------------------------------------------------------------

DS_PROMPTS = (3, 7, 20, 5)
DS_MAX_LEN = 48


@pytest.fixture(scope="module")
def deepseek():
    return _setup("deepseek-v3-671b", layers=4)


def test_deepseek_sampled_streams_and_programs_match_reference(deepseek):
    want = _ref_serve(deepseek, DS_MAX_LEN, DS_PROMPTS)
    got = _serve(deepseek, 8, DS_MAX_LEN, DS_PROMPTS)
    _assert_same_or_near_tie(deepseek, got, want, DS_PROMPTS, DS_MAX_LEN)
    assert got != _serve(deepseek, 8, DS_MAX_LEN, DS_PROMPTS, temperature=0.0)
    _programs_match_reference(deepseek, (5, 20), DS_MAX_LEN)


def test_serving_cli_samples_on_cpu(capsys):
    from repro_torch.launch.serve import main

    args = ["--reduced", "--requests", "3", "--slots", "2", "--max-new", "6", "--burst", "2",
            "--device", "cpu"]
    greedy = main(args)
    sampled = main(args + ["--temperature", "1.3", "--seed", "40"])
    assert "temperature 1.3" in capsys.readouterr().out
    assert sampled == main(args + ["--temperature", "1.3", "--seed", "40", "--burst", "4"])
    assert sampled != greedy and sampled != main(args + ["--temperature", "1.3", "--seed", "41"])
