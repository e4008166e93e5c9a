"""PyTorch port: the recurrent families served, against the reference, on the
CPU: mamba2-780m (``ssm``: a segment of Mamba2 layers, no attention) and
zamba2-7b (``hybrid``: groups of ``attn_every`` Mamba2 layers, each followed
by the weight-shared attention block), reduced, kernel mode, prepared FxP8
weights, ``attn_impl="decode_kernel"``.

Both packages get the same seeded numpy weights (``test_torch_mamba2.
numpy_params``). Decode-step logits and cache agree to f32 reduction-order
tolerance; the cache-free forward runs the chunked SSD, whose ulps can move
an FxP8 rounding (``assert_close_up_to_flips``). Greedy streams are
identical to the reference's ``BatchedServer`` at burst 4 and burst 1, with
prompts shorter than their buckets, which the reference's scan prefill pads
and masks and the port's runs only over the prompt; mamba2's sampled streams
too. The scan prefill costs one transfer per prefill and one single-token
step per prompt token, and leaves its static row cache zeroed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.backends import iter_dot_weights as jax_iter_dot_weights  # noqa: E402
from repro.models.transformer import _cache_index as ref_cache_index  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro.serve.kvcache import scatter_rows as ref_scatter_rows  # noqa: E402
from repro_torch.core.backends import iter_dot_weights  # noqa: E402
from repro_torch.models.transformer import _cache_index  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.serve.kvcache import scatter_rows  # noqa: E402
from test_torch_mamba2 import (  # noqa: E402, F401
    LOGIT_TOL, assert_close_up_to_flips, build, one_torch_thread)

PROMPTS = (3, 6, 5, 2)  # buckets 4, 8, 8, 2: three prompts shorter than their bucket
MAX_NEW = 8
MAX_LEN = 32
TEMPERATURE, SEED_BASE = 1.3, 40
# a forward's rows where an FxP8 flip moved the logits: each within
# FLIP_ATOL (one grid step's effect through the later layers), and at most
# this share of the positions: a flip at one position reaches the later ones
# through the recurrent state, decaying
FLIP_ATOL, MAX_FLIP_SHARE = 0.05, 0.25

ARCHS = ("mamba2-780m", "zamba2-7b")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    out = build(request.param)
    assert dataclasses.asdict(out["model"].cfg) == dataclasses.asdict(out["ref_model"].cfg)
    return out


def prompts(vocab, lens=PROMPTS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def requests(cls, arch, temperature=0.0):
    return [cls(i, p, MAX_NEW, temperature=temperature, seed=SEED_BASE + i)
            for i, p in enumerate(prompts(arch["model"].cfg.vocab_size))]


def ref_streams(arch, temperature=0.0):
    """The reference's streams at burst 4, one server per arch."""
    if "jserver" not in arch:
        arch["jserver"] = JServer(arch["ref_model"], arch["jctx"], arch["jprepared"], slots=2,
                                  max_len=MAX_LEN, burst=4)
        assert not arch["jserver"].batched_prefill  # the masked-scan prefill
    return arch["jserver"].run(requests(JRequest, arch, temperature))


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_decode_step_logits_and_cache_match_reference(arch):
    """Four single-token steps from a fresh cache of two rows: the logits and
    every cache leaf (conv windows, SSM states, and zamba2's shared
    attention rows and index), the same tree as the reference's."""
    ref_model, model = arch["ref_model"], arch["model"]
    jcache = ref_model.make_cache(2, 16, dtype=jnp.float32)
    cache = model.make_cache(2, 16, device="cpu")
    tokens = np.random.default_rng(2).integers(0, model.cfg.vocab_size, (2, 1)).astype(np.int32)
    for _ in range(4):
        want, jcache = ref_model.decode_step(arch["jprepared"], jnp.asarray(tokens), jcache,
                                             arch["jctx"])
        with torch.no_grad():
            got, cache = model.decode_step(arch["prepared"], torch.from_numpy(tokens), cache,
                                           arch["ctx"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
        tokens = np.asarray(want).argmax(-1).astype(np.int32)
    flat, jflat = _flat(cache), _flat(jcache)
    assert [jax.tree_util.keystr(k) for k in flat] == [jax.tree_util.keystr(k) for k in jflat]
    for (path, leaf), jleaf in zip(flat.items(), jflat.values()):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), **LOGIT_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_forward_matches_reference(arch):
    """The cache-free forward over two SSD chunks (S = 64, chunk 32): logits
    within LOGIT_TOL and the argmax identical, up to FxP8 flips; zamba2's
    shared attention under ``"flash"`` (the flash kernel's plain version),
    mamba2 (no attention) under ``"xla"``."""
    from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy
    from repro_torch.core import EngineContext, PrecisionPolicy

    ref_model, model = arch["ref_model"], arch["model"]
    impl = "flash" if model.cfg.family == "hybrid" else "xla"
    tokens = np.random.default_rng(3).integers(0, model.cfg.vocab_size, (2, 64)).astype(np.int32)
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl=impl)
    want, want_aux = ref_model.forward(arch["jprepared"], {"tokens": jnp.asarray(tokens)}, jctx)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl=impl)
    with torch.no_grad():
        got, aux = model.forward(arch["prepared"], {"tokens": torch.from_numpy(tokens)}, ctx)
    assert tuple(got.shape) == (2, 64, model.cfg.vocab_size)
    assert_close_up_to_flips(got.numpy(), want, flip_atol=FLIP_ATOL,
                             max_flip_share=MAX_FLIP_SHARE, argmax=True)
    assert float(aux["lb_loss"]) == float(want_aux["lb_loss"]) == 0.0


@pytest.mark.parametrize("burst", [4, 1])
def test_greedy_streams_identical_to_reference(arch, burst):
    server = BatchedServer(arch["model"], arch["ctx"], arch["raw"], slots=2, max_len=MAX_LEN,
                           burst=burst, device="cpu")
    assert not server.batched_prefill
    got = server.run(requests(Request, arch))
    assert got == ref_streams(arch)
    assert any(len(set(v)) > 2 for v in got.values())  # not a repeated-token stream
    # one transfer a prefill and a burst; one single-token step a prompt token
    assert server.prefill_calls == len(PROMPTS)
    assert server.prefill_steps == sum(PROMPTS)
    assert server.host_transfers == len(PROMPTS) + server.decode_steps // burst
    # the finish program leaves the static row cache and the scan state zeroed
    assert all(not leaf.any() for leaf in _flat(server._row).values())
    assert not server._scan["i"].any() and not server._scan["last"].any()


@pytest.mark.parametrize("arch", ["mamba2-780m"], indirect=True)
def test_mamba2_sampled_streams_identical_to_reference(arch):
    server = BatchedServer(arch["model"], arch["ctx"], arch["raw"], slots=2, max_len=MAX_LEN,
                           burst=4, device="cpu")
    got = server.run(requests(Request, arch, TEMPERATURE))
    assert got == ref_streams(arch, TEMPERATURE)
    assert got != server.run(requests(Request, arch))


@pytest.mark.parametrize("arch", ["zamba2-7b"], indirect=True)
def test_hybrid_scatter_rows_finds_the_slot_axis(arch):
    """A hybrid cache's SSM leaves are (groups, attn_every, slots, ...): their
    slot axis is 2, the shared attention's 1; ``scatter_rows`` finds each by
    shape, as the reference's does."""
    model, ref_model = arch["model"], arch["ref_model"]
    cache = model.make_cache(3, 8, device="cpu")
    row = model.make_cache(1, 8, device="cpu")
    leaves = _flat(row)
    for i, leaf in enumerate(leaves.values()):
        leaf.copy_(torch.arange(leaf.numel(), dtype=leaf.dtype).reshape(leaf.shape) + i + 1)
    ssm = cache["seg0_hybrid"]["ssm"]["ssm"]
    per = model.cfg.hybrid.attn_every
    assert ssm.shape[:3] == (model.cfg.num_layers // per, per, 3)
    jfull = ref_scatter_rows(jax.tree.map(jnp.asarray, _numpy(cache)),
                             jax.tree.map(jnp.asarray, _numpy(row)), 1)
    scatter_rows(cache, row, torch.tensor([1], dtype=torch.int32))
    for (path, leaf), jleaf in zip(_flat(cache).items(), _flat(jfull).values()):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert torch.equal(ssm[:, :, 1], row["seg0_hybrid"]["ssm"]["ssm"][:, :, 0])
    assert not ssm[:, :, 0].any() and not ssm[:, :, 2].any()
    del ref_model


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


@pytest.mark.parametrize("arch", ["mamba2-780m"], indirect=True)
def test_cache_index_is_zeros_for_an_ssm_cache(arch):
    """An SSM-only cache carries no write index: positions are zeros (B,),
    as the reference's ``_cache_index`` returns."""
    cache = arch["model"].make_cache(3, 8, device="cpu")
    got = _cache_index(cache)
    want = ref_cache_index(arch["ref_model"].make_cache(3, 8, dtype=jnp.float32))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3,) and not got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _entries(it):
    return [(tuple(keys), name, stacked, in_axes) for keys, name, _, stacked, in_axes in it]


def test_dot_weights_match_reference(arch):
    """``iter_dot_weights`` on the raw and prepared trees yields the
    reference's leaves, policy names, stacked and contraction axes: the
    Mamba2 in/out projections (one stacked axis; a hybrid group's nested
    two), zamba2's shared block under its parameter path (``shared_attn``:
    no stacked axis), the lm_head."""
    ref_specs, specs = arch["ref_model"].specs(), arch["model"].specs()
    for jtree, tree in ((arch["jraw"], arch["raw"]), (arch["jprepared"], arch["prepared"])):
        # as sets of entries: JAX flattens a dict in sorted key order, the
        # port in insertion order
        want = sorted(_entries(jax_iter_dot_weights(jtree, specs=ref_specs)))
        assert sorted(_entries(iter_dot_weights(tree, specs=specs))) == want
    by_name = {name: stacked for _, name, stacked, _ in want}
    if arch["model"].cfg.family == "hybrid":
        assert by_name["layer.mixer.in_proj"] == 2
        assert by_name["shared_attn.attn.q"] == 0 and by_name["shared_attn.mlp.gate"] == 0
    else:
        assert by_name["layer.mixer.in_proj"] == 1 and by_name["layer.mixer.out_proj"] == 1


@pytest.mark.parametrize("arch", ["zamba2-7b"], indirect=True)
def test_dot_runtime_names_match_reference(arch, monkeypatch):
    """The names the dots of a decode step run under through
    ``EngineContext.dot``, which a precision policy matches (by substring)
    at run time: the reference's and the port's. The shared block
    runs as ``shared.attn`` / ``shared.mlp`` while its prepared banks take
    their names from the ``shared_attn.*`` parameter paths, so a policy
    keyed by those paths never demotes it per call or in the calibration
    scan, in either package (ROADMAP Queue 3)."""
    from repro.core import engine as jax_engine
    from repro_torch.core import engine as torch_engine

    names = {"ref": set(), "port": set()}

    def recording(module, key):
        dot = module.EngineContext.dot

        def run(self, x, w, *, name=""):
            names[key].add(name)
            return dot(self, x, w, name=name)

        monkeypatch.setattr(module.EngineContext, "dot", run)

    recording(jax_engine, "ref")
    recording(torch_engine, "port")
    tokens = np.zeros((1, 1), np.int32)
    arch["ref_model"].decode_step(arch["jprepared"], jnp.asarray(tokens),
                                  arch["ref_model"].make_cache(1, 8, dtype=jnp.float32),
                                  arch["jctx"])
    with torch.no_grad():
        arch["model"].decode_step(arch["prepared"], torch.from_numpy(tokens),
                                  arch["model"].make_cache(1, 8, device="cpu"), arch["ctx"])
    assert names["port"] == names["ref"]
    assert {"shared.attn.q", "shared.mlp.up", "layer.mixer.in_proj"} <= names["port"]
    prepared = {name for _, name, _, _, _ in iter_dot_weights(arch["prepared"],
                                                              specs=arch["model"].specs())}
    assert "shared_attn.attn.q" in prepared and not prepared & {"shared.attn.q"}
