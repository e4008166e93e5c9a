"""PyTorch port: self-speculative serving (``repro_torch.spec``; the server's
``speculate=`` and the CLI's ``--speculative``) against the reference, on
the CPU.

Reduced olmo-1b (2 layers, d_model 128) and reduced deepseek-v3 (4 layers,
MLA + MoE) in kernel mode, the same numpy weights on both sides (layer
matrices N(0, 0.1^2), as test_torch_serving), the bank's approx and accurate
FxP8 points. On the CPU the multi-token verify's logits are the
token-by-token decode's bit for bit, so greedy speculation equals
accurate-only serving bit for bit (streams and f32 margins) and the
reference's streams exactly; margins agree with the reference's to the
logits' f32 reduction-order tolerance (1e-4). Sampled speculation draws the
reference's threefry bits: on these seeds its streams equal the
reference's (no accept test or sample lands within the softmax's f32 ulps
of a tie).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import FXP8 as J8  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, EngineContext, PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.spec import (SpecConfig, SpecTelemetry, SpeculativeDecoder,  # noqa: E402
                              cache_positions, make_verify_step, rollback)
from repro_torch.spec.decoding import _temp_dist  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_serving import _numpy_params  # noqa: E402

MARGIN_TOL = 1e-4
PROMPTS = (3, 7, 12, 5)
MAX_NEW = 8
DRAFT_LEN = 4
MAX_LEN = 40
TEMPERATURE, SEED_BASE = 1.3, 40


def _setup(arch, layers=None):
    ref_cfg = ref_reduced(ref_get_config(arch), **({"layers": layers} if layers else {}))
    ref_model = ref_get_model(ref_cfg)
    np_params = _numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config(arch), **({"layers": layers} if layers else {})))
    jctx = JCtx(mode="kernel", policy=JPolicy.accurate(), compute_dtype=jnp.float32,
                attn_impl="decode_kernel")
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    bank = rt.build_bank(model.load_numpy(np_params, "cpu"), "kernel",
                         rt.default_points(FXP8, hifi_fmt=None), specs=model.specs())
    return ref_model, np_params, model, jctx, ctx, bank


@pytest.fixture(scope="module")
def olmo():
    return _setup("olmo-1b")


@pytest.fixture(scope="module")
def deepseek():
    return _setup("deepseek-v3-671b", layers=4)


def _prompts(lens=PROMPTS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _requests(cls, temperature=0.0, max_new=MAX_NEW, lens=PROMPTS):
    return [cls(i, p, max_new, temperature=temperature,
                seed=SEED_BASE + i if temperature > 0 else None)
            for i, p in enumerate(_prompts(lens))]


def _accurate_run(setup, reqs, slots=2):
    """Accurate-only serving of the bank's accurate tree (the baseline)."""
    _, _, model, _, ctx, bank = setup
    server = BatchedServer(model, ctx, bank.tree("accurate"), slots=slots, max_len=MAX_LEN,
                           burst=8, device="cpu", prepare_weights=False)
    return server.run(reqs)


def _spec_server(setup, slots=2, draft_len=DRAFT_LEN, **kw):
    _, np_params, model, _, ctx, bank = setup
    kw.setdefault("bank", bank)
    return BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=slots,
                         max_len=MAX_LEN, device="cpu",
                         speculate=SpecConfig(draft_len=draft_len), **kw)


@pytest.fixture(scope="module")
def ref_spec(olmo):
    """The reference's speculative runs of the same requests, greedy and
    sampled."""
    ref_model, np_params, _, jctx, _, _ = olmo
    params = jax.tree.map(jnp.asarray, np_params)
    jbank = jrt.build_bank(params, "kernel", jrt.default_points(J8, hifi_fmt=None),
                           specs=ref_model.specs())
    out = {}
    for temp in (0.0, TEMPERATURE):
        server = JServer(ref_model, jctx, params, slots=2, max_len=MAX_LEN,
                         speculate=jspec.SpecConfig(draft_len=DRAFT_LEN), bank=jbank)
        reqs = _requests(JRequest, temp)
        out[temp] = (server.run(reqs), reqs, server.spec_telemetry.summary())
    return out


@pytest.fixture(scope="module")
def ds_ref_streams(deepseek):
    """The reference's accurate-only greedy serving of the requests (its
    test_spec holds its own greedy speculation equal to it)."""
    ref_model, np_params, _, jctx, _, _ = deepseek
    server = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2,
                     max_len=MAX_LEN, burst=8)
    reqs = _requests(JRequest)
    return server.run(reqs), reqs


# ---------------------------------------------------------------------------
# the verify's multi-token decode and the rollback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo", "deepseek"])
def test_multitoken_verify_logits_equal_token_by_token(request, arch):
    """S = k+1 decode against a populated cache gives each position the
    logits, and each layer the KV rows, that S single-token steps give, bit
    for bit (dense GQA; MLA + MoE)."""
    _, _, model, _, ctx, bank = request.getfixturevalue(arch)
    tree = bank.tree("accurate")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, 256, (2, 5)).astype(np.int32))
    block = torch.from_numpy(rng.integers(0, 256, (2, DRAFT_LEN + 1)).astype(np.int32))
    with torch.no_grad():
        cache = model.make_cache(2, 24, device="cpu")
        model.decode_step(tree, prompt, cache, ctx)
        seq_cache = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
        seq = torch.cat([model.decode_step(tree, block[:, j:j + 1], seq_cache, ctx)[0]
                         for j in range(block.shape[1])], dim=1)
        blk, cache = model.decode_step(tree, block, cache, ctx)
    assert torch.equal(seq, blk)
    for key, seg in cache.items():
        for name, t in seg.items():
            assert torch.equal(t, seq_cache[key][name]), (key, name)


def test_rollback_hides_drafted_rows(olmo):
    _, _, model, _, ctx, bank = olmo
    tree = bank.tree("accurate")
    with torch.no_grad():
        cache = model.make_cache(1, 16, device="cpu")
        model.decode_step(tree, torch.tensor([[4, 9, 1]], dtype=torch.int32), cache, ctx)
        committed = cache_positions(cache).clone()
        assert committed.tolist() == [3]
        fresh = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
        want, _ = model.decode_step(tree, torch.tensor([[7]], dtype=torch.int32), fresh, ctx)
        for t in (250, 251, 252):
            model.decode_step(tree, torch.tensor([[t]], dtype=torch.int32), cache, ctx)
        assert cache_positions(cache).tolist() == [6]
        rollback(cache, committed)
        assert cache_positions(cache).tolist() == [3]
        got, _ = model.decode_step(tree, torch.tensor([[7]], dtype=torch.int32), cache, ctx)
    assert torch.equal(want, got)


def test_recurrent_families_refused(olmo):
    *_, bank = olmo
    model = get_model(reduced(get_config("mamba2-780m")))
    with pytest.raises(ValueError, match="write index"):
        cache_positions(model.make_cache(1, 8, device="cpu"))
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="roll back"):
        BatchedServer(model, ctx, params, slots=1, max_len=32, device="cpu",
                      speculate=SpecConfig(), bank=bank)


# ---------------------------------------------------------------------------
# greedy speculation == accurate-only serving == the reference
# ---------------------------------------------------------------------------


def test_greedy_spec_equals_accurate_and_reference_olmo(olmo, ref_spec):
    want, jreqs, jtele = ref_spec[0.0]
    acc_reqs = _requests(Request)
    accurate = _accurate_run(olmo, acc_reqs)
    server = _spec_server(olmo)
    reqs = _requests(Request)
    got = server.run(reqs)
    assert got == accurate == want
    assert [r.margins for r in reqs] == [r.margins for r in acc_reqs]  # f32, bit for bit
    for r, j in zip(reqs, jreqs):
        np.testing.assert_allclose(r.margins, j.margins, atol=MARGIN_TOL, rtol=0)
    tele = server.spec_telemetry.summary()
    assert tele == jtele
    assert tele["emitted"] == sum(len(v) - 1 for v in got.values())
    # one transfer a prefill and a round
    assert server.host_transfers == len(PROMPTS) + server.spec_rounds
    assert server.spec_rounds == tele["rounds"] and server.decode_steps == DRAFT_LEN * tele["rounds"]


def test_greedy_spec_equals_accurate_and_reference_deepseek(deepseek, ds_ref_streams):
    want, jreqs = ds_ref_streams
    acc_reqs = _requests(Request)
    accurate = _accurate_run(deepseek, acc_reqs)
    server = _spec_server(deepseek)
    reqs = _requests(Request)
    got = server.run(reqs)
    assert got == accurate == want
    assert any(len(set(v)) > 2 for v in got.values())  # not a repeated-token stream
    assert [r.margins for r in reqs] == [r.margins for r in acc_reqs]
    for r, j in zip(reqs, jreqs):
        np.testing.assert_allclose(r.margins, j.margins, atol=MARGIN_TOL, rtol=0)
    assert server.spec_telemetry.summary()["rounds"] == server.spec_rounds > 0


@pytest.mark.parametrize("slots,draft_len", [(1, 1), (2, 2)])
def test_greedy_spec_other_shapes_equal_accurate(olmo, slots, draft_len):
    want = _accurate_run(olmo, _requests(Request, max_new=6), slots=slots)
    got = _spec_server(olmo, slots=slots, draft_len=draft_len).run(_requests(Request, max_new=6))
    assert got == want


def test_sampled_spec_matches_reference(olmo, ref_spec):
    want, jreqs, jtele = ref_spec[TEMPERATURE]
    server = _spec_server(olmo)
    reqs = _requests(Request, TEMPERATURE)
    got = server.run(reqs)
    assert got == want
    assert all(len(v) == MAX_NEW for v in got.values())
    assert server.spec_telemetry.summary() == jtele
    assert 0 < jtele["accepted"] < jtele["drafted"]  # both accept and reject ran
    for r, j in zip(reqs, jreqs):
        np.testing.assert_allclose(r.margins, j.margins, atol=MARGIN_TOL, rtol=0)
    # a second run starts the round counter (the PRNG folds) afresh
    again = _requests(Request, TEMPERATURE)
    assert server.run(again) == got and [r.margins for r in again] == [r.margins for r in reqs]


def test_controller_picks_draft_point_and_margins_flow(olmo):
    *_, bank = olmo
    ctrl = rt.ModeController(bank, rt.ControllerConfig(pin="approx"))
    server = _spec_server(olmo, controller=ctrl, bank=None)
    got = server.run(_requests(Request))
    assert got == _accurate_run(olmo, _requests(Request))
    spec = server.spec_telemetry.summary()
    assert spec["rounds_by_draft_point"]["approx"] == spec["rounds"] > 0
    assert len(server.telemetry.min_margins) == spec["rounds"]
    # prefill charged at the verify point, the rounds at the draft point
    assert server.telemetry.tokens_by_point["accurate"] == sum(PROMPTS)
    assert [r["kind"] for r in server._telemetry_records()] == ["adaptive", "speculative"]


# ---------------------------------------------------------------------------
# the verify's arithmetic, configuration and telemetry
# ---------------------------------------------------------------------------


def test_draft_fault_degrades_to_verify_point_decode(olmo):
    """A slot whose draft distributions are non-finite accepts nothing and
    takes the verify point's position-0 token; the other slot is untouched."""
    _, _, model, _, ctx, bank = olmo
    tree, k = bank.tree("accurate"), 3
    verify = make_verify_step(model, ctx, k)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        cache = model.make_cache(2, 24, device="cpu")
        model.decode_step(tree, torch.from_numpy(rng.integers(0, 256, (2, 4)).astype(np.int32)),
                          cache, ctx)
        tokens = torch.from_numpy(rng.integers(0, 256, (2, 1)).astype(np.int32))
        logits, _ = model.decode_step(
            tree, tokens, {k2: {n: t.clone() for n, t in v.items()} for k2, v in cache.items()},
            ctx)
        first = int(logits[0, 0].argmax())
        drafts = torch.tensor([[1, 2, 3], [first, 5, 6]], dtype=torch.int32)
        probs = torch.full((2, k, 256), 1.0 / 256)
        probs[0, 1, 7] = float("nan")
        keys = torch.tensor([[0, 1], [0, 2]], dtype=torch.int64)
        emitted, accepted, margins, draft_fault, verify_fault = verify(
            tree, tokens, drafts, probs, cache, torch.tensor([4, 4], dtype=torch.int32), keys,
            torch.ones(2, dtype=torch.int32), torch.zeros(2), torch.tensor(0, dtype=torch.int32))
    assert draft_fault.tolist() == [True, False] and verify_fault.tolist() == [False, False]
    assert int(accepted[0]) == 0 and int(emitted[0, 0]) == first
    assert int(accepted[1]) >= 0 and margins.shape == (2, k + 1)
    assert cache_positions(cache).tolist() == [5, 4 + int(accepted[1]) + 1]


def test_greedy_variants_equal_the_sampled_ones_at_temperature_zero(olmo):
    """The all-greedy draft loop and verify (no threefry, no softmax) give,
    when no slot samples, the drafts, emitted tokens, acceptances, margins,
    fault flags and cache of the sampled variants, bit for bit."""
    from repro_torch.spec import make_draft_loop

    _, _, model, _, ctx, bank = olmo
    k, rng = 3, np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, 256, (2, 6)).astype(np.int32))
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 1)).astype(np.int32))
    keys = torch.tensor([[0, 7], [0, 8]], dtype=torch.int64)
    counts, temps = torch.tensor([1, 2], dtype=torch.int32), torch.zeros(2)
    out = {}
    for sampled in (False, True):
        with torch.no_grad():
            cache = model.make_cache(2, 24, device="cpu")
            model.decode_step(bank.tree("accurate"), prompt, cache, ctx)
            start = torch.full((2,), 6, dtype=torch.int32)
            drafts, probs = make_draft_loop(model, ctx, k, sampled=sampled)(
                bank.tree("approx"), tokens, cache, keys, counts, temps,
                torch.tensor(0, dtype=torch.int32))
            res = make_verify_step(model, ctx, k, sampled=sampled)(
                bank.tree("accurate"), tokens, drafts, probs, cache, start, keys, counts, temps,
                torch.tensor(0, dtype=torch.int32))
        out[sampled] = (drafts, *res, cache)
    for a, b in zip(out[False][:-1], out[True][:-1]):
        assert torch.equal(a, b)
    for key, seg in out[False][-1].items():
        for name, t in seg.items():
            assert torch.equal(t, out[True][-1][key][name])


def test_spec_config_validation(olmo):
    _, np_params, model, _, ctx, bank = olmo
    with pytest.raises(ValueError, match="draft_len"):
        SpecConfig(draft_len=0)
    with pytest.raises(ValueError, match="cheaper draft point"):
        SpecConfig(draft_point="accurate", verify_point="accurate")
    with pytest.raises(ValueError, match="unknown execution point"):
        SpeculativeDecoder(model, ctx, bank, SpecConfig(draft_point="fp4"))
    with pytest.raises(ValueError, match="unknown execution point"):
        SpeculativeDecoder(model, ctx, bank, SpecConfig(verify_point="fp4"))
    with pytest.raises(ValueError, match="cheaper draft point"):
        SpeculativeDecoder(model, ctx, bank, SpecConfig(draft_point="accurate"))
    with pytest.raises(ValueError, match="cheaper draft point"):
        SpeculativeDecoder(model, ctx, bank, SpecConfig(verify_point="approx"))
    with pytest.raises(ValueError, match="weight bank"):
        BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=1, max_len=32,
                      device="cpu", speculate=SpecConfig())
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=1, max_len=16,
                           device="cpu", speculate=SpecConfig(draft_len=4), bank=bank)
    with pytest.raises(ValueError, match="scratch headroom"):
        server.run([Request(0, np.arange(6, dtype=np.int32), 8)])
    with pytest.raises(KeyError):
        server.spec.round(np.zeros(1), server.cache, server._state, np.zeros(1), np.zeros(1),
                          draft_point="fp4")


def test_temp_dist_greedy_and_softmax():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.0, 0.0, 5.0]])
    greedy = _temp_dist(logits, torch.zeros(2))
    assert greedy.tolist() == [[0, 1, 0], [0, 0, 1]]
    soft = _temp_dist(logits, torch.full((2,), 2.0))
    want = np.asarray(jax.nn.softmax(jnp.asarray(logits.numpy()) / 2.0, axis=-1))
    np.testing.assert_allclose(soft.numpy(), want, rtol=1e-6)


def test_spec_telemetry_accounting():
    tele = SpecTelemetry({"approx": 60.0, "accurate": 100.0}, "accurate", draft_len=4)
    ref = jspec.SpecTelemetry({"approx": 60.0, "accurate": 100.0}, "accurate", draft_len=4)
    for t in (tele, ref):
        t.record_round("approx", "accurate", accepted=[4, 1], emitted=[5, 2])
    s = tele.summary()
    assert s == ref.summary() and tele.to_dict() == ref.to_dict()
    assert s["drafted"] == 8 and s["accepted"] == 5 and s["emitted"] == 7
    assert s["est_weight_pass_cycles"] == 2 * 340.0 and s["accurate_only_cycles"] == 700.0
    tele.reset()
    assert tele.summary()["rounds"] == 0


def test_cli_serves_speculative_on_cpu(capsys):
    import json

    from repro_torch.launch.serve import main

    out = main(["--arch", "olmo-1b", "--reduced", "--mode", "kernel", "--requests", "3",
                "--slots", "2",
                "--max-new", "6", "--device", "cpu", "--speculative", "--draft-len", "4"])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 6 for v in out.values())
    text = capsys.readouterr().out
    spec = json.loads(text.split("speculative: ", 1)[1].splitlines()[0])
    assert spec["draft_len"] == 4 and spec["rounds"] >= 1
    out = main(["--arch", "olmo-1b", "--reduced", "--mode", "kernel", "--requests", "2",
                "--slots", "2",
                "--max-new", "6", "--device", "cpu", "--speculative", "--adaptive"])
    assert all(len(v) == 6 for v in out.values())
    text = capsys.readouterr().out
    assert "telemetry: " in text and "speculative: " in text
