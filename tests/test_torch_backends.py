"""PyTorch port: the ``exact``, ``carmen`` and ``int8`` engine modes
(``repro_torch.core.backends``) against the reference, on the CPU.

The fixed-point paths are held bitwise: the masked signed-digit rounder,
activation fake-quantization (non-finite inputs pass through), int8 weight
quantization (``eff_bits < 8`` included) and the int32 dot, which in the
port is the MAC-array kernel's plain version. The f32 products of grid
values agree to 1e-5 (reduction order). Prepared and per-call serving are
the same arithmetic and agree bitwise, mode by mode, at depths 4, 6 and full
at FxP8 and FxP16; served greedy streams equal the reference's per mode on
reduced olmo-1b (2 layers, d_model 128, the numpy weights of
test_torch_serving). Also ``sensitivity_scan`` on the reference's toy model,
``EngineContext.activate`` per mode, the int8 bank layout, weight poisoning
and the CLI's ``--mode`` / ``--fxp16`` and its refusals.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core import fxp as jfxp  # noqa: E402
from repro.core.backends import carmen as jcarmen, int8 as jint8  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.core.precision_policy import sensitivity_scan as jax_sensitivity_scan  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy, full_depth  # noqa: E402
from repro_torch.core import fxp, sensitivity_scan  # noqa: E402
from repro_torch.core.backends import PreparedWeight, carmen, int8, prepare_params  # noqa: E402
from repro_torch.kernels.int_dot import is_k_major  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.resilience.inject import poison_tree  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_serving import LOGIT_TOL, _numpy_params, _prompts  # noqa: E402

MODES = ("exact", "carmen", "int8")
FMTS = {"fxp8": (FXP8, jfxp.FXP8), "fxp16": (FXP16, jfxp.FXP16)}
UNITS = {"fxp8": (fxp.FXP8_UNIT, jfxp.FXP8_UNIT), "fxp16": (fxp.FXP16_UNIT, jfxp.FXP16_UNIT)}
MAX_NEW = 8


def _policy(mode, fmt, depth=None):
    if mode == "exact":
        return None
    return PrecisionPolicy.uniform(fmt, depth or full_depth(fmt))


def _jpolicy(policy):
    return None if policy is None else JPolicy.from_json(policy.to_json())


@pytest.fixture(scope="module")
def setup():
    ref_model = ref_get_model(ref_reduced(ref_get_config("olmo-1b")))
    np_params = _numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    model = get_model(reduced(get_config("olmo-1b")))
    return ref_model, np_params, model


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the fixed-point paths, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fxp8", "fxp16"])
@pytest.mark.parametrize("depth", [0, 1, 4, 6, "full"])
def test_sd_round_traced_bitwise(name, depth):
    unit, junit = UNITS[name]
    depth = full_depth(unit) if depth == "full" else depth
    w = _rand((64, 48), seed=depth, scale=0.7)
    want = np.asarray(jcarmen.sd_round_traced(jnp.asarray(w), depth, junit))
    got = carmen.sd_round_traced(torch.from_numpy(w), depth, unit)
    np.testing.assert_array_equal(got.numpy(), want)
    # a run-time depth (a tensor) and the static rounder give the same bits
    as_tensor = carmen.sd_round_traced(torch.from_numpy(w), torch.tensor(depth), unit)
    assert torch.equal(as_tensor, got)
    from repro_torch.core import cordic

    assert torch.equal(cordic.signed_digit_round(torch.from_numpy(w), depth, unit), got)


@pytest.mark.parametrize("name", ["fxp8", "fxp16"])
def test_quantize_activations_bitwise_and_identity_on_nonfinite(name):
    fmt, jfmt = FMTS[name]
    x = _rand((5, 64), seed=2, scale=3.0)
    x[0, 0], x[1, 1], x[2, 2], x[3, 3] = np.nan, np.inf, -np.inf, 1e20
    want = np.asarray(jcarmen.quantize_activations(jnp.asarray(x), jfmt))
    got = carmen.quantize_activations(torch.from_numpy(x), fmt).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 0]) and got[1, 1] == np.inf and got[2, 2] == -np.inf
    assert got[3, 3] == fmt.max_value  # a finite value saturates


@pytest.mark.parametrize("eff_bits", [2, 5, 8])
@pytest.mark.parametrize("stacked,in_axes", [(0, None), (1, 1), (1, 2)],
                         ids=["flat", "stacked", "wo"])
def test_quantize_weight_bitwise(eff_bits, stacked, in_axes):
    w = _rand((3, 64, 4, 12), seed=eff_bits)
    w = w if stacked else w[0]
    want_q, want_s = jint8.quantize_weight(jnp.asarray(w), stacked_axes=stacked,
                                           eff_bits=eff_bits, in_axes=in_axes)
    got_q, got_s = int8.quantize_weight(torch.from_numpy(w), stacked_axes=stacked,
                                        eff_bits=eff_bits, in_axes=in_axes)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("eff_bits", [3, 8])
@pytest.mark.parametrize("prepared", [False, True], ids=["per_call", "prepared"])
def test_int8_dot_bitwise(eff_bits, prepared):
    x, w = _rand((7, 64), seed=5, scale=2.0), _rand((64, 40), seed=6, scale=0.3)
    x[6, 3] = np.nan  # a poisoned row stays NaN on both sides
    if prepared:
        jq, js = jint8.quantize_weight(jnp.asarray(w), eff_bits=eff_bits)
        want = jint8.int8_dot(jnp.asarray(x), jq, w_scale=js)
        tq, ts = int8.quantize_weight(torch.from_numpy(w), eff_bits=eff_bits)
        got = int8.int8_dot(torch.from_numpy(x), tq, w_scale=ts)
    else:
        want = jint8.int8_dot(jnp.asarray(x), jnp.asarray(w), effective_bits=eff_bits)
        got = int8.int8_dot(torch.from_numpy(x), torch.from_numpy(w), effective_bits=eff_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()[6]).all() and np.isfinite(got.numpy()[:6]).all()


@pytest.mark.parametrize("depth", [3, 6])
def test_carmen_float_product_within_1e5(depth):
    x, w = _rand((2, 5, 96), seed=7, scale=1.5), _rand((96, 80), seed=8, scale=0.4)
    want = np.asarray(jcarmen.carmen_dot(jnp.asarray(x), jnp.asarray(w), depth))
    got = carmen.carmen_dot(torch.from_numpy(x), torch.from_numpy(w), depth).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_effective_bits_matches_reference():
    from repro.core.precision_policy import LayerPrecision as JLP
    from repro_torch.core import LayerPrecision

    for name in FMTS:
        fmt, jfmt = FMTS[name]
        for depth in range(0, full_depth(fmt) + 1):
            assert int8.effective_bits(LayerPrecision(fmt, depth)) == jint8.effective_bits(
                JLP(jfmt, depth))


# ---------------------------------------------------------------------------
# prepared banks
# ---------------------------------------------------------------------------


def test_int8_banks_are_k_major_with_their_scales(setup):
    _, np_params, model = setup
    params = model.load_numpy(np_params, "cpu")
    tree = prepare_params(params, PrecisionPolicy.accurate(), "int8", specs=model.specs())
    wq = tree["seg0_dense"]["attn"]["wq"]
    layers, d, heads, hd = wq.shape
    assert wq.scale.shape == (layers, 1, heads, hd) and wq.get("effective_bits") == 8
    view = wq.layer(1).reshape(d, -1)
    assert is_k_major(view.data) and view.scale.shape == (1, heads * hd)
    wo = tree["seg0_dense"]["attn"]["wo"].layer(0).reshape(heads * hd, d)
    assert is_k_major(wo.data) and wo.scale.shape == (1, d)
    head = tree["lm_head"]
    assert is_k_major(head.data) and head.scale.shape == (1, head.shape[1])


@pytest.mark.parametrize("mode", ["carmen", "int8"])
def test_prepared_banks_match_reference(setup, mode):
    """Each prepared leaf holds the reference's values: carmen's f32 grid
    and its x_fmt, int8's qvalues and scales."""
    ref_model, np_params, model = setup
    policy = PrecisionPolicy(PrecisionPolicy.accurate().default,
                             {"layer.mlp": PrecisionPolicy.approximate().default})
    want = jax_prepare(jax.tree.map(jnp.asarray, np_params), _jpolicy(policy), mode,
                       specs=ref_model.specs())
    got = prepare_params(model.load_numpy(np_params, "cpu"), policy, mode, specs=model.specs())
    for path in (("seg0_dense", "attn", "wq"), ("seg0_dense", "mlp", "up"), ("lm_head",)):
        w, jw = got, want
        for k in path:
            w, jw = w[k], jw[k]
        np.testing.assert_array_equal(w.data.numpy(), np.asarray(jw.data))
        if mode == "int8":
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jw.scale))
        assert w.meta == jw.meta


@pytest.mark.parametrize("mode", ["carmen", "int8"])
def test_poison_tree_poisons_carmen_and_int8_banks(setup, mode):
    _, np_params, model = setup
    tree = prepare_params(model.load_numpy(np_params, "cpu"), None, mode, specs=model.specs())
    bad = poison_tree(tree, "['mlp']")
    w, clean = bad["seg0_dense"]["mlp"]["up"], tree["seg0_dense"]["mlp"]["up"]
    if mode == "carmen":
        assert torch.isnan(w.data).all()
    else:
        assert not w.data.any() and w.data.stride() == clean.data.stride()
        assert torch.isnan(w.scale).all()
    assert bad["seg0_dense"]["attn"]["wq"] is tree["seg0_dense"]["attn"]["wq"]
    assert not torch.isnan(clean.data.to(torch.float32)).any()


# ---------------------------------------------------------------------------
# the model: prepared = per call, and against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fxp8", "fxp16"])
@pytest.mark.parametrize("depth", [4, 6, "full"])
@pytest.mark.parametrize("mode", MODES)
def test_prepared_decode_bitwise_equal_to_per_call(setup, mode, depth, name):
    _, np_params, model = setup
    fmt = FMTS[name][0]
    policy = _policy(mode, fmt, full_depth(fmt) if depth == "full" else depth)
    ctx = EngineContext(mode=mode, policy=policy, compute_dtype=torch.float32,
                        attn_impl="decode_kernel")
    raw = model.load_numpy(np_params, "cpu")
    trees = {"per_call": raw, "prepared": prepare_params(raw, policy, mode, specs=model.specs())}
    rng = np.random.default_rng(3)
    steps = [torch.from_numpy(rng.integers(0, 256, (2, s)).astype(np.int32)) for s in (5, 1, 1)]
    logits = {}
    for label, params in trees.items():
        cache = model.make_cache(2, 16, device="cpu")
        with torch.no_grad():
            logits[label] = [model.decode_step(params, t, cache, ctx)[0] for t in steps]
    for got, want in zip(logits["per_call"], logits["prepared"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_decode_step_logits_match_reference(setup, mode):
    ref_model, np_params, model = setup
    policy = _policy(mode, FXP8)
    jctx = JCtx(mode=mode, policy=_jpolicy(policy), compute_dtype=jnp.float32)
    ctx = EngineContext(mode=mode, policy=policy, compute_dtype=torch.float32,
                        attn_impl="decode_kernel")
    tokens = np.random.default_rng(4).integers(0, 256, (2, 6)).astype(np.int32)
    jparams = jax_prepare(jax.tree.map(jnp.asarray, np_params), jctx.policy, mode,
                          specs=ref_model.specs())
    want, _ = ref_model.decode_step(jparams, jnp.asarray(tokens),
                                    ref_model.make_cache(2, 16, dtype=jnp.float32), jctx)
    params = prepare_params(model.load_numpy(np_params, "cpu"), policy, mode,
                            specs=model.specs())
    with torch.no_grad():
        got, _ = model.decode_step(params, torch.from_numpy(tokens),
                                   model.make_cache(2, 16, device="cpu"), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


@pytest.fixture(scope="module")
def ref_streams(setup):
    ref_model, np_params, _ = setup
    out = {}
    for mode in MODES:
        jctx = JCtx(mode=mode, policy=_jpolicy(_policy(mode, FXP8)), compute_dtype=jnp.float32)
        server = JServer(ref_model, jctx, jax.tree.map(jnp.asarray, np_params), slots=2,
                         max_len=32, burst=8)
        out[mode] = server.run([JRequest(i, p, MAX_NEW) for i, p in enumerate(_prompts())])
    return out


@pytest.mark.parametrize("prepared", [True, False], ids=["prepared", "per_call"])
@pytest.mark.parametrize("mode", MODES)
def test_served_greedy_streams_identical_to_reference(setup, ref_streams, mode, prepared):
    _, np_params, model = setup
    ctx = EngineContext(mode=mode, policy=_policy(mode, FXP8), compute_dtype=torch.float32,
                        attn_impl="decode_kernel")
    server = BatchedServer(model, ctx, model.load_numpy(np_params, "cpu"), slots=2, max_len=32,
                           burst=8, device="cpu", prepare_weights=prepared)
    got = server.run([Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())])
    assert got == ref_streams[mode]
    assert any(len(set(v)) > 2 for v in got.values())  # not a repeated-token stream


def test_modes_serve_different_streams(ref_streams):
    """Non-vacuous: the three modes' arithmetic really differs on these
    weights."""
    assert len({str(sorted(s.items())) for s in ref_streams.values()}) == len(MODES)


@pytest.mark.parametrize("mode", MODES)
def test_engine_activate_matches_reference(mode):
    x = _rand((3, 5, 64), seed=9, scale=2.0)
    for fmt, jfmt in FMTS.values():
        policy = _policy(mode, fmt)
        jctx = JCtx(mode=mode, policy=_jpolicy(policy), compute_dtype=jnp.float32)
        ctx = EngineContext(mode=mode, policy=policy, compute_dtype=torch.float32)
        for af in ("gelu", "swish", "softmax"):
            want = np.asarray(jctx.activate(jnp.asarray(x), af))
            got = ctx.activate(torch.from_numpy(x), af).numpy()
            if mode == "exact":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# sensitivity_scan
# ---------------------------------------------------------------------------


def _toy_apply_jax(params, batch, noise):
    """The reference test's two-layer MLP with noise taps after each layer."""
    h = batch @ params["w1"]
    h = h + noise.get("l1", 0.0) * jnp.ones_like(h)
    out = jnp.tanh(h) @ params["w2"]
    return out + noise.get("l2", 0.0) * jnp.ones_like(out)


def _toy_apply_torch(params, batch, noise):
    h = batch @ params["w1"]
    h = h + noise.get("l1", 0.0) * torch.ones_like(h)
    out = torch.tanh(h) @ params["w2"]
    return out + noise.get("l2", 0.0) * torch.ones_like(out)


@pytest.mark.parametrize("name", ["fxp8", "fxp16"])
def test_sensitivity_scan_matches_reference(name):
    fmt, jfmt = FMTS[name]
    params = {"w1": _rand((8, 16), seed=1, scale=0.1), "w2": _rand((16, 4), seed=2, scale=10.0)}
    batch = _rand((32, 8), seed=3)
    want = jax_sensitivity_scan(_toy_apply_jax, params, batch, ["l1", "l2"], fmt=jfmt)
    got = sensitivity_scan(_toy_apply_torch, {k: torch.from_numpy(v) for k, v in params.items()},
                           torch.from_numpy(batch), ["l1", "l2"], fmt=fmt)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k]))
    assert got["l1"] > got["l2"] > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "olmo-1b", "--reduced", "--requests", "3", "--slots", "2", "--max-new", "4",
       "--burst", "2", "--device", "cpu"]


@pytest.mark.parametrize("mode", MODES)
def test_cli_serves_each_mode(capsys, mode):
    from repro_torch.launch.serve import main

    out = main(CLI + ["--mode", mode])
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert f"prepared {mode} weights" in capsys.readouterr().out
    if mode != "exact":
        assert main(CLI + ["--mode", mode, "--per-call"]) == out


def test_cli_defaults_to_exact_and_takes_fxp16(capsys):
    from repro_torch.launch.serve import main

    assert main(CLI) == main(CLI + ["--mode", "exact"])
    assert "prepared exact weights" in capsys.readouterr().out
    main(CLI + ["--mode", "carmen", "--fxp16", "--adaptive"])
    text = capsys.readouterr().out
    # the FxP16 ladder: the hifi point is the accurate one's format, so it drops
    assert "points=('approx', 'accurate')" in text and "telemetry: " in text
    main(CLI + ["--mode", "int8", "--adaptive"])
    # int8 caps at 8 effective bits: no hifi point
    assert "points=('approx', 'accurate')" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--mode", "exact", "--adaptive"], "needs --mode carmen|int8|kernel"),
    (["--mode", "exact", "--speculative"], "needs --mode carmen|int8|kernel"),
    (["--mode", "carmen", "--adaptive", "--per-call"], "--per-call contradicts"),
    (["--mode", "int8", "--speculative", "--per-call"], "--per-call contradicts"),
    (["--mode", "carmen", "--degrade"], "--degrade needs a multi-point bank"),
], ids=["exact_adaptive", "exact_speculative", "carmen_per_call", "int8_per_call", "degrade"])
def test_cli_refusals(flags, match):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match=match):
        main(CLI + flags)


def test_prepared_weight_reshape_carries_the_scale():
    data = torch.arange(24, dtype=torch.int8).reshape(2, 3, 4)
    scale = torch.rand((1, 3, 4))
    w = PreparedWeight(data, "int8", scale=scale)
    flat = w.reshape(2, 12)
    assert torch.equal(flat.scale, scale.reshape(1, 12))
    back = PreparedWeight(data.reshape(6, 4), "int8", scale=torch.rand((1, 4))).reshape(2, 3, 4)
    assert back.scale.shape == (1, 1, 4)
    with pytest.raises(ValueError, match="cannot reshape"):
        w.reshape(4, 6)
