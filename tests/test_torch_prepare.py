"""PyTorch port: the reference's raw parameters load by path, and the port's
``prepare_params`` makes the reference's prepared banks.

The port stores the signed-digit weight integers where the reference stores
their f32 grid values: the integers must equal ``round(grid * 2**w_frac)``,
and the point vectors and the tied ``lm_head`` must match.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import FXP8 as J8, FXP16 as J16, PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.core.backends.base import PreparedWeight as JPW  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP8, FXP16, LayerPrecision, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import prepare_params  # noqa: E402
from repro_torch.core.backends.base import PreparedWeight  # noqa: E402
from repro_torch.core.backends.base import unit_fmt as fxp_unit  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def trees():
    ref_model = ref_get_model(ref_reduced(ref_get_config("olmo-1b")))
    raw = ref_model.init(jax.random.PRNGKey(3))
    model = get_model(reduced(get_config("olmo-1b")))
    return ref_model, raw, model, model.load_numpy(jax.tree.map(np.asarray, raw), "cpu")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_load_numpy_params_by_path(trees):
    _, raw, _, params = trees
    ref_leaves = {tuple(str(k.key) for k in p): np.asarray(v)
                  for p, v in jax.tree_util.tree_flatten_with_path(raw)[0]}
    port_leaves = dict(_flat(params))
    assert set(ref_leaves) == {p for p, v in port_leaves.items() if isinstance(v, torch.Tensor)}
    for path, arr in ref_leaves.items():
        np.testing.assert_array_equal(port_leaves[path].numpy(), arr)


def test_load_numpy_params_rejects_wrong_shapes(trees):
    _, raw, model, _ = trees
    bad = jax.tree.map(np.asarray, raw)
    bad["embed"] = bad["embed"][:, :5]
    with pytest.raises(ValueError, match="wrong shape"):
        load_numpy_params(bad, "cpu", specs=model.specs())


@pytest.mark.parametrize("policy", ["fxp8_accurate", "fxp16_approximate", "override"])
def test_prepare_matches_reference(trees, policy):
    ref_model, raw, model, params = trees
    if policy == "fxp8_accurate":
        jpol, tpol = JPolicy.accurate(J8), PrecisionPolicy.accurate(FXP8)
    elif policy == "fxp16_approximate":
        jpol, tpol = JPolicy.approximate(J16), PrecisionPolicy.approximate(FXP16)
    else:
        jpol = JPolicy.from_json(PrecisionPolicy(LayerPrecision(FXP8, 7),
                                                 {"mlp.down": LayerPrecision(FXP8, 4)}).to_json())
        tpol = PrecisionPolicy.from_json(jpol.to_json())
    ref = jax_prepare(raw, jpol, "kernel", specs=ref_model.specs())
    got = prepare_params(params, tpol, "kernel", specs=model.specs())
    port_flat = _assert_prepared_like_reference(ref, got)
    assert ("lm_head",) in port_flat
    # wq wk wv wo up gate down + the tied lm_head
    assert sum(isinstance(v, PreparedWeight) for v in port_flat.values()) == 8
    embed = port_flat[("embed",)]
    assert embed.dtype == torch.float32  # the lookup table stays float


def _assert_prepared_like_reference(ref, got):
    """Same paths; prepared leaves hold round(grid * 2**w_frac) and the same
    point; the rest equal. Returns the port's flat tree."""
    ref_flat = {tuple(str(k.key) for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda x: isinstance(x, JPW))[0]}
    port_flat = dict(_flat(got))
    assert set(ref_flat) == set(port_flat)
    for path, leaf in ref_flat.items():
        mine = port_flat[path]
        if not isinstance(leaf, JPW):
            assert not isinstance(mine, PreparedWeight), path
            np.testing.assert_array_equal(mine.numpy(), np.asarray(leaf))
            continue
        assert isinstance(mine, PreparedWeight) and mine.backend == "kernel"
        point = np.asarray(leaf.point)
        np.testing.assert_array_equal(mine.point.numpy(), point)
        w_frac = point.reshape(-1, 5)[0, 4]
        assert mine.data.dtype == (torch.int8 if w_frac == 6 else torch.int16)
        np.testing.assert_array_equal(mine.data.numpy().astype(np.float64),
                                      np.round(np.asarray(leaf.data, np.float64) * 2.0**w_frac))
    return port_flat


def test_prepare_deepseek_matches_reference():
    """MLA and MoE trees: the engine's projections are prepared (shared expert
    included); the routed experts, router, wk_b/wv_b and norms stay float."""
    ref_model = ref_get_model(ref_reduced(ref_get_config("deepseek-v3-671b"), layers=4))
    raw = ref_model.init(jax.random.PRNGKey(5))
    model = get_model(reduced(get_config("deepseek-v3-671b"), layers=4))
    params = model.load_numpy(jax.tree.map(np.asarray, raw), "cpu")
    ref = jax_prepare(raw, JPolicy.accurate(J8), "kernel", specs=ref_model.specs())
    got = prepare_params(params, PrecisionPolicy.accurate(FXP8), "kernel", specs=model.specs())
    port_flat = _assert_prepared_like_reference(ref, got)
    prepared = {p for p, v in port_flat.items() if isinstance(v, PreparedWeight)}
    assert ("seg1_moe", "moe", "shared", "gate") in prepared
    assert ("seg0_dense_prefix", "attn", "wkv_a") in prepared
    for raw_path in [("seg1_moe", "moe", "up"), ("seg1_moe", "moe", "router"),
                     ("seg1_moe", "attn", "wk_b"), ("seg0_dense_prefix", "attn", "wv_b")]:
        assert raw_path not in prepared
    assert port_flat[("seg1_moe", "attn", "wo")].point.shape == (3, 5)


def test_chunked_weight_rounding_equals_whole(monkeypatch):
    from repro_torch.core import cordic, fxp
    from repro_torch.core.backends import kernel

    monkeypatch.setattr(kernel, "_PREPARE_CHUNK", 37)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 50, 41)).astype(
        np.float32)).transpose(1, 2)  # not contiguous
    for unit in (fxp.FXP8_UNIT, fxp.FXP16_UNIT):
        got = kernel._signed_digit_storage(w, 6, unit)
        want = cordic.signed_digit_ints(w, 6, unit).to(unit.storage_dtype)
        # K = 3 contracted, stored K-major with its stride padded to 16 bytes
        k_pad = 16 // unit.storage_dtype.itemsize
        assert got.stride() == (1, 50 * k_pad, k_pad) and got.dtype == unit.storage_dtype
        assert torch.equal(got, want)


def test_other_modes_are_not_yet_ported(trees):
    """Every mode is ported now: ``exact`` serves the tree as it is, carmen
    and int8 prepare every engine-routed leaf (tests/test_torch_backends.py
    holds their values against the reference); an unknown mode raises."""
    *_, model, params = trees
    assert prepare_params(params, None, "exact") is params
    for mode in ("carmen", "int8"):
        prepared = prepare_params(params, None, mode, specs=model.specs())
        assert prepared["lm_head"].backend == mode
    with pytest.raises(ValueError, match="unknown engine mode"):
        prepare_params(params, None, "bogus")


def test_policy_json_round_trip_across_packages(tmp_path):
    pol = PrecisionPolicy(LayerPrecision(FXP16, 13), {"lm_head": LayerPrecision(FXP8, 5)})
    path = str(tmp_path / "policy.json")
    pol.save(path)
    jpol = JPolicy.load(path)
    assert jpol.for_layer("layer.mlp.up").depth == 13
    assert jpol.for_layer("lm_head").fmt.bits == 8
    assert PrecisionPolicy.from_json(jpol.to_json()) == pol
    assert dataclasses.asdict(pol.default) == {"fmt": {"bits": 16, "frac": 12}, "depth": 13}


def _port_model(arch):
    cfg = reduced(get_config(arch), layers=4) if arch == "deepseek-v3-671b" else \
        reduced(get_config(arch))
    model = get_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(11))


def _k_pad(k, dtype):
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-k // per) * per


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b"])
@pytest.mark.parametrize("fmt", [FXP8, FXP16])
def test_prepared_banks_are_k_major(arch, fmt):
    """Every prepared leaf (stacked layers, ``wo``, the tied ``lm_head``) keeps
    its logical shape and values and is stored K-major: viewed as ``(..., K,
    N)`` it has strides ``(1, K_pad)``, and each layer's view too."""
    from repro_torch.core import cordic
    from repro_torch.core.backends import iter_dot_weights

    _, model, params = _port_model(arch)
    policy = PrecisionPolicy.accurate(fmt)
    got = prepare_params(params, policy, "kernel", specs=model.specs())
    port_flat = dict(_flat(got))
    seen = 0
    for keys, name, raw, stacked, in_axes in iter_dot_weights(params, specs=model.specs()):
        bank = port_flat[keys]
        lp = policy.for_layer(name)
        unit = fxp_unit(lp.fmt)
        assert bank.shape == tuple(raw.shape)
        assert torch.equal(bank.data, cordic.signed_digit_ints(raw, lp.depth, unit).to(
            unit.storage_dtype))
        shape = tuple(raw.shape)
        k = int(np.prod(shape[stacked:stacked + in_axes]))
        n = int(np.prod(shape[stacked + in_axes:]))
        k_pad = _k_pad(k, bank.dtype)
        mat = bank.data.reshape(*shape[:stacked], k, n)
        assert mat.data_ptr() == bank.data.data_ptr() and mat.stride()[-2:] == (1, k_pad)
        if stacked:
            last = shape[0] - 1
            layer = bank.layer(last).data.reshape(k, n)
            assert layer.stride() == (1, k_pad)
            assert layer.data_ptr() == bank.data[last].data_ptr()
        seen += 1
    lm_head = port_flat[("lm_head",)].data
    d = params["embed"].shape[1]
    assert lm_head.shape == (d, params["embed"].shape[0]) and lm_head.stride() == (1, d)
    assert seen >= 7


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b"])
def test_model_reshapes_of_banks_are_views(arch, monkeypatch):
    """The models' 2-D reshapes (``_proj``'s ``w.reshape(d, -1)``, ``wo``'s
    ``(H*hd, d)``, MLA's ``wq_b`` and ``wo``) and ``PreparedWeight.layer``
    hand the fused kernel views of the prepared banks with strides
    ``(1, K_pad)``: no copy."""
    import repro_torch.kernels.cordic_fused as fused_pkg

    cfg, model, params = _port_model(arch)
    got = prepare_params(params, PrecisionPolicy.accurate(FXP8), "kernel", specs=model.specs())
    storages = {v.data.untyped_storage().data_ptr() for v in dict(_flat(got)).values()
                if isinstance(v, PreparedWeight)}
    seen, original = [], fused_pkg.fused_dot_af

    def recording(x, w, point, **kw):
        seen.append(w)
        return original(x, w, point, **kw)

    monkeypatch.setattr(fused_pkg, "fused_dot_af", recording)
    from repro_torch.core import EngineContext

    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(FXP8),
                        compute_dtype=torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 5)))
    with torch.no_grad():
        model.forward(got, {"tokens": tokens}, ctx)
    assert len(seen) >= 7 * cfg.num_layers // 2
    for w in seen:
        assert w.ndim == 2 and w.stride() == (1, _k_pad(w.shape[0], w.dtype)), w.stride()
        assert w.untyped_storage().data_ptr() in storages


@pytest.mark.parametrize("fmt", [FXP8, FXP16])
def test_k_not_a_multiple_of_16_bytes_gets_a_padded_stride(fmt):
    """K = 300 (int8 and int16: padded to 304), a stacked K = 1000 (int8:
    to 1008; int16 rows are whole 16 bytes already) and a ``wo``-like K =
    3 * 7 = 21 (to 32 / 24): the logical view keeps the values, the storage
    pads each column."""
    from repro_torch.core import cordic
    from repro_torch.core.backends import get_backend

    lp = PrecisionPolicy.accurate(fmt).default
    unit = fxp_unit(fmt)
    rng = np.random.default_rng(5)
    int8 = unit.storage_dtype == torch.int8
    cases = [((300, 24), 0, 1, 300, 304), ((2, 1000, 3, 5), 1, 1, 1000, 1008 if int8 else 1000),
             ((2, 3, 7, 40), 1, 2, 21, 32 if int8 else 24)]
    for shape, stacked, in_axes, k, want_pad in cases:
        w = torch.from_numpy(rng.uniform(-1.5, 1.5, shape).astype(np.float32))
        bank = get_backend("kernel").prepare(w, lp, stacked_axes=stacked, in_axes=in_axes)
        assert bank.shape == shape
        mat = bank.data.reshape(*shape[:stacked], k, -1)
        assert mat.stride()[-2:] == (1, want_pad) and mat.data_ptr() == bank.data.data_ptr()
        assert torch.equal(bank.data, cordic.signed_digit_ints(w, lp.depth, unit).to(
            unit.storage_dtype))
