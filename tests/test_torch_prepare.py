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
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402


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
        assert got.is_contiguous() and got.dtype == unit.storage_dtype
        assert torch.equal(got, want)


def test_other_modes_are_not_yet_ported(trees):
    *_, model, params = trees
    for mode in ("exact", "carmen", "int8"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            prepare_params(params, None, mode)
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
