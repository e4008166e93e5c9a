"""PyTorch port: the startup calibration scan and the policy tools against the
reference, on the CPU.

* ``iter_dot_weights`` yields the reference's leaves and names on raw and
  prepared trees (reduced olmo-1b and deepseek-v3);
* ``assign_depths`` and ``pin_critical`` give the reference's policies;
* ``calibration_scan`` on reduced olmo-1b, kernel mode per call, gives the
  reference's sensitivities within rtol 1e-3 (each is a ratio of logit
  norms, and the logits agree to f32 reduction order), and the same policy
  under ``attn_impl`` ``"xla"`` and ``"flash"``;
* a policy file saved by either package loads in the other;
* the serving CLI's ``--calibrate --save-policy`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config, reduced as ref_reduced  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core import assign_depths as jax_assign_depths  # noqa: E402
from repro.core import pin_critical as jax_pin_critical  # noqa: E402
from repro.core.backends import iter_dot_weights as jax_iter_dot_weights  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.runtime import calibration_scan as jax_calibration_scan  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import CRITICAL_KEYWORDS, FXP8, FXP16, LayerPrecision  # noqa: E402
from repro_torch.core import PrecisionPolicy, assign_depths, pin_critical  # noqa: E402
from repro_torch.core.backends import iter_dot_weights, prepare_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import calibration_scan  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

SENS_RTOL = 1e-3
CAL_TOKENS = (2, 8)


def numpy_params(tree, seed=0):
    """Layer matrices N(0, 0.1^2), the embedding N(0, 0.02^2), from numpy."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        scale = 0.02 if path[0].key == "embed" else 0.1
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, tree)


def _models(name):
    ref_model = ref_get_model(ref_reduced(ref_get_config(name)))
    np_params = numpy_params(jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    return ref_model, np_params, get_model(reduced(get_config(name)))


def _entries(it):
    return sorted((tuple(keys), name, stacked, in_axes) for keys, name, _, stacked, in_axes in it)


@pytest.mark.parametrize("name", ["olmo-1b", "deepseek-v3-671b"])
def test_iter_dot_weights_matches_reference(name):
    ref_model, np_params, model = _models(name)
    jraw = jax.tree.map(jnp.asarray, np_params)
    raw = model.load_numpy(np_params, "cpu")
    want = _entries(jax_iter_dot_weights(jraw, specs=ref_model.specs()))
    assert _entries(iter_dot_weights(raw, specs=model.specs())) == want
    # a tied raw tree (olmo) has no lm_head leaf
    assert want and any(n == "lm_head" for _, n, _, _ in want) != model.cfg.tie_embeddings
    jprep = jax_prepare(jraw, JPolicy.accurate(), "kernel", specs=ref_model.specs())
    prep = prepare_params(raw, PrecisionPolicy.accurate(), "kernel", specs=model.specs())
    want = _entries(jax_iter_dot_weights(jprep, specs=ref_model.specs()))
    assert _entries(iter_dot_weights(prep, specs=model.specs())) == want
    assert any(n == "lm_head" for _, n, _, _ in want)  # the materialized head


@pytest.mark.parametrize("target", [0.0, 0.1, 0.33, 1.0])
@pytest.mark.parametrize("fmt", [FXP8, FXP16], ids=["fxp8", "fxp16"])
def test_assign_depths_and_pin_critical_match_reference(fmt, target):
    rng = np.random.default_rng(int(target * 100) + fmt.bits)
    names = ["layer.attn.q", "layer.attn.k", "layer.attn.v", "layer.attn.o", "layer.mlp.up",
             "layer.mlp.gate", "layer.mlp.down", "lm_head", "layer.moe.router",
             "final_norm", "embed"]
    sens = {n: float(s) for n, s in zip(names, rng.random(len(names)))}
    got = assign_depths(sens, fmt=fmt, cycle_reduction_target=target)
    want = jax_assign_depths(sens, fmt=fmt, cycle_reduction_target=target)
    assert got.to_json() == want.to_json()
    assert not any(k in n for n in got.overrides for k in CRITICAL_KEYWORDS)
    pinned = pin_critical(got)
    assert pinned.to_json() == jax_pin_critical(want).to_json()
    assert list(pinned.overrides) == list(jax_pin_critical(want).overrides)  # the floors first
    # a demoted override whose name holds a keyword is raised to full depth
    loose = PrecisionPolicy(got.default, {"router_tail": LayerPrecision(fmt, 1)})
    jloose = JPolicy.from_json(loose.to_json())
    assert pin_critical(loose).to_json() == jax_pin_critical(jloose).to_json()


@pytest.fixture(scope="module")
def olmo_scan():
    ref_model, np_params, model = _models("olmo-1b")
    tokens = np.random.default_rng(5).integers(0, 256, CAL_TOKENS).astype(np.int32)
    want = jax_calibration_scan(ref_model, jax.tree.map(jnp.asarray, np_params), tokens,
                                fmt=FXP8, mode="kernel")
    return np_params, model, tokens, want


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_calibration_scan_matches_reference(olmo_scan, impl):
    np_params, model, tokens, want = olmo_scan
    got = calibration_scan(model, model.load_numpy(np_params, "cpu"), torch.from_numpy(tokens),
                           fmt=FXP8, mode="kernel", attn_impl=impl)
    assert sorted(got) == sorted(want) and len(got) == 8
    assert "lm_head" in got  # the tied head, added by name
    for name, s in want.items():
        assert got[name] == pytest.approx(s, rel=SENS_RTOL), name
    policy = assign_depths(got, fmt=FXP8, cycle_reduction_target=0.33)
    assert policy.to_json() == jax_assign_depths(want, fmt=FXP8).to_json()
    assert policy.overrides  # something was demoted


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_policy_file_loads_in_the_other_package(tmp_path, writer):
    sens = {"layer.attn.q": 0.2, "layer.mlp.up": 0.1, "lm_head": 3.0, "layer.mlp.down": 0.5}
    path = str(tmp_path / "policy.json")
    if writer == "port":
        assign_depths(sens, fmt=FXP16).save(path)
        got, want = JPolicy.load(path), jax_assign_depths(sens, fmt=FXP16)
    else:
        jax_assign_depths(sens, fmt=FXP16).save(path)
        got, want = PrecisionPolicy.load(path), assign_depths(sens, fmt=FXP16)
    assert got.to_json() == want.to_json()
    assert got.for_layer("layer.mlp.up").depth < got.default.depth


def test_serve_cli_calibrates_saves_and_serves(tmp_path, capsys):
    path = tmp_path / "p.json"
    results = serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mode", "kernel",
                          "--calibrate", "--save-policy", str(path), "--requests", "2",
                          "--max-new", "3"])
    out = capsys.readouterr().out
    assert "calibration scan:" in out and f"policy saved to {path}" in out
    policy = JPolicy.load(str(path))
    assert policy.overrides and all(lp.depth < policy.default.depth
                                    for lp in policy.overrides.values())
    assert sorted(results) == [0, 1] and all(len(t) == 3 for t in results.values())
    # the saved policy serves the same streams through --policy-file
    again = serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mode", "kernel",
                        "--policy-file", str(path), "--requests", "2", "--max-new", "3"])
    assert again == results
